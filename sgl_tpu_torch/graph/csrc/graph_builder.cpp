// Native host-side graph builder of sgl_tpu_torch.
//
// What stays on the host when a graph is built: sorting its edges by
// destination, summing degrees and producing normalized edge weights,
// gathering rows of a host array, and sorting edges into the cells of the
// 2-D out-of-core layout.  numpy's sorts are single-threaded; this
// library does an OpenMP-parallel counting sort keyed on dst plus parallel
// degree and normalization passes.  Built with g++ at first use and loaded
// with ctypes by sgl_tpu_torch/graph/native.py, which keeps a numpy
// fallback for every entry point.
//
// C ABI (all arrays caller-allocated):
//   sgl_sort_edges_by_dst(src, dst, val, n_edges, num_nodes,
//                         out_src, out_dst, out_val)
//   sgl_compute_degrees(src, val, n_edges, num_nodes, out_deg)   // += val
//   sgl_gather_rows(x, row_bytes, idx, n_idx, out)               // out[i] = x[idx[i]]
//   sgl_normalized_weights(src, dst, val, n_edges, deg, r, out_w)
//       // w_e = deg[dst_e]^(r-1) * val_e * deg[src_e]^(-r), 0 where deg==0
//   sgl_classify_sort_cells_2d(src, dst, w, n, sb, k, part_of_row,
//                              n_keys, o_src, o_dst, o_w, o_cell_counts)
//       // stable counting sort by cell key part_of_row[dst]*k + src/sb

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

extern "C" {

// Parallel stable counting sort of edges by dst.
// Two passes: per-thread histograms over dst, exclusive prefix to get
// per-(thread, bucket) offsets, then a scatter pass.  Stability within a
// dst bucket follows thread-then-index order, which preserves input order
// (the static schedule gives each thread one contiguous, ordered range).
void sgl_sort_edges_by_dst(const int32_t* src, const int32_t* dst,
                           const float* val, int64_t n_edges,
                           int32_t num_nodes, int32_t* out_src,
                           int32_t* out_dst, float* out_val) {
  const int n_threads = omp_get_max_threads();
  const int64_t nb = static_cast<int64_t>(num_nodes);
  std::vector<int64_t> hist(static_cast<size_t>(n_threads) * nb, 0);

#pragma omp parallel
  {
    const int t = omp_get_thread_num();
    int64_t* h = hist.data() + static_cast<int64_t>(t) * nb;
#pragma omp for schedule(static)
    for (int64_t e = 0; e < n_edges; ++e) {
      ++h[dst[e]];
    }
  }

  // exclusive prefix sum over (bucket-major, thread-minor) so that bucket b,
  // thread t starts at offsets[t * nb + b]
  int64_t running = 0;
  for (int64_t b = 0; b < nb; ++b) {
    for (int t = 0; t < n_threads; ++t) {
      int64_t& h = hist[static_cast<int64_t>(t) * nb + b];
      const int64_t count = h;
      h = running;
      running += count;
    }
  }

#pragma omp parallel
  {
    const int t = omp_get_thread_num();
    int64_t* h = hist.data() + static_cast<int64_t>(t) * nb;
#pragma omp for schedule(static)
    for (int64_t e = 0; e < n_edges; ++e) {
      const int64_t pos = h[dst[e]]++;
      out_src[pos] = src[e];
      out_dst[pos] = dst[e];
      out_val[pos] = val[e];
    }
  }
}

void sgl_compute_degrees(const int32_t* src, const float* val, int64_t n_edges,
                         int32_t num_nodes, float* out_deg) {
#pragma omp parallel
  {
    std::vector<float> local(num_nodes, 0.0f);
#pragma omp for schedule(static)
    for (int64_t e = 0; e < n_edges; ++e) {
      local[src[e]] += val[e];
    }
#pragma omp critical
    {
      for (int32_t i = 0; i < num_nodes; ++i) {
        out_deg[i] += local[i];
      }
    }
  }
}

// Parallel row gather: out[i] = x[idx[i]] for row_bytes-wide rows, any
// dtype (one memcpy a row).  Memory-bound; numpy's fancy indexing is
// single-threaded.
void sgl_gather_rows(const char* x, int64_t row_bytes, const int32_t* idx,
                     int64_t n_idx, char* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(out + i * row_bytes,
                x + static_cast<int64_t>(idx[i]) * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

void sgl_normalized_weights(const int32_t* src, const int32_t* dst,
                            const float* val, int64_t n_edges,
                            const float* deg, float r, float* out_w) {
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < n_edges; ++e) {
    const float ds = deg[src[e]];
    const float dd = deg[dst[e]];
    if (ds > 0.0f && dd > 0.0f) {
      out_w[e] = std::pow(dd, r - 1.0f) * val[e] * std::pow(ds, -r);
    } else {
      out_w[e] = 0.0f;
    }
  }
}

// Classify and stably sort edges by the cell of the 2-D out-of-core layout
// (kernels/spmm_ooc.py): cell key part_of_row[dst] * k + src / sb, the
// destination part times the src-block count plus the src block.  The key
// is computed on the fly from the per-row part table, so the caller never
// materializes per-edge part, block or key arrays.  Two
// parallel passes as in sgl_sort_edges_by_dst: per-thread histograms, then
// a scatter in which each thread's contiguous, ordered range keeps the
// input order inside a cell (dst order when the input is dst-sorted).
// Emits the cell-sorted (src, dst, w) and the per-cell counts.
void sgl_classify_sort_cells_2d(const int32_t* src, const int32_t* dst,
                                const float* w, int64_t n, int32_t sb,
                                int32_t k, const int32_t* part_of_row,
                                int32_t n_keys, int32_t* o_src,
                                int32_t* o_dst, float* o_w,
                                int64_t* o_cell_counts) {
  const int n_threads = omp_get_max_threads();
  const int64_t nk = static_cast<int64_t>(n_keys);
  std::vector<int64_t> hist(static_cast<size_t>(n_threads) * nk, 0);

#pragma omp parallel
  {
    const int t = omp_get_thread_num();
    int64_t* h = hist.data() + static_cast<int64_t>(t) * nk;
#pragma omp for schedule(static)
    for (int64_t e = 0; e < n; ++e) {
      ++h[static_cast<int64_t>(part_of_row[dst[e]]) * k + src[e] / sb];
    }
  }

  for (int64_t b = 0; b < nk; ++b) {
    int64_t total = 0;
    for (int t = 0; t < n_threads; ++t) {
      total += hist[static_cast<int64_t>(t) * nk + b];
    }
    o_cell_counts[b] = total;
  }
  int64_t running = 0;
  for (int64_t b = 0; b < nk; ++b) {
    for (int t = 0; t < n_threads; ++t) {
      int64_t& h = hist[static_cast<int64_t>(t) * nk + b];
      const int64_t count = h;
      h = running;
      running += count;
    }
  }

#pragma omp parallel
  {
    const int t = omp_get_thread_num();
    int64_t* h = hist.data() + static_cast<int64_t>(t) * nk;
#pragma omp for schedule(static)
    for (int64_t e = 0; e < n; ++e) {
      const int64_t pos = h[static_cast<int64_t>(part_of_row[dst[e]]) * k + src[e] / sb]++;
      o_src[pos] = src[e];
      o_dst[pos] = dst[e];
      o_w[pos] = w[e];
    }
  }
}

}  // extern "C"
