// CSR sparse-matrix × dense-feature product for Hopper (sm_90a).
//
//   y[r, :] = sum_{e in rowptr[r] .. rowptr[r+1]} val[e] * x[col[e], :]
//
// The matrix is stored by destination row (dst-CSR): row r lists the edges
// that flow into node r, col[e] is the edge's source node.  The gather of
// x[col[e]] and the multiply by val[e] happen inside the kernel, the sum is
// kept in f32 registers.  One kernel body, four instantiations:
//
//   sgl_spmm_csr_f32 / _bf16      y = A x, y in x's dtype (bf16: bf16 loads,
//                                 f32 sum, one bf16 rounding on store);
//   sgl_spmm_csr_acc_f32 / _bf16  acc[row_offset + r, :] += (A_part x)[r, :]
//                                 into an f32 accumulator, for one part of a
//                                 graph split by nonzeros (streaming SpMM).
//
// Replaces: the TPU kernel sgl_tpu/kernels/pallas_spmm.py:_make_seg_kernel,
// one body in four variants: reached through _segment_reduce_mxu (f32 = two
// one-hot MXU passes over the hi/lo bf16 halves of w*x[src]; bf16 = one
// pass) and through _segment_reduce_mxu_acc (the same, accumulating into
// an aliased f32 buffer at a part's tile offset).  That kernel turns the
// scatter-add into one-hot matmuls over 128-row output tiles because a TPU
// has a matrix unit and no fast scatter; its messages are gathered and
// weighted by XLA outside it.  None of that carries over: a GPU gathers
// rows directly, so this kernel walks the CSR rows and needs no chunk
// layout, no hi/lo split and no diagonal or hub split.
//
// Bound on the card: bytes.  The compulsory traffic is
//   4(N+1) (rowptr) + 8E (col, val) + 2*N*D*s (x read once, y written once)
// with s the element size (the accumulating form reads and writes its f32
// window instead of writing y); at 2*E*D flops the arithmetic is two orders
// of magnitude below the card's rates.  The real traffic is higher: a row
// of x is read once per edge that gathers it, so what the 50 MB L2 keeps of
// x decides how far the kernel stays above the bound.
//
// Design: nonzero-balanced warp tasks, then a fix-up in a fixed order.  A
// warp keeps only a few gathers in flight, so a power-law hub row (10^5 to
// 10^6 nonzeros) walked by one warp would set the time of the whole launch
// while the card's other ~8,000 resident warps sit idle.  The wrapper
// therefore brings a plan, built once per CSR (spmm_csr.py, SplitPlan):
// every row of at most kSplitNnz nonzeros is one task; a longer row is cut
// into segments of kSplitNnz consecutive nonzeros (the last one shorter),
// each a task of its own, and long row k owns the consecutive segments
// seg_ptr[k] .. seg_ptr[k+1].
//
//   pass 1 (spmm_csr_kernel): one task per segment, the segments first so
//     they do not form the tail of the launch, then one task per
//     kRowsPerWarp rows.  A short row writes its result; a long row is
//     skipped there, since its segments each write an f32 partial row into
//     the workspace work[S, D].
//   pass 2 (spmm_csr_fixup_kernel, launched only when a row is long): one
//     block per long row adds that row's partials in segment order (a
//     fixed order, no atomics), then writes y once or adds into acc once.
//
// Inside a task a group of lanes loads up to one (col, val) pair per lane
// at a time and broadcasts them with shuffles; each lane owns VEC
// consecutive columns (16-byte vector loads where D and the pointers allow)
// and accumulates them in registers, each output element in edge order.
// Each sequential f32 sum spans at most kSplitNnz terms and a long row's sum
// the count of its segments, which also bounds the rounding error of hub
// rows.
//
// Wide rows: column panels.  When x is far larger than the 50 MB L2
// (Reddit: 561 MB at D = 602) and ~8,000 resident warps gather from all of
// it at once, every gather comes from HBM.  The wrapper then gives the
// one-shot launch a panel width Dt (spmm_csr.py, panel_columns): the grid's
// second index is the panel, the slowest one, so the tasks of columns
// [0, Dt) run before those of [Dt, 2Dt), and most of the N*Dt*s bytes of x
// that a panel gathers stay in L2.  A panel of at most 16 packets leaves
// half the warp idle, so there the warp is two groups of LANES = 16 lanes
// (a template parameter; else 32), each group a task of its own that walks
// its range in edge order: every output element is summed in the same
// order as without panels, so the results are the same bits.  The warp
// runs its groups' loops to the longer range of the two.  Each panel reads
// the (col, val) pairs again, 8E bytes: panels pay only where the gathers
// dominate (the accumulating forms' parts and buckets ran slower with
// them).
//
// Short rows: the ring's buckets hold ~2 nonzeros a row.  Walked one row at
// a time, a warp's rows cost ~12 dependent memory round trips with little
// in flight.  Where bf16 x is added into the f32 accumulator, when every
// row of a row warp has at most kShortNnz nonzeros, the warp loads all its
// rows' (col, val) pairs in one load (lane t the t-th of its nonzeros, row
// after row), gathers them in that order, each row in edge order, and
// reads its accumulator rows together.  Longer rows keep the loop above.
//
// Writing the row: the plain form walks every row and stores it, an empty
// one as zeros.  The accumulating form (ACCUMULATE, a compile-time flag, so
// the plain instantiations carry no branch for it) adds the row's f32 sum
// to the accumulator in one read-add-write and leaves a row whose range is
// empty unwritten, so rows the part does not touch keep the accumulator's
// value bit for bit.  Where the plan lists its rows neither empty nor long
// (it does when they are short on average, as in the ring's buckets), the
// accumulating form walks only those, so an empty row takes no task.  A
// row cut between two parts is added to by both, each part with its own
// plan and its own fix-up.  The parts are launched in order on one
// stream, so those read-add-writes never overlap: no atomics are needed
// anywhere, and the result is the same bits on every run.
//
// The design constants below (kSplitNnz, kGroup, kMinBlocks, kRowsPerWarp,
// kFixupGroup, kShortNnz) are timed against other values on the H100 by
// sgl_tpu_torch/dev/tune_spmm_csr.py, which builds copies of this source
// with one of them changed, and times the panel widths, the L2 budget and
// the row lists, which the wrapper picks (PERF.md).
//
// The kernels launch on the caller's stream, allocate nothing (the wrapper
// brings the workspace) and do not synchronise; the C entry points return
// cudaGetLastError() after each launch so the Python wrapper can raise on a
// refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
// the longest row that is one task; spmm_csr.py's SPLIT_NNZ, by which the
// plans are cut, is the same number
constexpr int64_t kSplitNnz = 512;
// pass 1: at least 4 resident blocks (32 warps) per SM, so at most 64
// registers a thread; a task takes one segment or kRowsPerWarp rows (whose
// bounds it loads in one round trip)
constexpr int kMinBlocks = 4;
constexpr int kRowsPerWarp = 4;
// the lanes of a task in a panel of at most 16 packets; 2 * kRowsPerWarp of
// them hold its rows' bounds
constexpr int kPanelLanes = 16;
static_assert(2 * kRowsPerWarp <= kPanelLanes, "a task's lanes hold its rows' bounds");
// short rows (bf16 x into the f32 accumulator only): a row warp whose rows
// all have at most kShortNnz nonzeros loads their pairs at once.  On the
// H100 it paid for bf16 rows (8-byte packets at D = 100, the ring's
// buckets) and cost f32 ones (16-byte packets, 3-10%), whose gathers
// already keep the memory system busy; the plain form lost with it.
constexpr int kShortNnz = 8;
static_assert(kRowsPerWarp * kShortNnz <= kWarp, "a short row warp's pairs fill one load");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements moved as one load or store of VEC*sizeof(T) bytes.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Packet {
  T v[VEC];
};

// Gathers a warp keeps in flight: the loads of one group are issued back to
// back, before the multiply-adds that use them.  On the H100, 4 ran faster
// than 8 and 16, whose registers cost occupancy or spill (also when only
// the segment warps took the deeper groups).
constexpr int kGroup = 4;

// acc[i] = sum of the len terms val[e] * x[col[e], c + i], e from beg on, in
// f32, in edge order.  Called by all 32 lanes together (the shuffles need
// them): each group of LANES lanes (gl is this lane's place in it) sums
// its own range, and a lane past its columns (active false) only skips the
// loads.  The loop runs to the longest range in the warp; a group whose
// range is shorter idles through the rest.  Each round trip carries as much
// as it can: the group's next LANES (col, val) pairs are loaded while the
// current ones are used, and the gathers go kGroup at a time (the shuffles
// first, then the group's loads, then its multiply-adds, still in edge
// order).
template <typename T, int VEC, int LANES>
__device__ __forceinline__ void gather_sum(const int32_t* __restrict__ col,
                                           const float* __restrict__ val,
                                           const T* __restrict__ x, int64_t beg, int len,
                                           int64_t d, int c, bool active, int gl,
                                           float (&acc)[VEC]) {
  using PX = Packet<T, VEC>;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  // one task a warp: its range is the warp's
  const int longest = LANES == kWarp ? len : __reduce_max_sync(kFull, len);
  // one (col, val) pair per lane, broadcast below
  int32_t next_col = 0;
  float next_val = 0.f;
  if (gl < len) {
    next_col = col[beg + gl];
    next_val = val[beg + gl];
  }
  for (int base = 0; base < longest; base += LANES) {
    const int32_t my_col = next_col;
    const float my_val = next_val;
    if (base + LANES + gl < len) {
      next_col = col[beg + base + LANES + gl];
      next_val = val[beg + base + LANES + gl];
    }
    // this group's pairs in this round trip (none when <= 0): at most
    // LANES, whatever kGroup is, since the shuffles wrap within the group
    const int cnt = len - base < LANES ? len - base : LANES;
    const int span = longest - base < LANES ? longest - base : LANES;  // the warp's
    for (int g = 0; g < span; g += kGroup) {
      int32_t s[kGroup];
      float w[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        s[u] = __shfl_sync(kFull, my_col, g + u, LANES);
        w[u] = __shfl_sync(kFull, my_val, g + u, LANES);
      }
      if (active) {
        PX p[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          // int64 offsets: at products scale N*D passes 2^31
          if (g + u < cnt) p[u] = *reinterpret_cast<const PX*>(x + (int64_t)s[u] * d + c);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (g + u < cnt) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w[u], to_f32(p[u].v[i]), acc[i]);
          }
        }
      }
    }
  }
}

// Write one row's f32 sum: cast and store (plain), or read-add-write (the
// accumulator, O = float).  bf16 is rounded two at a time into 32-bit
// words, which stay in registers (a packet of 16-bit elements filled one
// at a time went through the stack).
template <typename O, int VEC, bool ACCUMULATE>
__device__ __forceinline__ void store_row(O* p, const float (&acc)[VEC]) {
  if constexpr (!ACCUMULATE && std::is_same<O, __nv_bfloat16>::value && VEC % 2 == 0) {
    using P2 = Packet<__nv_bfloat162, VEC / 2>;
    P2 out;
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) out.v[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    *reinterpret_cast<P2*>(p) = out;
  } else {
    using PY = Packet<O, VEC>;
    PY out;
    if constexpr (ACCUMULATE) {
      out = *reinterpret_cast<const PY*>(p);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out.v[i] += acc[i];
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out.v[i] = from_f32<O>(acc[i]);
    }
    *reinterpret_cast<PY*>(p) = out;
  }
}

// The k-th row of a row task: lanes 2k and 2k + 1 of its group hold the
// row's bounds in `bound` and the row in `at` (-1: none).  Returns the row,
// -1 also for a long row of the plain form (its segments and the fix-up sum
// it), and sets beg and len (0 for no row).  The shuffles run on all 32
// lanes.
template <bool ACCUMULATE, int LANES, bool LISTED>
__device__ __forceinline__ int32_t task_row(int32_t bound, int32_t at, int k, int32_t& beg, int& len) {
  int32_t row = __shfl_sync(kFull, at, 2 * k, LANES);
  beg = __shfl_sync(kFull, bound, 2 * k, LANES);
  const int n = __shfl_sync(kFull, bound, 2 * k + 1, LANES) - beg;
  // a long row is its segments' and the fix-up's, and the accumulating form
  // leaves an empty row unwritten; the listed rows are neither
  if (!LISTED && (n > kSplitNnz || (ACCUMULATE && n == 0))) row = -1;
  len = row >= 0 ? n : 0;
  return row;
}

// A row warp whose rows all have at most kShortNnz nonzeros (lanes = 32,
// so the warp is one task; `bound` and `at` as for task_row).  Lane t
// holds the (col, val) pair of the t-th of the warp's nonzeros, row after
// row, loaded in one round trip; each gather is added to its row's sum in
// that order, so each row in edge order; the accumulator rows are read
// together, after the gathers.  (Two or four gathers issued together timed
// the same as one, or slower.)
template <typename T, typename O, int VEC, bool ACCUMULATE, bool LISTED>
__device__ __forceinline__ void short_rows(const int32_t* __restrict__ col,
                                           const float* __restrict__ val,
                                           const T* __restrict__ x, O* __restrict__ y, int32_t bound,
                                           int32_t at, int64_t d, int c_lo, int c_hi, int lane) {
  using PX = Packet<T, VEC>;
  using PY = Packet<O, VEC>;
  int total = 0, my_row = -1;
  int32_t my_col = 0;
  float my_val = 0.f;
  {
    int64_t my_edge = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      int32_t beg;
      int len;
      task_row<ACCUMULATE, kWarp, LISTED>(bound, at, k, beg, len);
      if (lane >= total && lane < total + len) {
        my_row = k;
        my_edge = (int64_t)beg + lane - total;
      }
      total += len;
    }
    if (my_row >= 0) {
      my_col = col[my_edge];
      my_val = val[my_edge];
    }
  }
  for (int c0 = c_lo; c0 < c_hi; c0 += kWarp * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < c_hi;
    float acc[kRowsPerWarp][VEC];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
    }
    for (int t = 0; t < total; ++t) {
      const int32_t s = __shfl_sync(kFull, my_col, t);
      const float w = __shfl_sync(kFull, my_val, t);
      const int row_of = __shfl_sync(kFull, my_row, t);  // the row the nonzero adds to
      if (active) {
        const PX p = *reinterpret_cast<const PX*>(x + (int64_t)s * d + c);
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) {
          if (row_of == q) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[q][i] = fmaf(w, to_f32(p.v[i]), acc[q][i]);
          }
        }
      }
    }
    int32_t rows[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      int32_t beg;
      int len;
      rows[q] = task_row<ACCUMULATE, kWarp, LISTED>(bound, at, q, beg, len);
    }
    if (active) {
      if constexpr (ACCUMULATE) {
        PY old[kRowsPerWarp];
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) {
          if (rows[q] >= 0) old[q] = *reinterpret_cast<const PY*>(y + (int64_t)rows[q] * d + c);
        }
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) {
          if (rows[q] >= 0) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) old[q].v[i] += acc[q][i];
            *reinterpret_cast<PY*>(y + (int64_t)rows[q] * d + c) = old[q];
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) {
          if (rows[q] >= 0) store_row<O, VEC, false>(y + (int64_t)rows[q] * d + c, acc[q]);
        }
      }
    }
  }
}

// Pass 1.  The grid's second index is the column panel [c_lo, c_hi) of
// `panel` columns (one panel, the whole row, when panel >= d).  A warp is
// 32 / LANES tasks side by side (LANES a template parameter, so the
// 32-lane form carries no group arithmetic; LISTED likewise, when the
// accumulating form walks a list).  Warps [0, seg_warps) take the
// long rows' segments, one a task; the row tasks follow: row task j takes
// the places j, j + R, ... of the rows it walks (kRowsPerWarp of them, R the
// number of row tasks): the plan's listed rows (`rows`, n_walk of them) in
// the accumulating form when the plan lists them, else every row.
// A row of more than kSplitNnz nonzeros is left to its segments and the
// fix-up.  The segments come first, so they do not form the tail of the
// launch.
//
// T: the features' type; O: the output's (T for the plain form, float for
// the accumulator).  x packets are VEC*sizeof(T) bytes, y packets
// VEC*sizeof(O) and workspace packets VEC*4: for bf16 x into an f32
// accumulator, 8-byte loads and 16-byte read-add-writes at VEC = 4.
template <typename T, typename O, int VEC, int LANES, bool ACCUMULATE, bool LISTED>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocks)
spmm_csr_kernel(const int32_t* __restrict__ rowptr,
                const int32_t* __restrict__ col,
                const float* __restrict__ val,
                const T* __restrict__ x,
                O* __restrict__ y,
                const int32_t* __restrict__ seg_beg,
                const int32_t* __restrict__ seg_end,
                const int32_t* __restrict__ rows,
                float* __restrict__ work,
                int64_t n_walk, int64_t d, int64_t n_seg, int64_t panel) {
  using PW = Packet<float, VEC>;
  constexpr int per_warp = kWarp / LANES;
  const int lane = threadIdx.x % kWarp;
  const int gl = lane % LANES;  // this lane's place in its task's group
  // warp-uniform: every lane of a warp is in the same branch below
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t task = warp * per_warp + lane / LANES;
  // columns are ints (D < 2^31): fewer registers
  const int c_lo = (int)(blockIdx.y * panel);
  const int c_hi = (int)(c_lo + panel < d ? c_lo + panel : d);
  const int64_t seg_warps = (n_seg + per_warp - 1) / per_warp;

  if (warp < seg_warps) {
    int64_t beg = 0;
    int len = 0;
    if (task < n_seg) {
      beg = seg_beg[task];
      len = (int)(seg_end[task] - beg);
    }
    // The column loop is warp-uniform (every lane runs every trip) because
    // the shuffles need all 32 lanes; lanes past the panel only skip the
    // loads and the store.
    for (int c0 = c_lo; c0 < c_hi; c0 += LANES * VEC) {
      const int c = c0 + gl * VEC;
      float acc[VEC];
      gather_sum<T, VEC, LANES>(col, val, x, beg, len, d, c, c < c_hi, gl, acc);
      if (task < n_seg && c < c_hi) {
        PW out;
#pragma unroll
        for (int i = 0; i < VEC; ++i) out.v[i] = acc[i];
        *reinterpret_cast<PW*>(work + task * d + c) = out;
      }
    }
    return;
  }
  // row task j takes the places j, j + R, j + 2R, ... (R row tasks): rows
  // are sorted by node, and a power-law graph's heavy rows sit together
  const int64_t row_tasks = (n_walk + kRowsPerWarp - 1) / kRowsPerWarp;
  const int64_t j = task - seg_warps * per_warp;
  if ((warp - seg_warps) * per_warp >= row_tasks) return;
  // lanes 2k and 2k + 1 of a group hold the bounds of its k-th row, and
  // both the row (-1: none)
  int32_t bound = 0, at = -1;
  if (gl < 2 * kRowsPerWarp && j < row_tasks) {
    const int64_t place = j + (gl / 2) * row_tasks;
    if (place < n_walk) {
      at = LISTED ? rows[place] : (int32_t)place;
      bound = rowptr[at + gl % 2];
    }
  }
  // short rows: one task a warp, so the test is warp-uniform; packets of at
  // most 4 elements (8 need too many registers)
  if constexpr (ACCUMULATE && std::is_same<T, __nv_bfloat16>::value && LANES == kWarp && VEC <= 4) {
    bool short_only = true;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      int32_t beg;
      int len;
      task_row<ACCUMULATE, kWarp, LISTED>(bound, at, k, beg, len);
      short_only = short_only && len <= kShortNnz;
    }
    if (short_only) {
      short_rows<T, O, VEC, ACCUMULATE, LISTED>(col, val, x, y, bound, at, d, c_lo, c_hi, lane);
      return;
    }
  }
  // Unrolled.  On the ring's buckets (a quarter of the rows empty) the
  // unrolled loop costs the walk of every row 9% against a rolled one and
  // gains the listed walk 1% (f32) to 3% (bf16), which the wrapper takes
  // there (PERF.md).
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    int32_t beg;
    int len;
    const int32_t row = task_row<ACCUMULATE, LANES, LISTED>(bound, at, k, beg, len);
    if (!__any_sync(kFull, row >= 0)) continue;
    for (int c0 = c_lo; c0 < c_hi; c0 += LANES * VEC) {
      const int c = c0 + gl * VEC;
      float acc[VEC];
      gather_sum<T, VEC, LANES>(col, val, x, (int64_t)beg, len, d, c, c < c_hi, gl, acc);
      if (row >= 0 && c < c_hi) store_row<O, VEC, ACCUMULATE>(y + (int64_t)row * d + c, acc);
    }
  }
}

// cp.async (Ampere and later) of one float from device to shared memory;
// the value occupies no register while in flight.
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kFixupThreads = 128;
// partials per cp.async commit group (on the H100, 8 ran faster than 1 and
// 4), and in flight per thread: 64, so 32 KB of shared memory
constexpr int kFixupGroup = 8;
constexpr int kFixupDepth = 64;

// Pass 2: long row long_rows[k] is the sum of partials seg_ptr[k] ..
// seg_ptr[k+1], added in that order, one block per row and one column per
// thread, so a hub row's per-partial work is spread over four warps.  The
// adds are cheap and the partials' loads are not, so each thread streams
// its column of the partials through a ring of kFixupDepth slots in shared
// memory with cp.async, kFixupGroup partials to a commit group: the next
// kFixupDepth partials are in flight while a group is added, and a group's
// shared-memory loads are issued together before its adds.  (Loads into
// registers left the compiler free to issue each load just before its add:
// one round trip per partial.)  Each thread reads back only the slots it
// filled, so no barrier is needed.
template <typename O, bool ACCUMULATE>
__global__ void __launch_bounds__(kFixupThreads)
spmm_csr_fixup_kernel(const int32_t* __restrict__ seg_ptr,
                      const int32_t* __restrict__ long_rows,
                      const float* __restrict__ work,
                      O* __restrict__ y,
                      int64_t n_long, int64_t d) {
  constexpr int Q = kFixupGroup;
  constexpr int DEPTH = kFixupDepth;
  constexpr int GROUPS = DEPTH / Q;
  __shared__ float ring[DEPTH][kFixupThreads];
  const int t = threadIdx.x;

  for (int64_t k = blockIdx.x; k < n_long; k += gridDim.x) {
    const int64_t s0 = seg_ptr[k];
    const int64_t count = seg_ptr[k + 1] - s0;
    O* y_row = y + (int64_t)long_rows[k] * d;
    for (int64_t c = t; c < d; c += kFixupThreads) {
      const float* src = work + s0 * d + c;
      // partial i goes to slot i % DEPTH, in commit group i / Q; groups
      // past the row's end are empty, so that "all but the newest
      // GROUPS - 1 groups" is always the group to add next
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) {
        if (i < count) cp_async(&ring[i][t], src + i * d);
        if (i % Q == Q - 1) cp_async_commit();
      }
      float acc = 0.f;
      int slot = 0;  // i0 % DEPTH; Q divides DEPTH, so slot + q never wraps
      const float* next = src + DEPTH * d;  // the partial to load next
      int64_t i0 = 0;
      // steady state: a full group to add and a full group to load
      for (; i0 + DEPTH + Q <= count; i0 += Q, slot = (slot + Q) % DEPTH) {
        cp_async_wait<GROUPS - 1>();
        float w[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) w[q] = ring[slot + q][t];
#pragma unroll
        for (int q = 0; q < Q; ++q) acc += w[q];
#pragma unroll
        for (int q = 0; q < Q; ++q, next += d) cp_async(&ring[slot + q][t], next);
        cp_async_commit();
      }
      // the last DEPTH + Q partials at most: what is left to load, then add
      for (; i0 < count; i0 += Q, slot = (slot + Q) % DEPTH) {
        cp_async_wait<GROUPS - 1>();
        float w[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) w[q] = ring[slot + q][t];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (i0 + q < count) acc += w[q];
        }
#pragma unroll
        for (int q = 0; q < Q; ++q, next += d) {
          if (i0 + DEPTH + q < count) cp_async(&ring[slot + q][t], next);
        }
        cp_async_commit();
      }
      if constexpr (ACCUMULATE) {
        y_row[c] += acc;
      } else {
        y_row[c] = from_f32<O>(acc);
      }
    }
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

// One product's arguments.  y is the output (plain) or the accumulator's
// first row of the part's window (accumulating); work is the f32
// [n_seg, d] workspace; panel is at most d.
template <typename T, typename O>
struct Problem {
  const int32_t* rowptr;
  const int32_t* col;
  const float* val;
  const T* x;
  O* y;
  const int32_t* seg_beg;
  const int32_t* seg_end;
  const int32_t* seg_ptr;
  const int32_t* long_rows;
  const int32_t* rows;
  float* work;
  int64_t n, d, n_seg, n_long, n_rows, panel;
};

template <typename T, typename O, int VEC, int LANES, bool ACCUMULATE, bool LISTED = false>
int launch(const Problem<T, O>& p, cudaStream_t stream) {
  // the accumulating form walks the plan's listed rows, when it lists them
  if constexpr (ACCUMULATE && !LISTED) {
    if (p.n_rows > 0) return launch<T, O, VEC, LANES, ACCUMULATE, true>(p, stream);
  }
  constexpr int threads = kWarp * kWarpsPerBlock;
  constexpr int64_t per_warp = kWarp / LANES;
  const int64_t n_walk = LISTED ? p.n_rows : p.n;
  const int64_t row_tasks = (n_walk + kRowsPerWarp - 1) / kRowsPerWarp;
  const int64_t warps = (p.n_seg + per_warp - 1) / per_warp + (row_tasks + per_warp - 1) / per_warp;
  // at least one block, so every product is one launch; a grid of at most
  // 2^31 - 1 blocks covers any int32 CSR
  const int64_t blocks = warps > 0 ? (warps + kWarpsPerBlock - 1) / kWarpsPerBlock : 1;
  const int64_t panels = (p.d + p.panel - 1) / p.panel;
  if (panels > 65535) return (int)cudaErrorInvalidValue;
  spmm_csr_kernel<T, O, VEC, LANES, ACCUMULATE, LISTED>
      <<<dim3((unsigned)blocks, (unsigned)panels), threads, 0, stream>>>(
          p.rowptr, p.col, p.val, p.x, p.y, p.seg_beg, p.seg_end, p.rows, p.work, n_walk, p.d, p.n_seg,
          p.panel);
  const int err = (int)cudaGetLastError();
  if (err != 0 || p.n_long == 0) return err;
  spmm_csr_fixup_kernel<O, ACCUMULATE>
      <<<(int)(p.n_long < (1 << 30) ? p.n_long : (1 << 30)), kFixupThreads, 0, stream>>>(
          p.seg_ptr, p.long_rows, p.work, p.y, p.n_long, p.d);
  return (int)cudaGetLastError();
}

// The lanes of a task: kPanelLanes in a panel that their packets of VEC
// elements cover (the panel of 64 f32 columns at D = 128 and D = 500), else
// 32.  The accumulating forms (whose wrapper gives them no panels: they ran
// slower with them) and packets of 8 (which take no panel) take 32.
template <typename T, typename O, int VEC, bool ACCUMULATE>
int launch_lanes(const Problem<T, O>& p, cudaStream_t stream) {
  if constexpr (ACCUMULATE || VEC > 4) {
    return launch<T, O, VEC, kWarp, ACCUMULATE>(p, stream);
  } else {
    if (p.panel < p.d && (int64_t)kPanelLanes * VEC >= p.panel)
      return launch<T, O, VEC, kPanelLanes, ACCUMULATE>(p, stream);
    return launch<T, O, VEC, kWarp, ACCUMULATE>(p, stream);
  }
}

// Widest packet (at most MAXVEC elements) that divides D, the panel width
// and every pointer's alignment: x at VEC*sizeof(T) bytes, y (for the
// accumulator, its first row, acc + row_offset*D) at VEC*sizeof(O), the
// workspace at VEC*4.  Rows lie D elements apart and panels `panel`
// columns, so with both divisible by VEC the first row's alignment holds
// for every row and panel.  Without panels, prefer among those one whose
// D/VEC fills all 32 lanes of the warp: at D = 128, bf16 takes 8-byte
// packets on 32 lanes over 16-byte ones on 16.  In a panel, at most 4
// elements (8 spill registers) and at most panel / kPanelLanes, so that a
// task's lanes all hold columns; the widest leaves the most lanes to other
// tasks.
template <typename T, typename O, int MAXVEC, bool ACCUMULATE>
int dispatch(const Problem<T, O>& p, cudaStream_t stream) {
  if (p.panel < 1 || p.panel > p.d) return (int)cudaErrorInvalidValue;
  const bool panels = p.panel < p.d;
  int vec = 1;
  for (int v = panels && MAXVEC > 4 ? 4 : MAXVEC; v > 1; v /= 2) {
    if (panels && p.panel < (int64_t)kPanelLanes * v) continue;
    if (p.d % v == 0 && p.panel % v == 0 && aligned(p.x, v * (int)sizeof(T)) &&
        aligned(p.y, v * (int)sizeof(O)) && aligned(p.work, v * 4)) {
      if (vec == 1) vec = v;                                                     // widest that fits
      if (p.panel == p.d && p.d % ((int64_t)kWarp * v) == 0) { vec = v; break; }  // fills the warp
    }
  }
  switch (vec) {
    case 8: return launch_lanes<T, O, (MAXVEC >= 8 ? 8 : 1), ACCUMULATE>(p, stream);
    case 4: return launch_lanes<T, O, (MAXVEC >= 4 ? 4 : 1), ACCUMULATE>(p, stream);
    case 2: return launch_lanes<T, O, 2, ACCUMULATE>(p, stream);
    default: return launch_lanes<T, O, 1, ACCUMULATE>(p, stream);
  }
}

template <typename T, typename O>
Problem<T, O> problem(const void* rowptr, const void* col, const void* val, const void* x, void* y,
                      const void* seg_beg, const void* seg_end, const void* seg_ptr,
                      const void* long_rows, const void* rows, void* work, int64_t n, int64_t d,
                      int64_t n_seg, int64_t n_long, int64_t n_rows, int64_t panel) {
  return Problem<T, O>{
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
      static_cast<const float*>(val),      static_cast<const T*>(x),
      static_cast<O*>(y),                  static_cast<const int32_t*>(seg_beg),
      static_cast<const int32_t*>(seg_end), static_cast<const int32_t*>(seg_ptr),
      static_cast<const int32_t*>(long_rows), static_cast<const int32_t*>(rows),
      static_cast<float*>(work),           n, d, n_seg, n_long, n_rows, panel};
}

}  // namespace

extern "C" {

// The plan's arrays (int32, on the device): seg_beg/seg_end [n_seg], the
// nonzero range of each segment; seg_ptr [n_long + 1] and long_rows
// [n_long], the segments of each long row; rows [n_rows], the rows that
// are neither empty nor long, in order, or none (n_rows = 0: the
// accumulating form then walks every row; the plain form always does and
// reads no `rows`); work is f32
// [n_seg, d].  Rows of more than kSplitNnz nonzeros must be exactly the
// long rows.  panel (1 .. d) is the width of the column panels; d means
// none.
int sgl_spmm_csr_f32(const void* rowptr, const void* col, const void* val, const void* x, void* y,
                     const void* seg_beg, const void* seg_end, const void* seg_ptr,
                     const void* long_rows, const void* rows, void* work, int64_t n, int64_t d,
                     int64_t n_seg, int64_t n_long, int64_t n_rows, int64_t panel, void* stream) {
  return dispatch<float, float, 4, false>(
      problem<float, float>(rowptr, col, val, x, y, seg_beg, seg_end, seg_ptr, long_rows, rows,
                            work, n, d, n_seg, n_long, n_rows, panel),
      static_cast<cudaStream_t>(stream));
}

int sgl_spmm_csr_bf16(const void* rowptr, const void* col, const void* val, const void* x, void* y,
                      const void* seg_beg, const void* seg_end, const void* seg_ptr,
                      const void* long_rows, const void* rows, void* work, int64_t n, int64_t d,
                      int64_t n_seg, int64_t n_long, int64_t n_rows, int64_t panel, void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16, 8, false>(
      problem<__nv_bfloat16, __nv_bfloat16>(rowptr, col, val, x, y, seg_beg, seg_end, seg_ptr,
                                            long_rows, rows, work, n, d, n_seg, n_long, n_rows,
                                            panel),
      static_cast<cudaStream_t>(stream));
}

// acc is the f32 [>= row_offset + n, d] accumulator; rowptr is the part's
// local [n + 1] row pointer, col and val point at the part's first nonzero,
// and the plan is the part's own.
int sgl_spmm_csr_acc_f32(const void* rowptr, const void* col, const void* val, const void* x,
                         void* acc, const void* seg_beg, const void* seg_end, const void* seg_ptr,
                         const void* long_rows, const void* rows, void* work, int64_t row_offset,
                         int64_t n, int64_t d, int64_t n_seg, int64_t n_long, int64_t n_rows,
                         int64_t panel, void* stream) {
  return dispatch<float, float, 4, true>(
      problem<float, float>(rowptr, col, val, x, static_cast<float*>(acc) + row_offset * d,
                            seg_beg, seg_end, seg_ptr, long_rows, rows, work, n, d, n_seg, n_long,
                            n_rows, panel),
      static_cast<cudaStream_t>(stream));
}

int sgl_spmm_csr_acc_bf16(const void* rowptr, const void* col, const void* val, const void* x,
                          void* acc, const void* seg_beg, const void* seg_end, const void* seg_ptr,
                          const void* long_rows, const void* rows, void* work, int64_t row_offset,
                          int64_t n, int64_t d, int64_t n_seg, int64_t n_long, int64_t n_rows,
                          int64_t panel, void* stream) {
  return dispatch<__nv_bfloat16, float, 8, true>(
      problem<__nv_bfloat16, float>(rowptr, col, val, x, static_cast<float*>(acc) + row_offset * d,
                                    seg_beg, seg_end, seg_ptr, long_rows, rows, work, n, d, n_seg,
                                    n_long, n_rows, panel),
      static_cast<cudaStream_t>(stream));
}

const char* sgl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
