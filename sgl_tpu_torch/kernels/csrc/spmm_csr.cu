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
// every row of at most kSplitNnz nonzeros is one warp task; a longer row is
// cut into segments of kSplitNnz consecutive nonzeros (the last one
// shorter), each a warp task of its own, and long row k owns the
// consecutive segments seg_ptr[k] .. seg_ptr[k+1].
//
//   pass 1 (spmm_csr_kernel): one warp per segment, the segments first so
//     they do not form the tail of the launch, then one warp per
//     kRowsPerWarp consecutive rows.  A short row writes its result; a long
//     row is skipped there, since its segments each write an f32 partial
//     row into the workspace work[S, D].
//   pass 2 (spmm_csr_fixup_kernel, launched only when a row is long): one
//     block per long row adds that row's partials in segment order (a
//     fixed order, no atomics), then writes y once or adds into acc once.
//
// Inside a task the warp loads up to 32 (col, val) pairs at a time, one per
// lane, and broadcasts them with shuffles; each lane owns VEC consecutive
// columns (16-byte vector loads where D and the pointers allow) and
// accumulates them in registers.  Each sequential f32 sum spans at most
// kSplitNnz terms and a long row's sum the count of its segments, which also
// bounds the rounding error of hub rows.  The design constants below
// (kSplitNnz, kGroup, kMinBlocks, kRowsPerWarp, kFixupGroup) are timed
// against other values on the H100 by sgl_tpu_torch/dev/tune_spmm_csr.py,
// which builds copies of this source with one of them changed (PERF.md).
//
// Writing the row: the plain form stores every row, an empty one as zeros.
// The accumulating form (ACCUMULATE, a compile-time flag, so the plain
// instantiations carry no branch for it) adds the row's f32 sum to the
// accumulator in one read-add-write and leaves a row whose range is empty
// unwritten, so rows the part does not touch keep the accumulator's value
// bit for bit.  A row cut between two parts is added to by both, each
// part with its own plan and its own fix-up.  The parts are launched in
// order on one stream, so those read-add-writes never overlap: no atomics
// are needed anywhere, and the result is the same bits on every run.
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
constexpr int kWarpsPerBlock = 8;
// the longest row that is one warp task; spmm_csr.py's SPLIT_NNZ, by which
// the plans are cut, is the same number
constexpr int64_t kSplitNnz = 512;
// pass 1: at least 4 resident blocks (32 warps) per SM, so at most 64
// registers a thread; a warp takes one segment or kRowsPerWarp consecutive
// rows (whose bounds it loads in one round trip)
constexpr int kMinBlocks = 4;
constexpr int kRowsPerWarp = 4;

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

// acc[i] = sum_{e in [beg, end)} val[e] * x[col[e], c + i], in f32, in edge
// order.  Called by all 32 lanes together (the shuffles need them); lanes
// past D (active false) only skip the loads.  A warp task is a chain of
// dependent memory round trips, so each round trip carries as much as it
// can: the next 32 (col, val) pairs are loaded while the current ones are
// used, and the gathers go kGroup at a time (the shuffles first, then the
// group's loads, then its multiply-adds, still in edge order).
template <typename T, int VEC>
__device__ __forceinline__ void gather_sum(const int32_t* __restrict__ col,
                                           const float* __restrict__ val,
                                           const T* __restrict__ x, int64_t beg, int64_t end,
                                           int64_t d, int64_t c, bool active, int lane,
                                           float (&acc)[VEC]) {
  using PX = Packet<T, VEC>;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  // one (col, val) pair per lane, broadcast below
  int32_t next_col = 0;
  float next_val = 0.f;
  if (beg + lane < end) {
    next_col = col[beg + lane];
    next_val = val[beg + lane];
  }
  // int64: base + 32 must not wrap for rows ending near 2^31 nonzeros
  for (int64_t base = beg; base < end; base += kWarp) {
    const int32_t my_col = next_col;
    const float my_val = next_val;
    if (base + kWarp + lane < end) {
      next_col = col[base + kWarp + lane];
      next_val = val[base + kWarp + lane];
    }
    const int64_t left = end - base;
    const int cnt = left < kWarp ? (int)left : kWarp;
    for (int g = 0; g < cnt; g += kGroup) {
      int32_t s[kGroup];
      float w[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        s[u] = __shfl_sync(0xffffffffu, my_col, g + u);
        w[u] = __shfl_sync(0xffffffffu, my_val, g + u);
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

// Pass 1.  Warps [0, n_seg) take the long rows' segments, one each; warp
// n_seg + j takes rows j, j + R, ... (kRowsPerWarp of them, R the number of
// such warps), leaving a row of more than kSplitNnz nonzeros to its segments
// and the fix-up.  The segments come first, so they do not form the tail of
// the launch.
//
// T: the features' type; O: the output's (T for the plain form, float for
// the accumulator).  x packets are VEC*sizeof(T) bytes, y packets
// VEC*sizeof(O) and workspace packets VEC*4: for bf16 x into an f32
// accumulator, 8-byte loads and 16-byte read-add-writes at VEC = 4.
template <typename T, typename O, int VEC, bool ACCUMULATE>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocks)
spmm_csr_kernel(const int32_t* __restrict__ rowptr,
                const int32_t* __restrict__ col,
                const float* __restrict__ val,
                const T* __restrict__ x,
                O* __restrict__ y,
                const int32_t* __restrict__ seg_beg,
                const int32_t* __restrict__ seg_end,
                float* __restrict__ work,
                int64_t n, int64_t d, int64_t n_seg) {
  using PW = Packet<float, VEC>;
  const int lane = threadIdx.x % kWarp;
  // warp-uniform: every lane of a warp takes the same task
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;

  if (warp < n_seg) {
    const int64_t beg = seg_beg[warp];
    const int64_t end = seg_end[warp];
    // The column loop is warp-uniform (every lane runs every trip) because
    // the shuffles need all 32 lanes; lanes past D only skip the loads and
    // the store.
    for (int64_t c0 = 0; c0 < d; c0 += (int64_t)kWarp * VEC) {
      const int64_t c = c0 + (int64_t)lane * VEC;
      float acc[VEC];
      gather_sum<T, VEC>(col, val, x, beg, end, d, c, c < d, lane, acc);
      if (c < d) {
        PW out;
#pragma unroll
        for (int i = 0; i < VEC; ++i) out.v[i] = acc[i];
        *reinterpret_cast<PW*>(work + warp * d + c) = out;
      }
    }
    return;
  }
  // row warp j takes rows j, j + R, j + 2R, ... (R row warps): rows are
  // sorted by node, and a power-law graph's heavy rows sit together
  const int64_t row_warps = (n + kRowsPerWarp - 1) / kRowsPerWarp;
  const int64_t r0 = warp - n_seg;
  if (r0 >= row_warps) return;
  // lanes 2j and 2j + 1 hold the bounds of row r0 + j*R
  int32_t bound = 0;
  if (lane < 2 * kRowsPerWarp) {
    const int64_t row = r0 + (lane / 2) * row_warps;
    if (row < n) bound = rowptr[row + lane % 2];
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int64_t beg = __shfl_sync(0xffffffffu, bound, 2 * j);
    const int64_t end = __shfl_sync(0xffffffffu, bound, 2 * j + 1);
    const int64_t row = r0 + j * row_warps;
    if (row >= n) break;
    if (end - beg > kSplitNnz) continue;
    if constexpr (ACCUMULATE) {
      if (beg == end) continue;
    }
    for (int64_t c0 = 0; c0 < d; c0 += (int64_t)kWarp * VEC) {
      const int64_t c = c0 + (int64_t)lane * VEC;
      float acc[VEC];
      gather_sum<T, VEC>(col, val, x, beg, end, d, c, c < d, lane, acc);
      if (c < d) store_row<O, VEC, ACCUMULATE>(y + row * d + c, acc);
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

// one warp per segment, then one per kRowsPerWarp rows; a grid of at most
// 2^31 - 1 blocks covers any int32 CSR
int64_t pass1_blocks(int64_t n, int64_t n_seg) {
  const int64_t warps = n_seg + (n + kRowsPerWarp - 1) / kRowsPerWarp;
  return (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

// One product's arguments.  y is the output (plain) or the accumulator's
// first row of the part's window (accumulating); work is the f32
// [n_seg, d] workspace.
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
  float* work;
  int64_t n, d, n_seg, n_long;
};

template <typename T, typename O, int VEC, bool ACCUMULATE>
int launch(const Problem<T, O>& p, cudaStream_t stream) {
  constexpr int threads = kWarp * kWarpsPerBlock;
  spmm_csr_kernel<T, O, VEC, ACCUMULATE><<<(unsigned)pass1_blocks(p.n, p.n_seg), threads, 0, stream>>>(
      p.rowptr, p.col, p.val, p.x, p.y, p.seg_beg, p.seg_end, p.work, p.n, p.d, p.n_seg);
  const int err = (int)cudaGetLastError();
  if (err != 0 || p.n_long == 0) return err;
  spmm_csr_fixup_kernel<O, ACCUMULATE>
      <<<(int)(p.n_long < (1 << 30) ? p.n_long : (1 << 30)), kFixupThreads, 0, stream>>>(
          p.seg_ptr, p.long_rows, p.work, p.y, p.n_long, p.d);
  return (int)cudaGetLastError();
}

// Widest packet (at most MAXVEC elements) that divides D and every
// pointer's alignment: x at VEC*sizeof(T) bytes, y (for the accumulator,
// its first row, acc + row_offset*D) at VEC*sizeof(O), the workspace at
// VEC*4.  Rows lie D elements apart, so with D % VEC == 0 the first row's
// alignment holds for every row.  Among those, prefer one whose D/VEC
// fills all 32 lanes of the warp: at D = 128, bf16 takes 8-byte packets on
// 32 lanes over 16-byte ones on 16.
template <typename T, typename O, int MAXVEC, bool ACCUMULATE>
int dispatch(const Problem<T, O>& p, cudaStream_t stream) {
  int vec = 1;
  for (int v = MAXVEC; v > 1; v /= 2) {
    if (p.d % v == 0 && aligned(p.x, v * (int)sizeof(T)) && aligned(p.y, v * (int)sizeof(O)) &&
        aligned(p.work, v * 4)) {
      if (vec == 1) vec = v;                                  // widest that fits
      if (p.d % ((int64_t)kWarp * v) == 0) { vec = v; break; }  // widest that fills the warp
    }
  }
  switch (vec) {
    case 8: return launch<T, O, (MAXVEC >= 8 ? 8 : 1), ACCUMULATE>(p, stream);
    case 4: return launch<T, O, (MAXVEC >= 4 ? 4 : 1), ACCUMULATE>(p, stream);
    case 2: return launch<T, O, 2, ACCUMULATE>(p, stream);
    default: return launch<T, O, 1, ACCUMULATE>(p, stream);
  }
}

template <typename T, typename O>
Problem<T, O> problem(const void* rowptr, const void* col, const void* val, const void* x, void* y,
                      const void* seg_beg, const void* seg_end, const void* seg_ptr,
                      const void* long_rows, void* work, int64_t n, int64_t d, int64_t n_seg,
                      int64_t n_long) {
  return Problem<T, O>{
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
      static_cast<const float*>(val),      static_cast<const T*>(x),
      static_cast<O*>(y),                  static_cast<const int32_t*>(seg_beg),
      static_cast<const int32_t*>(seg_end), static_cast<const int32_t*>(seg_ptr),
      static_cast<const int32_t*>(long_rows), static_cast<float*>(work),
      n, d, n_seg, n_long};
}

}  // namespace

extern "C" {

// The plan's arrays (int32, on the device): seg_beg/seg_end [n_seg], the
// nonzero range of each segment; seg_ptr [n_long + 1] and long_rows
// [n_long], the segments of each long row; work is f32 [n_seg, d].  Rows of
// more than kSplitNnz nonzeros must be exactly the long rows.
int sgl_spmm_csr_f32(const void* rowptr, const void* col, const void* val, const void* x, void* y,
                     const void* seg_beg, const void* seg_end, const void* seg_ptr,
                     const void* long_rows, void* work, int64_t n, int64_t d, int64_t n_seg,
                     int64_t n_long, void* stream) {
  return dispatch<float, float, 4, false>(
      problem<float, float>(rowptr, col, val, x, y, seg_beg, seg_end, seg_ptr, long_rows, work,
                            n, d, n_seg, n_long),
      static_cast<cudaStream_t>(stream));
}

int sgl_spmm_csr_bf16(const void* rowptr, const void* col, const void* val, const void* x, void* y,
                      const void* seg_beg, const void* seg_end, const void* seg_ptr,
                      const void* long_rows, void* work, int64_t n, int64_t d, int64_t n_seg,
                      int64_t n_long, void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16, 8, false>(
      problem<__nv_bfloat16, __nv_bfloat16>(rowptr, col, val, x, y, seg_beg, seg_end, seg_ptr,
                                            long_rows, work, n, d, n_seg, n_long),
      static_cast<cudaStream_t>(stream));
}

// acc is the f32 [>= row_offset + n, d] accumulator; rowptr is the part's
// local [n + 1] row pointer, col and val point at the part's first nonzero,
// and the plan is the part's own.
int sgl_spmm_csr_acc_f32(const void* rowptr, const void* col, const void* val, const void* x,
                         void* acc, const void* seg_beg, const void* seg_end, const void* seg_ptr,
                         const void* long_rows, void* work, int64_t row_offset, int64_t n,
                         int64_t d, int64_t n_seg, int64_t n_long, void* stream) {
  return dispatch<float, float, 4, true>(
      problem<float, float>(rowptr, col, val, x, static_cast<float*>(acc) + row_offset * d,
                            seg_beg, seg_end, seg_ptr, long_rows, work, n, d, n_seg, n_long),
      static_cast<cudaStream_t>(stream));
}

int sgl_spmm_csr_acc_bf16(const void* rowptr, const void* col, const void* val, const void* x,
                          void* acc, const void* seg_beg, const void* seg_end, const void* seg_ptr,
                          const void* long_rows, void* work, int64_t row_offset, int64_t n,
                          int64_t d, int64_t n_seg, int64_t n_long, void* stream) {
  return dispatch<__nv_bfloat16, float, 8, true>(
      problem<__nv_bfloat16, float>(rowptr, col, val, x, static_cast<float*>(acc) + row_offset * d,
                                    seg_beg, seg_end, seg_ptr, long_rows, work, n, d, n_seg,
                                    n_long),
      static_cast<cudaStream_t>(stream));
}

const char* sgl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
