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
// Design: one warp per output row (grid-stride over rows).  The warp loads
// up to 32 (col, val) pairs at a time, one per lane, and broadcasts them
// with shuffles; each lane owns VEC consecutive columns (16-byte vector
// loads where D and the pointers allow) and accumulates them in registers.
// A hub row with many thousands of edges runs on a single warp while the
// others finish: that is this design's known weak spot on power-law graphs,
// left to a later change (split long rows across warps, then reduce).
//
// Writing the row: the plain form stores every row, an empty one as zeros.
// The accumulating form (ACCUMULATE, a compile-time flag, so the plain
// instantiations carry no branch for it) adds the row's f32 sum to the
// accumulator in one read-add-write and leaves a row whose range is empty
// unwritten, so rows the part does not touch keep the accumulator's value
// bit for bit.  A row cut between two parts is added to by both.  The
// parts are launched in order on one stream, so those two read-add-writes
// never overlap: no atomics are needed, and the sum is deterministic.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry points return cudaGetLastError() so the
// Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

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

// T: the features' type; O: the output's (T for the plain form, float for
// the accumulator).  x packets are VEC*sizeof(T) bytes, y packets
// VEC*sizeof(O): for bf16 x into an f32 accumulator, 8-byte loads and
// 16-byte read-add-writes at VEC = 4.
template <typename T, typename O, int VEC, bool ACCUMULATE>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_csr_kernel(const int32_t* __restrict__ rowptr,
                const int32_t* __restrict__ col,
                const float* __restrict__ val,
                const T* __restrict__ x,
                O* __restrict__ y,
                int64_t n, int64_t d) {
  using PX = Packet<T, VEC>;
  using PY = Packet<O, VEC>;
  const int lane = threadIdx.x % kWarp;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t n_warps = (int64_t)gridDim.x * kWarpsPerBlock;

  for (int64_t row = warp; row < n; row += n_warps) {
    const int32_t beg = rowptr[row];
    const int32_t end = rowptr[row + 1];
    // warp-uniform: every lane reads the same row
    if constexpr (ACCUMULATE) {
      if (beg == end) continue;
    }
    O* y_row = y + row * d;
    // The column loop is warp-uniform (every lane runs every trip) because
    // the shuffles below need all 32 lanes; lanes past D only skip the
    // loads and the store.
    for (int64_t c0 = 0; c0 < d; c0 += (int64_t)kWarp * VEC) {
      const int64_t c = c0 + (int64_t)lane * VEC;
      const bool active = c < d;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      // int64: base + 32 must not wrap for rows ending near 2^31 nonzeros
      for (int64_t base = beg; base < end; base += kWarp) {
        // one (col, val) pair per lane, broadcast below
        int32_t my_col = 0;
        float my_val = 0.f;
        if (base + lane < end) {
          my_col = col[base + lane];
          my_val = val[base + lane];
        }
        const int64_t left = end - base;
        const int cnt = left < kWarp ? (int)left : kWarp;
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
          const int32_t s = __shfl_sync(0xffffffffu, my_col, j);
          const float w = __shfl_sync(0xffffffffu, my_val, j);
          if (active) {
            // int64 offsets: at products scale N*D passes 2^31
            const PX p = *reinterpret_cast<const PX*>(x + (int64_t)s * d + c);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, to_f32(p.v[i]), acc[i]);
          }
        }
      }
      if (active) {
        PY out;
        if constexpr (ACCUMULATE) {  // O is float here
          out = *reinterpret_cast<const PY*>(y_row + c);
#pragma unroll
          for (int i = 0; i < VEC; ++i) out.v[i] += acc[i];
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) out.v[i] = from_f32<O>(acc[i]);
        }
        *reinterpret_cast<PY*>(y_row + c) = out;
      }
    }
  }
}

int num_blocks(int64_t n) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = 1 << 30;  // rows past this are covered by the grid-stride loop
  return (int)(blocks < cap ? blocks : cap);
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

template <typename T, typename O, int VEC, bool ACCUMULATE>
int launch(const int32_t* rowptr, const int32_t* col, const float* val,
           const T* x, O* y, int64_t n, int64_t d, cudaStream_t stream) {
  spmm_csr_kernel<T, O, VEC, ACCUMULATE>
      <<<num_blocks(n), kWarp * kWarpsPerBlock, 0, stream>>>(rowptr, col, val, x, y, n, d);
  return (int)cudaGetLastError();
}

// Widest packet (at most MAXVEC elements) that divides D and both pointers'
// alignment: x at VEC*sizeof(T) bytes, y (for the accumulator, its first
// row, acc + row_offset*D) at VEC*sizeof(O).  Rows lie D elements apart, so
// with D % VEC == 0 the first row's alignment holds for every row.  Among
// those, prefer one whose D/VEC fills all 32 lanes of the warp: at D = 128,
// bf16 takes 8-byte packets on 32 lanes over 16-byte ones on 16.
template <typename T, typename O, int MAXVEC, bool ACCUMULATE>
int dispatch(const int32_t* rowptr, const int32_t* col, const float* val,
             const T* x, O* y, int64_t n, int64_t d, cudaStream_t stream) {
  int vec = 1;
  for (int v = MAXVEC; v > 1; v /= 2) {
    if (d % v == 0 && aligned(x, v * (int)sizeof(T)) && aligned(y, v * (int)sizeof(O))) {
      if (vec == 1) vec = v;                               // widest that fits
      if (d % ((int64_t)kWarp * v) == 0) { vec = v; break; }  // widest that fills the warp
    }
  }
  switch (vec) {
    case 8: return launch<T, O, (MAXVEC >= 8 ? 8 : 1), ACCUMULATE>(rowptr, col, val, x, y, n, d, stream);
    case 4: return launch<T, O, (MAXVEC >= 4 ? 4 : 1), ACCUMULATE>(rowptr, col, val, x, y, n, d, stream);
    case 2: return launch<T, O, 2, ACCUMULATE>(rowptr, col, val, x, y, n, d, stream);
    default: return launch<T, O, 1, ACCUMULATE>(rowptr, col, val, x, y, n, d, stream);
  }
}

}  // namespace

extern "C" {

int sgl_spmm_csr_f32(const void* rowptr, const void* col, const void* val,
                     const void* x, void* y, int64_t n, int64_t d, void* stream) {
  return dispatch<float, float, 4, false>(
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
      static_cast<const float*>(val), static_cast<const float*>(x),
      static_cast<float*>(y), n, d, static_cast<cudaStream_t>(stream));
}

int sgl_spmm_csr_bf16(const void* rowptr, const void* col, const void* val,
                      const void* x, void* y, int64_t n, int64_t d, void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16, 8, false>(
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
      static_cast<const float*>(val), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(y), n, d, static_cast<cudaStream_t>(stream));
}

// acc is the f32 [>= row_offset + n, d] accumulator; rowptr is the part's
// local [n + 1] row pointer, col and val point at the part's first nonzero.
int sgl_spmm_csr_acc_f32(const void* rowptr, const void* col, const void* val,
                         const void* x, void* acc, int64_t row_offset, int64_t n,
                         int64_t d, void* stream) {
  return dispatch<float, float, 4, true>(
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
      static_cast<const float*>(val), static_cast<const float*>(x),
      static_cast<float*>(acc) + row_offset * d, n, d, static_cast<cudaStream_t>(stream));
}

int sgl_spmm_csr_acc_bf16(const void* rowptr, const void* col, const void* val,
                          const void* x, void* acc, int64_t row_offset, int64_t n,
                          int64_t d, void* stream) {
  return dispatch<__nv_bfloat16, float, 8, true>(
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
      static_cast<const float*>(val), static_cast<const __nv_bfloat16*>(x),
      static_cast<float*>(acc) + row_offset * d, n, d, static_cast<cudaStream_t>(stream));
}

const char* sgl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
