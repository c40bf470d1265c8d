// Segment sum of precomputed message rows for Hopper (sm_90a).
//
//   out[r, :] (=|+=) sum_{e in rowptr[r] .. rowptr[r+1]} msg(e)
//
// The messages are already in destination order: row r owns the message
// rows rowptr[r] .. rowptr[r+1] of m, contiguous in memory.  There is no
// gather here (the caller gathered, as the TPU harnesses gather with XLA
// outside their kernels); the kernel reads each message row once and keeps
// the row's sum in f32 registers.  One body, templated on
//
//   M           the message type, float or bf16;
//   HALVES      1: a message row holds D values; 2: it holds 2D, [hi | lo];
//   WMODE       the per-edge weight: 0 none, 1 one bf16 wh, 2 a bf16 pair;
//   ACCUMULATE  add into out at a row offset instead of writing out;
//
// so that
//
//   msg(e) = a                       WMODE 0, HALVES 1
//          = a + b                   WMODE 0, HALVES 2
//          = wh*a                    WMODE 1, HALVES 1
//          = wh*a + wh*b + wl*a      WMODE 2, HALVES 2
//          = (wh + wl)*a             WMODE 2, HALVES 1
//
// with a (b) the message's first (second) half, every term in f32.
//
// Replaces: the Pallas kernels of the dev/ harnesses, all of them a
// dst-ordered segment sum done as one-hot matmuls over 128-row output tiles
// (the TPU has a matrix unit and no fast scatter):
//   D2 dev/exp_acc_alias.py:run (call :56)          bf16, accumulate
//   D3 dev/exp_spmm.py:seg_reduce_cat (call :100)   bf16 [hi | lo], summed
//   D4 dev/exp_spmm.py:seg_reduce_f32 (call :175)   f32 (and D6 A', :662)
//   D5 dev/exp_spmm.py:seg_reduce_packed (:396)     bf16 [hi | lo], wh/wl
//   D6 dev/exp_spmm.py:_call (call :662)            A: f32 with wh/wl; B: bf16 with wh
// Where the TPU kernel is handed halves (D3, D5), this kernel computes the
// same terms from them: products of bf16 values are exact in f32, so only
// the order of the sum differs.  Where the TPU kernel splits an f32 input
// into bf16 halves inside itself (D4, A, A'), this kernel does not split:
// that split is the matrix unit's way of doing f32.  For A it multiplies by
// wh + wl (exact in f32) where the TPU drops the wl*ml term.
//
// Bound on the card: bytes.  The compulsory traffic is
//   4(N+1) (rowptr) + E*W*s_m (messages) + E*s_w (weights) + N*D*4 (out)
// plus N*D*4 more for the accumulating form, which reads its window; the
// at most 6 flops per message element are far below the card's rates.
// Unlike the CSR SpMM, every byte here is read once and in order.
//
// Design: one warp per output row (grid-stride over rows), as in
// spmm_csr.cu.  Each lane owns VEC consecutive columns of the row, loads
// them from every message row as one packet (16 bytes where D and the
// pointers allow; for [hi | lo] rows two packets, one from each half) and
// accumulates in registers.  The weights are loaded 32 at a time, one per
// lane, and broadcast with shuffles.  The message of an edge is formed
// first and then added to the row's sum, as the plain version does, so the
// two differ only by the compiler's fused multiply-adds inside a message.
// A hub row with hundreds of thousands of message rows runs on one warp
// while the others finish: the known weak spot it shares with spmm_csr.cu,
// left to the long-row redesign.
//
// Writing the row: the plain form stores every row, an empty one as zeros.
// The accumulating form adds the row's sum to out in one read-add-write and
// leaves a row with an empty range unwritten, so rows the call does not
// touch keep out bit for bit (the counterpart of D2's aliased output).
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

// VEC consecutive elements moved as one load or store of VEC*sizeof(T) bytes.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Packet {
  T v[VEC];
};

template <int HALVES, int WMODE>
__device__ __forceinline__ float message(float a, float b, float wh, float wl) {
  if constexpr (WMODE == 0) {
    return HALVES == 2 ? a + b : a;
  } else if constexpr (WMODE == 1) {
    return HALVES == 2 ? wh * a + wh * b : wh * a;
  } else {
    return HALVES == 2 ? wh * a + wh * b + wl * a : (wh + wl) * a;
  }
}

template <typename M, int HALVES, int WMODE, bool ACCUMULATE, int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_reduce_kernel(const int32_t* __restrict__ rowptr,
                      const M* __restrict__ m,
                      const __nv_bfloat16* __restrict__ wh,
                      const __nv_bfloat16* __restrict__ wl,
                      float* __restrict__ out,
                      int64_t n, int64_t d) {
  using PM = Packet<M, VEC>;
  using PO = Packet<float, VEC>;
  const int lane = threadIdx.x % kWarp;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t n_warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t stride = HALVES * d;  // elements per message row

  for (int64_t row = warp; row < n; row += n_warps) {
    const int32_t beg = rowptr[row];
    const int32_t end = rowptr[row + 1];
    // warp-uniform: every lane reads the same row
    if constexpr (ACCUMULATE) {
      if (beg == end) continue;
    }
    float* o_row = out + row * d;
    // warp-uniform column loop: the shuffles below need all 32 lanes; lanes
    // past D only skip the loads and the store
    for (int64_t c0 = 0; c0 < d; c0 += (int64_t)kWarp * VEC) {
      const int64_t c = c0 + (int64_t)lane * VEC;
      const bool active = c < d;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      // int64: base + 32 must not wrap for rows ending near 2^31 messages
      for (int64_t base = beg; base < end; base += kWarp) {
        float my_h = 0.f, my_l = 0.f;  // one edge's weights per lane
        if constexpr (WMODE >= 1) {
          if (base + lane < end) my_h = __bfloat162float(wh[base + lane]);
        }
        if constexpr (WMODE == 2) {
          if (base + lane < end) my_l = __bfloat162float(wl[base + lane]);
        }
        const int64_t left = end - base;
        const int cnt = left < kWarp ? (int)left : kWarp;
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
          float h = 0.f, l = 0.f;
          if constexpr (WMODE >= 1) h = __shfl_sync(0xffffffffu, my_h, j);
          if constexpr (WMODE == 2) l = __shfl_sync(0xffffffffu, my_l, j);
          if (active) {
            // int64 offsets: E*W passes 2^31 at the bench shape
            const M* src = m + (base + j) * stride + c;
            const PM pa = *reinterpret_cast<const PM*>(src);
            PM pb;
            if constexpr (HALVES == 2) pb = *reinterpret_cast<const PM*>(src + d);
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              float b = 0.f;
              if constexpr (HALVES == 2) b = to_f32(pb.v[i]);
              acc[i] += message<HALVES, WMODE>(to_f32(pa.v[i]), b, h, l);
            }
          }
        }
      }
      if (active) {
        PO o;
        if constexpr (ACCUMULATE) {
          o = *reinterpret_cast<const PO*>(o_row + c);
#pragma unroll
          for (int i = 0; i < VEC; ++i) o.v[i] += acc[i];
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) o.v[i] = acc[i];
        }
        *reinterpret_cast<PO*>(o_row + c) = o;
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

template <typename M, int HALVES, int WMODE, bool ACCUMULATE, int VEC>
int launch(const int32_t* rowptr, const M* m, const __nv_bfloat16* wh, const __nv_bfloat16* wl,
           float* out, int64_t n, int64_t d, cudaStream_t stream) {
  segment_reduce_kernel<M, HALVES, WMODE, ACCUMULATE, VEC>
      <<<num_blocks(n), kWarp * kWarpsPerBlock, 0, stream>>>(rowptr, m, wh, wl, out, n, d);
  return (int)cudaGetLastError();
}

// Widest packet (at most MAXVEC elements) that divides D and both pointers'
// alignment: m at VEC*sizeof(M) bytes (rows lie HALVES*D elements apart and
// the lo half D elements after the hi half, so with D % VEC == 0 the first
// row's alignment holds for every packet), out's first row at VEC*4.  Among
// those, prefer one whose D/VEC fills all 32 lanes: at D = 128, bf16
// [hi | lo] rows take two 8-byte packets on 32 lanes over 16-byte ones on 16.
template <typename M, int HALVES, int WMODE, bool ACCUMULATE, int MAXVEC>
int dispatch(const int32_t* rowptr, const M* m, const __nv_bfloat16* wh, const __nv_bfloat16* wl,
             float* out, int64_t n, int64_t d, cudaStream_t stream) {
  int vec = 1;
  for (int v = MAXVEC; v > 1; v /= 2) {
    if (d % v == 0 && aligned(m, v * (int)sizeof(M)) && aligned(out, v * 4)) {
      if (vec == 1) vec = v;                                  // widest that fits
      if (d % ((int64_t)kWarp * v) == 0) { vec = v; break; }  // widest that fills the warp
    }
  }
  switch (vec) {
    case 8: return launch<M, HALVES, WMODE, ACCUMULATE, (MAXVEC >= 8 ? 8 : 1)>(rowptr, m, wh, wl, out, n, d, stream);
    case 4: return launch<M, HALVES, WMODE, ACCUMULATE, 4>(rowptr, m, wh, wl, out, n, d, stream);
    case 2: return launch<M, HALVES, WMODE, ACCUMULATE, 2>(rowptr, m, wh, wl, out, n, d, stream);
    default: return launch<M, HALVES, WMODE, ACCUMULATE, 1>(rowptr, m, wh, wl, out, n, d, stream);
  }
}

using bf16 = __nv_bfloat16;

template <typename M, int HALVES, int WMODE, bool ACCUMULATE>
int entry(const void* rowptr, const void* m, const void* wh, const void* wl, void* out,
          int64_t row_offset, int64_t n, int64_t d, void* stream) {
  return dispatch<M, HALVES, WMODE, ACCUMULATE, 16 / (int)sizeof(M)>(
      static_cast<const int32_t*>(rowptr), static_cast<const M*>(m),
      static_cast<const bf16*>(wh), static_cast<const bf16*>(wl),
      static_cast<float*>(out) + row_offset * d, n, d, static_cast<cudaStream_t>(stream));
}

}  // namespace

// One entry point per instantiation, all with the same arguments: rowptr
// int32 [n + 1]; m [E, HALVES*d]; wh, wl bf16 [E] (null where unused); out
// f32, written at rows [row_offset, row_offset + n) (row_offset is 0 for
// the plain forms).
extern "C" {

#define SGL_SEGMENT_REDUCE(NAME, M, HALVES, WMODE, ACCUMULATE)                                    \
  int NAME(const void* rowptr, const void* m, const void* wh, const void* wl, void* out,         \
           int64_t row_offset, int64_t n, int64_t d, void* stream) {                              \
    return entry<M, HALVES, WMODE, ACCUMULATE>(rowptr, m, wh, wl, out, row_offset, n, d, stream); \
  }

SGL_SEGMENT_REDUCE(sgl_segment_reduce_bf16_acc, bf16, 1, 0, true)       // D2
SGL_SEGMENT_REDUCE(sgl_segment_reduce_bf16_hilo, bf16, 2, 0, false)     // D3
SGL_SEGMENT_REDUCE(sgl_segment_reduce_f32, float, 1, 0, false)          // D4, D6 A'
SGL_SEGMENT_REDUCE(sgl_segment_reduce_bf16_hilo_w2, bf16, 2, 2, false)  // D5
SGL_SEGMENT_REDUCE(sgl_segment_reduce_f32_w2, float, 1, 2, false)       // D6 A
SGL_SEGMENT_REDUCE(sgl_segment_reduce_bf16_w, bf16, 1, 1, false)        // D6 B

#undef SGL_SEGMENT_REDUCE

const char* sgl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
