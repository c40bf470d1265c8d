// Gather-and-sum of feature rows for Hopper (sm_90a).
//
//   out[0, :] = sum_{e < E} x[src[e], :]        x f32 [n, D], src int32 [E]
//
// Replaces: the TPU kernel dev/exp_gather_dma.py:gather_dma (call :77, body
// _gather_kernel :38), a probe of the TPU's per-row DMA issue rate: one grid
// step per chunk of src ids, one row DMA per edge from HBM into VMEM with
// n_flight copies outstanding, then the chunk's rows summed into the one
// output row.  chunk and n_flight are parameters of the TPU's DMA engine and
// have no counterpart here: a GPU gathers a row with ordinary loads, and the
// hardware keeps as many in flight as the warps issue.  So E need not be a
// multiple of anything.
//
// Bound on the card: bytes.  The compulsory traffic is E*D*4 (one row per
// edge; a row gathered twice is read twice, as on the TPU) + 4E (src); the
// E*D adds are far below the card's f32 rate.  x larger than the 50 MB L2
// makes each row a random read from device memory.
//
// Design: two passes, no float atomics, so the sum is the same bits on
// every run.  Pass 1: each block takes a contiguous range of edges; its 8
// warps take every 8th edge of it, each lane VEC consecutive columns of the
// gathered row (16-byte loads where D and x allow), summed in registers;
// the block then adds its 8 warps' sums in a fixed order through shared
// memory and writes one partial row.  Pass 2: one block per 32 columns adds
// the partial rows, again in a fixed order.  The wrapper sizes pass 1 to
// one wave of resident blocks and allocates the partial rows.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

template <int VEC>
struct alignas(4 * VEC) Packet {
  float v[VEC];
};

// partial[blockIdx.x, :] = sum of x[src[e], :] over the block's edges
template <int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gather_sum_partial_kernel(const int32_t* __restrict__ src, const float* __restrict__ x,
                          float* __restrict__ partial, int64_t e, int64_t d,
                          int64_t per_block) {
  using P = Packet<VEC>;
  __shared__ float sums[kWarpsPerBlock][kWarp * VEC];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int64_t beg = (int64_t)blockIdx.x * per_block;
  const int64_t end = beg + per_block < e ? beg + per_block : e;
  for (int64_t c0 = 0; c0 < d; c0 += (int64_t)kWarp * VEC) {
    const int64_t c = c0 + (int64_t)lane * VEC;
    const bool active = c < d;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    if (active) {
#pragma unroll 4
      for (int64_t i = beg + w; i < end; i += kWarpsPerBlock) {
        const P p = *reinterpret_cast<const P*>(x + (int64_t)src[i] * d + c);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += p.v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) sums[w][lane * VEC + k] = acc[k];
    __syncthreads();
    for (int t = threadIdx.x; t < kWarp * VEC; t += kWarp * kWarpsPerBlock) {
      if (c0 + t < d) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kWarpsPerBlock; ++k) s += sums[k][t];
        partial[(int64_t)blockIdx.x * d + c0 + t] = s;
      }
    }
    __syncthreads();
  }
}

// out[0, c] = sum over the nb partial rows, for the block's 32 columns
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gather_sum_finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
                         int64_t nb, int64_t d) {
  __shared__ float sums[kWarpsPerBlock][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int64_t c = (int64_t)blockIdx.x * kWarp + lane;
  float s = 0.f;
  if (c < d) {
    for (int64_t r = w; r < nb; r += kWarpsPerBlock) s += partial[r * d + c];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kWarpsPerBlock; ++k) t += sums[k][lane];
    out[c] = t;
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

template <int VEC>
int launch(const int32_t* src, const float* x, float* partial, float* out, int64_t e,
           int64_t d, int64_t nb, cudaStream_t stream) {
  const int64_t per_block = (e + nb - 1) / nb;
  gather_sum_partial_kernel<VEC>
      <<<(unsigned)nb, kWarp * kWarpsPerBlock, 0, stream>>>(src, x, partial, e, d, per_block);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gather_sum_finish_kernel<<<(unsigned)((d + kWarp - 1) / kWarp), kWarp * kWarpsPerBlock, 0,
                             stream>>>(partial, out, nb, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src int32 [e]; x f32 [>= max(src) + 1, d]; partial f32 [nb, d] scratch;
// out f32 [d].  Needs e >= 1 and 1 <= nb <= e.  The packet width is the
// widest of 4, 2, 1 floats that divides d and x's alignment, preferring one
// that fills the warp's 32 lanes.
int sgl_gather_sum_f32(const void* src, const void* x, void* partial, void* out, int64_t e,
                       int64_t d, int64_t nb, void* stream) {
  const int32_t* s = static_cast<const int32_t*>(src);
  const float* xf = static_cast<const float*>(x);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int vec = 1;
  for (int v = 4; v > 1; v /= 2) {
    if (d % v == 0 && aligned(x, 4 * v)) {
      if (vec == 1) vec = v;
      if (d % ((int64_t)kWarp * v) == 0) { vec = v; break; }
    }
  }
  switch (vec) {
    case 4: return launch<4>(s, xf, p, o, e, d, nb, st);
    case 2: return launch<2>(s, xf, p, o, e, d, nb, st);
    default: return launch<1>(s, xf, p, o, e, d, nb, st);
  }
}

const char* sgl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
