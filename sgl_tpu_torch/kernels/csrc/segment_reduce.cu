// Segment sum of precomputed message rows for Hopper (sm_90a).
//
//   out[r, :] (=|+=) sum_{e in rowptr[r] .. rowptr[r+1]} msg(e)
//
// The messages are already in destination order: row r owns the message
// rows rowptr[r] .. rowptr[r+1] of m, contiguous in memory.  There is no
// gather here (the caller gathered, as the TPU harnesses gather with XLA
// outside their kernels); the kernel reads each message row once, in
// order, and sums in f32.  One body, templated on
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
// Every byte is read once, in order, and there is no gather: the kernel's
// work is to keep enough bytes in flight on every SM.
//
// Design: tiles of consecutive messages, not rows.  A power-law hub row
// (484,644 messages at the bench shape) walked by one warp would set the
// time of the launch, so the call's messages [0, E) are cut at every
// multiple of kTileMessages and block b owns the messages
// [b*T, (b+1)*T): the work is balanced by bytes exactly, whatever the row
// lengths.
//
//   pass 1 (segment_reduce_kernel): the block streams its tile through a
//     ring of kStages shared-memory stages of about kChunkBytes each.
//     Where a message row is a multiple of 16 bytes and m is 16-byte
//     aligned, one thread fills the stages with 1-D bulk copies
//     (cp.async.bulk, the TMA's non-tensor form), one mbarrier per stage
//     counting the bytes; otherwise every thread fills them with 16-byte
//     cp.async of the 16-byte words that hold the chunk, which the
//     consumers read at the chunk's offset in the first word.  The weights
//     of the tile (T*2 bytes each) come into shared memory with the first
//     chunk and are read from there: no shuffle per message.  A
//     __syncthreads after each chunk releases its stage to the producer.
//     While the first chunks are in flight, each warp finds the tile's
//     first row by a 32-way search in rowptr (4 dependent loads for 200,000
//     rows) and the block loads the row pointers of the next T + 7 rows into
//     shared memory, so that a row boundary inside the tile costs no load
//     from device memory.
//     Past 1024 columns, the call runs once per column window of 1024, and
//     each window's stages hold only its columns of each message row: all
//     threads copy the 16-byte words that hold a row's window (each half's)
//     into a slot of their own with cp.async, read at the window's offset
//     in its first word, so a row of any width streams in chunks.
//     Each thread owns columns tid, tid + 128, ... of a column window
//     (every column for D <= 1024) and keeps one f32 sum per column, which
//     adds the tile's messages in edge order.  A row that lies wholly in
//     the tile is written by it: stored, or added to out's values, which
//     the accumulating form loads as the row starts so that the load is in
//     flight while the row is summed.  A row that crosses a tile edge
//     leaves one piece per tile in the f32 workspace: the piece of the row
//     that enters a tile in slot `head` of that tile, the piece of the row
//     that starts in a tile and leaves it in slot `tail`; at most two a
//     tile.  The block also records the row whose last piece it holds.
//   pass 2 (segment_reduce_fixup_kernel, launched when there is more than
//     one tile): the block of the tile where a cut row ends adds the
//     row's pieces in tile order (its start tile's tail, then the heads of
//     the following tiles, which lie next to each other), streamed
//     through a cp.async ring as in spmm_csr.cu's fix-up, and writes the
//     row once or adds into out once.
//
// There are no atomics: every output row is written by one block, and two
// runs give the same bits.  A sequential f32 sum over messages spans at
// most kTileMessages terms; a cut row's pieces are one more sum, of
// (row length / T) + 2 terms at most.
//
// Writing the rows: the plain form writes every row once, an empty one as
// zeros; the empty rows are spread over every block of pass 1 by row index
// and written after its tile (a run of empty rows at one message offset,
// such as the trailing rows of a graph, would otherwise fall to one
// block).  The accumulating form leaves a row with an empty range
// unwritten, so rows the call does not touch keep out bit for bit (the
// counterpart of D2's aliased output).
//
// The design constants below (kTileMessages, kStages, kChunkBytes) are
// timed against other values on the H100 by
// sgl_tpu_torch/dev/tune_segment_reduce.py, which builds copies of this
// source with one of them changed (PERF.md).
//
// The kernels launch on the caller's stream, allocate nothing (the wrapper
// brings the workspace) and do not synchronise; the C entry points return
// cudaGetLastError() after each launch so the Python wrapper can raise on a
// refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
// consecutive messages a block of pass 1 sums; segment_reduce.py's
// TILE_MESSAGES, by which the wrapper sizes the workspace, is the same number
constexpr int64_t kTileMessages = 512;
// the ring: stages of whole message rows (of their column window's part
// past one window), about kChunkBytes each (one row where a row is wider),
// so about kStages * kChunkBytes in flight a block
constexpr int kStages = 4;
constexpr int kChunkBytes = 16384;
// columns a thread owns at most: a column window is kThreads * kColsMax
// wide (segment_reduce.py's COLUMN_WINDOW)
constexpr int kColsMax = 8;
constexpr int64_t kWindowCols = (int64_t)kThreads * kColsMax;
// pass 1 has at least one block per this many rows, which zero-fill the
// empty ones (plain forms)
constexpr int64_t kFillRows = 1024;

// How pass 1 fills its ring: kBulk, 1-D bulk copies of whole message rows
// by one thread (16-byte rows, m 16-byte aligned); kAsync, cp.async by
// every thread of the 16-byte words that hold whole rows; kWindowed (past
// one column window), cp.async of the words that hold each row's window.
enum Copy { kBulk, kAsync, kWindowed };

// Bytes of one half of a message row's column window in a stage under
// kWindowed: the 16-byte words that hold `width` values of `elem` bytes at
// any offset of their first word.
__host__ __device__ constexpr int window_half_bytes(int64_t width, int elem) {
  return (int)((width * elem + 30) / 16 * 16);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier and bulk copy (sm_90) -------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// arrive once and expect `bytes` more of transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, counted on `bar` when they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- cp.async (sm_80) ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- rows ----------------------------------------------------------------------

// The row that holds message x (x < rowptr[n]): the first r with
// rowptr[r + 1] > x.  Called by all 32 lanes of a warp together: each
// round probes 32 points of the range at once, so 200,000 rows take 4
// dependent loads where a binary search takes 18.
__device__ __forceinline__ int64_t row_of(const int32_t* __restrict__ rowptr, int64_t n, int64_t x) {
  const int lane = threadIdx.x % 32;
  int64_t lo = -1, hi = n - 1;  // rowptr[lo + 1] <= x < rowptr[hi + 1]
  while (hi - lo > 1) {
    const int64_t span = hi - lo;
    // lane k probes lo + span*(k+1)/32, lane 31 probes hi; "above" holds
    // from some lane on, since rowptr does not decrease
    const int64_t p = lo + span * (lane + 1) / 32;
    const bool above = p == hi || rowptr[p + 1] > x;
    const int first = __ffs(__ballot_sync(0xffffffffu, above)) - 1;
    hi = lo + span * (first + 1) / 32;
    lo = first == 0 ? lo : lo + span * first / 32;
  }
  return hi;
}

// The first row after r that holds message x (x < rowptr[n], rowptr[r + 1]
// <= x): the next row, unless empty rows lie between, which a galloping
// search skips in a few loads however many they are.
__device__ __forceinline__ int64_t next_row(const int32_t* __restrict__ rowptr, int64_t n, int64_t r,
                                            int64_t x) {
  int64_t lo = r, hi = r + 1;  // rowptr[lo + 1] <= x; is rowptr[hi + 1] > x?
  for (int64_t step = 1; rowptr[hi + 1] <= x; step *= 2) {
    lo = hi;
    hi = lo + step < n - 1 ? lo + step : n - 1;
  }
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    if (rowptr[mid + 1] > x) hi = mid; else lo = mid;
  }
  return hi;
}

// Write one row's sums for this thread's columns, added to `base` (ADD:
// out's values, loaded when the row started), and clear them.
template <bool ADD, int COLS>
__device__ __forceinline__ void flush(float* __restrict__ dst, float (&acc)[COLS], const float (&base)[COLS],
                                      int64_t c_beg, int64_t c_end) {
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int64_t c = c_beg + threadIdx.x + (int64_t)k * kThreads;
    if (c < c_end) dst[c] = ADD ? base[k] + acc[k] : acc[k];
    acc[k] = 0.f;
  }
}

// Entries of rowptr a block of pass 1 keeps in shared memory, from its
// first row's start on: the ends of T + 7 rows, more than a tile of T
// messages holds unless empty rows lie among them (then a search in
// rowptr takes over)
constexpr int kWindow = (int)kTileMessages + 8;

// Dynamic shared memory of pass 1: the ring, the weights, the row pointers
// and a barrier per stage.
__host__ __device__ constexpr int pass1_smem(int stage_bytes) {
  return kStages * stage_bytes + 2 * (int)kTileMessages * 2 + kWindow * 4 + kStages * 8;
}

// The plain forms' empty rows among this block's rows by index, written
// as zeros for the column window [c_beg, c_end): ceil(n / gridDim.x) rows
// a block, flagged kThreads at a time in one round of loads.
__device__ void fill_empty_rows(const int32_t* __restrict__ rowptr, float* __restrict__ out, int64_t n,
                                int64_t d, int64_t c_beg, int64_t c_end) {
  __shared__ uint32_t empty_rows[kThreads / 32];
  const int tid = threadIdx.x;
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  const int64_t f0 = blockIdx.x * per;
  const int64_t f1 = f0 + per < n ? f0 + per : n;
  for (int64_t g0 = f0; g0 < f1; g0 += kThreads) {
    const int64_t r = g0 + tid;
    const uint32_t mask = __ballot_sync(0xffffffffu, r < f1 && rowptr[r] == rowptr[r + 1]);
    if (tid % 32 == 0) empty_rows[tid / 32] = mask;
    __syncthreads();
    for (int w = 0; w < kThreads / 32; ++w) {
      for (uint32_t bits = empty_rows[w]; bits; bits &= bits - 1) {
        const int64_t row = g0 + 32 * w + __ffs(bits) - 1;
        for (int64_t c = c_beg + tid; c < c_end; c += kThreads) out[row * d + c] = 0.f;
      }
    }
    __syncthreads();  // the flags are read before the next round writes them
  }
}

// Pass 1.  Block b sums the messages [b*T, min((b+1)*T, E)) for the column
// window [c_beg, c_end), then zero-fills the empty rows among its rows by
// index (plain forms); blocks past the last tile do only that.
// stage_bytes: one ring stage; chunk: message rows a stage holds; w_bulk:
// wh (and wl) are 16-byte aligned, so the weights come by bulk copy too.
// Under kWindowed, message row q of a chunk lies at q * HALVES * hb in its
// stage, its second half hb further, with hb = window_half_bytes(window).
// The workspace holds the head pieces [n_tiles, d], the tail pieces
// [n_tiles, d], then one int32 a tile: the row whose last piece the tile
// holds (a cut row that ends in it), or -1.
template <typename M, int HALVES, int WMODE, bool ACCUMULATE, int COPY, int COLS>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const int32_t* __restrict__ rowptr,
                      const M* __restrict__ m,
                      const bf16* __restrict__ wh,
                      const bf16* __restrict__ wl,
                      float* __restrict__ out,
                      float* __restrict__ work,
                      int64_t n, int64_t d, int64_t e_total, int64_t n_tiles,
                      int64_t c_beg, int64_t c_end, int stage_bytes, int chunk, bool w_bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wh_s = reinterpret_cast<bf16*>(smem + (int64_t)kStages * stage_bytes);
  bf16* wl_s = wh_s + kTileMessages;
  int32_t* rp_s = reinterpret_cast<int32_t*>(wl_s + kTileMessages);
  uint64_t* full = reinterpret_cast<uint64_t*>(rp_s + kWindow);

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t row_elems = HALVES * d;  // elements per message row
  const int64_t row_bytes = row_elems * (int64_t)sizeof(M);
  constexpr bool BULK = COPY == kBulk;
  const int half_slot = window_half_bytes(c_end - c_beg, (int)sizeof(M));  // kWindowed
  const int slot = HALVES * half_slot;
  const int64_t lo = b * kTileMessages;
  const int64_t hi = lo + kTileMessages < e_total ? lo + kTileMessages : e_total;
  if (b >= n_tiles) {
    if constexpr (!ACCUMULATE) fill_empty_rows(rowptr, out, n, d, c_beg, c_end);
    return;
  }
  const int n_chunks = (int)((hi - lo + chunk - 1) / chunk);
  // bytes of each weight array that come by bulk copy (a multiple of 16)
  const int w_bytes = (WMODE > 0 && BULK && w_bulk) ? (int)(((hi - lo) * 2) & ~int64_t(15)) : 0;

  // Fill stage i % kStages with chunk i: BULK, thread 0 alone, counted on
  // the stage's barrier (the first chunk also brings the weights); else
  // every thread a share of the 16-byte words that hold the chunk, or
  // (kWindowed) a warp at a time those that hold one row's window half.
  auto issue = [&](int i) {
    const int64_t e0 = lo + (int64_t)i * chunk;
    const int64_t e1 = e0 + chunk < hi ? e0 + chunk : hi;
    unsigned char* dst = smem + (int64_t)(i % kStages) * stage_bytes;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(m) + e0 * row_bytes;
    if constexpr (BULK) {
      const uint32_t bytes = (uint32_t)((e1 - e0) * row_bytes);
      uint64_t* bar = &full[i % kStages];
      mbar_expect_tx(bar, bytes + (i == 0 ? (uint32_t)((WMODE == 2 ? 2 : 1) * w_bytes) : 0u));
      bulk_copy(dst, src, bytes, bar);
      if (i == 0 && w_bytes > 0) {
        if constexpr (WMODE >= 1) bulk_copy(wh_s, wh + lo, (uint32_t)w_bytes, bar);
        if constexpr (WMODE == 2) bulk_copy(wl_s, wl + lo, (uint32_t)w_bytes, bar);
      }
    } else if constexpr (COPY == kWindowed) {
      const int64_t seg_bytes = (c_end - c_beg) * (int64_t)sizeof(M);
      for (int g = tid / 32; g < (int)(e1 - e0) * HALVES; g += kThreads / 32) {
        const int q = g / HALVES, h = g % HALVES;
        const uintptr_t a = reinterpret_cast<uintptr_t>(m + (e0 + q) * row_elems + h * d + c_beg);
        const uintptr_t a0 = a & ~uintptr_t(15);
        const int words = (int)((((a + seg_bytes + 15) & ~uintptr_t(15)) - a0) / 16);
        unsigned char* to = dst + q * slot + h * half_slot;
        for (int k = tid % 32; k < words; k += 32) {
          cp_async16(to + 16 * k, reinterpret_cast<const void*>(a0 + 16 * k));
        }
      }
    } else {
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
      const uintptr_t a1 = (reinterpret_cast<uintptr_t>(src) + (e1 - e0) * row_bytes + 15) & ~uintptr_t(15);
      const int words = (int)((a1 - a0) / 16);
      for (int k = tid; k < words; k += kThreads) {
        cp_async16(dst + 16 * k, reinterpret_cast<const void*>(a0 + 16 * k));
      }
    }
  };

  if constexpr (BULK) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int i = 0; i < kStages && i < n_chunks; ++i) issue(i);
    }
  } else {
    for (int i = 0; i < kStages; ++i) {
      if (i < n_chunks) issue(i);
      cp_async_commit();  // empty groups too: group i is chunk i
    }
  }

  // While the first chunks are in flight: the tile's first row, and the
  // row pointers after it; the weights the bulk copy does not bring (the
  // tail of the tile's, or all of them where wh or wl is not 16-byte
  // aligned).
  const int64_t r0 = row_of(rowptr, n, lo);
  for (int j = tid; j < kWindow; j += kThreads) rp_s[j] = r0 + j <= n ? rowptr[r0 + j] : 0x7fffffff;
  for (int64_t i = w_bytes / 2 + tid; i < hi - lo; i += kThreads) {
    if constexpr (WMODE >= 1) wh_s[i] = wh[lo + i];
    if constexpr (WMODE == 2) wl_s[i] = wl[lo + i];
  }
  __syncthreads();  // the row pointers and weights above, the barriers' initialisation

  // the row being summed, r = r0 + j - 1, ends at rp_s[j]; the tile's
  // first row is cut at the tile's start if it began before
  int j = 1;
  int64_t r = r0;
  int64_t row_end = rp_s[1];
  bool head = rp_s[0] < lo;
  bool head_ends = false;  // the row cut at the tile's start ends in it
  float* head_slot = work + b * d;
  float* tail_slot = work + (n_tiles + b) * d;

  bool active[COLS];  // this thread's columns within the window
#pragma unroll
  for (int k = 0; k < COLS; ++k) active[k] = c_beg + tid + (int64_t)k * kThreads < c_end;
  float acc[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) acc[k] = 0.f;
  // ACCUMULATE: out's values of row r, loaded as the row starts so that
  // the load is in flight while the row is summed
  float base[COLS] = {};
  auto load_base = [&](int64_t row) {
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      base[k] = ACCUMULATE && active[k] ? out[row * d + c_beg + tid + (int64_t)k * kThreads] : 0.f;
    }
  };
  if (!head) load_base(r0);
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages;
    const int64_t e0 = lo + (int64_t)i * chunk;
    const int len = (int)((e0 + chunk < hi ? e0 + chunk : hi) - e0);
    const unsigned char* stage = smem + (int64_t)s * stage_bytes;
    if constexpr (BULK) {
      mbar_wait(&full[s], (uint32_t)((i / kStages) & 1));
    } else {
      cp_async_wait<kStages - 1>();
      __syncthreads();  // every thread's share of chunk i has landed
      if constexpr (COPY == kAsync) stage += reinterpret_cast<uintptr_t>(m + e0 * row_elems) & 15;
    }
    // this thread's first column of the chunk's first message row; 32-bit
    // offsets within the chunk (one window, c_beg = 0, but kWindowed)
    const M* row = reinterpret_cast<const M*>(stage) + c_beg + tid;
    const int step = (int)row_elems;
    const int half = (int)d;
    const bf16* h_s = wh_s + (e0 - lo);
    const bf16* l_s = wl_s + (e0 - lo);
    int q = 0;  // message e0 + q of the chunk
    while (q < len) {
      const int stop = row_end - e0 < len ? (int)(row_end - e0) : len;
#pragma unroll 4
      for (; q < stop; ++q, row += step) {
        float h = 0.f, l = 0.f;
        if constexpr (WMODE >= 1) h = __bfloat162float(h_s[q]);
        if constexpr (WMODE == 2) l = __bfloat162float(l_s[q]);
        const M* ra = row;  // this thread's first column of each half
        const M* rb = row + half;
        if constexpr (COPY == kWindowed) {  // each half at its offset in its slot
          const M* src = m + (e0 + q) * row_elems + c_beg;
          const unsigned char* at = stage + q * slot;
          ra = reinterpret_cast<const M*>(at + (reinterpret_cast<uintptr_t>(src) & 15)) + tid;
          rb = reinterpret_cast<const M*>(at + half_slot + (reinterpret_cast<uintptr_t>(src + d) & 15)) + tid;
        }
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          if (active[k]) {
            const float a = to_f32(ra[k * kThreads]);
            const float bb = HALVES == 2 ? to_f32(rb[k * kThreads]) : 0.f;
            acc[k] += message<HALVES, WMODE>(a, bb, h, l);
          }
        }
      }
      const int64_t e = e0 + q;
      if (e == row_end && e < hi) {  // row r ends inside the tile
        if (head) {
          flush<false>(head_slot, acc, base, c_beg, c_end);
          head_ends = true;
        } else {
          flush<ACCUMULATE>(out + r * d, acc, base, c_beg, c_end);
        }
        head = false;
        // the next row that holds message e: past the empty ones, in the
        // window while it lasts, then by a search from the last row known
        // to end at or before e
        if (j < kWindow) {
          do { ++j; } while (j < kWindow && rp_s[j] <= e);
        }
        if (j < kWindow) {
          r = r0 + j - 1;
          row_end = rp_s[j];
        } else {
          r = next_row(rowptr, n, r > r0 + kWindow - 2 ? r : r0 + kWindow - 2, e);
          row_end = rowptr[r + 1];
        }
        load_base(r);
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (i + kStages < n_chunks) {
      if (!BULK || tid == 0) issue(i + kStages);
    }
    if constexpr (!BULK) cp_async_commit();
  }
  // the tile's last row: whole, or a piece of a cut row
  if (head) {
    flush<false>(head_slot, acc, base, c_beg, c_end);
    head_ends = row_end <= hi;
  } else if (row_end > hi) {
    flush<false>(tail_slot, acc, base, c_beg, c_end);
  } else {
    flush<ACCUMULATE>(out + r * d, acc, base, c_beg, c_end);
  }
  if (n_tiles > 1 && tid == 0) {
    reinterpret_cast<int32_t*>(work + 2 * n_tiles * d)[b] = head_ends ? (int32_t)r0 : -1;
  }
  if constexpr (!ACCUMULATE) fill_empty_rows(rowptr, out, n, d, c_beg, c_end);
}

// fix-up ring, as spmm_csr.cu's: pieces per commit group, and in flight per
// thread (32 KB of shared memory)
constexpr int kFixupGroup = 8;
constexpr int kFixupDepth = 64;

// Pass 2: block b adds the pieces of the cut row that ends in tile b, if
// any (pass 1 wrote its index), in tile order: the tail piece of the tile where it starts, then the
// head pieces of the following tiles up to b (consecutive rows of the
// workspace), one column per thread, the head pieces streamed through a
// ring of kFixupDepth slots with cp.async, kFixupGroup to a commit group.
// Each thread reads back only the slots it filled, so no barrier is needed.
template <bool ACCUMULATE>
__global__ void __launch_bounds__(kThreads)
segment_reduce_fixup_kernel(const int32_t* __restrict__ rowptr,
                            const float* __restrict__ work,
                            float* __restrict__ out,
                            int64_t d, int64_t n_tiles, int64_t c_beg, int64_t c_end) {
  constexpr int Q = kFixupGroup;
  constexpr int DEPTH = kFixupDepth;
  constexpr int GROUPS = DEPTH / Q;
  __shared__ float ring[DEPTH][kThreads];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  // the cut row that ends in tile b, as pass 1 found it
  const int64_t r = reinterpret_cast<const int32_t*>(work + 2 * n_tiles * d)[b];
  if (r < 0) return;
  const int64_t t0 = rowptr[r] / kTileMessages;
  const int64_t count = b - t0;  // head pieces, tiles t0 + 1 .. b

  for (int64_t c = c_beg + t; c < c_end; c += kThreads) {
    float acc = 0.f;
    acc += work[(n_tiles + t0) * d + c];
    const float* src = work + (t0 + 1) * d + c;
    // piece i goes to slot i % DEPTH, in commit group i / Q; groups past
    // the row's end are empty, so that "all but the newest GROUPS - 1
    // groups" is always the group to add next
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      if (i < count) cp_async4(&ring[i][t], src + i * d);
      if (i % Q == Q - 1) cp_async_commit();
    }
    int slot = 0;  // i0 % DEPTH; Q divides DEPTH, so slot + q never wraps
    const float* next = src + DEPTH * d;  // the piece to load next
    for (int64_t i0 = 0; i0 < count; i0 += Q, slot = (slot + Q) % DEPTH) {
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
        if (i0 + DEPTH + q < count) cp_async4(&ring[slot + q][t], next);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    if constexpr (ACCUMULATE) {
      out[r * d + c] += acc;
    } else {
      out[r * d + c] = acc;
    }
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

// One call's arguments; out already at the window's first row.
template <typename M>
struct Problem {
  const int32_t* rowptr;
  const M* m;
  const bf16* wh;
  const bf16* wl;
  float* out;
  float* work;
  int64_t n, d, e;
};

template <typename M, int HALVES, int WMODE, bool ACCUMULATE, int COPY, int COLS>
int launch(const Problem<M>& p, int64_t grid, int64_t n_tiles, int64_t c_beg, int64_t c_end,
           int stage_bytes, int chunk, bool w_bulk, cudaStream_t stream) {
  auto kernel = segment_reduce_kernel<M, HALVES, WMODE, ACCUMULATE, COPY, COLS>;
  const int smem = pass1_smem(stage_bytes);
  // above 48 KB only when asked for; a refused launch shows only in
  // cudaGetLastError
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(p.rowptr, p.m, p.wh, p.wl, p.out, p.work, p.n, p.d,
                                                     p.e, n_tiles, c_beg, c_end, stage_bytes, chunk,
                                                     w_bulk);
  return (int)cudaGetLastError();
}

template <typename M, int HALVES, int WMODE, bool ACCUMULATE, int COPY>
int launch_cols(const Problem<M>& p, int64_t grid, int64_t n_tiles, int64_t c_beg, int64_t c_end,
                int stage_bytes, int chunk, bool w_bulk, cudaStream_t stream) {
  const int64_t width = c_end - c_beg;
#define SGL_LAUNCH(C) \
  launch<M, HALVES, WMODE, ACCUMULATE, COPY, C>(p, grid, n_tiles, c_beg, c_end, stage_bytes, chunk, w_bulk, stream)
  if (width <= kThreads) return SGL_LAUNCH(1);
  if (width <= 2 * kThreads) return SGL_LAUNCH(2);
  if (width <= 4 * kThreads) return SGL_LAUNCH(4);
  return SGL_LAUNCH(kColsMax);
#undef SGL_LAUNCH
}

template <typename M, int HALVES, int WMODE, bool ACCUMULATE>
int entry(const void* rowptr, const void* m, const void* wh, const void* wl, void* out, void* work,
          int64_t row_offset, int64_t n, int64_t d, int64_t e, void* stream_ptr) {
  const Problem<M> p{static_cast<const int32_t*>(rowptr), static_cast<const M*>(m),
                     static_cast<const bf16*>(wh), static_cast<const bf16*>(wl),
                     static_cast<float*>(out) + row_offset * d, static_cast<float*>(work), n, d, e};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t row_bytes = HALVES * d * (int64_t)sizeof(M);
  // past one column window, each window streams only its columns
  const bool windowed = d > kWindowCols;
  const bool bulk = !windowed && row_bytes % 16 == 0 && aligned(m, 16);
  const bool w_bulk = (WMODE < 1 || aligned(wh, 16)) && (WMODE < 2 || aligned(wl, 16));
  const int64_t n_tiles = (e + kTileMessages - 1) / kTileMessages;
  int64_t grid = n_tiles;
  if (!ACCUMULATE) {
    const int64_t fill = (n + kFillRows - 1) / kFillRows;
    grid = grid > fill ? grid : fill;
  }
  if (grid == 0) return 0;
  // column windows of kWindowCols (one for D <= 1024), each a launch of
  // pass 1 and of the fix-up (segment_reduce.py counts them so)
  for (int64_t c_beg = 0; c_beg < d; c_beg += kWindowCols) {
    const int64_t c_end = c_beg + kWindowCols < d ? c_beg + kWindowCols : d;
    // bytes of a message row in a stage: the row, or its window's part
    const int64_t slot = windowed ? HALVES * window_half_bytes(c_end - c_beg, (int)sizeof(M)) : row_bytes;
    int64_t chunk = kChunkBytes / slot;
    chunk = chunk < 1 ? 1 : (chunk > kTileMessages ? kTileMessages : chunk);
    // the kAsync path copies whole 16-byte words: up to 30 bytes more
    const int stage_bytes = (int)((chunk * slot + (bulk || windowed ? 0 : 32) + 127) / 128 * 128);
    int err = windowed ? launch<M, HALVES, WMODE, ACCUMULATE, kWindowed, kColsMax>(
                             p, grid, n_tiles, c_beg, c_end, stage_bytes, (int)chunk, w_bulk, stream)
              : bulk   ? launch_cols<M, HALVES, WMODE, ACCUMULATE, kBulk>(p, grid, n_tiles, c_beg, c_end,
                                                                        stage_bytes, (int)chunk, w_bulk, stream)
                       : launch_cols<M, HALVES, WMODE, ACCUMULATE, kAsync>(p, grid, n_tiles, c_beg, c_end,
                                                                         stage_bytes, (int)chunk, w_bulk, stream);
    if (err != 0) return err;
    if (n_tiles > 1) {
      segment_reduce_fixup_kernel<ACCUMULATE><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
          p.rowptr, p.work, p.out, d, n_tiles, c_beg, c_end);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}

}  // namespace

// One entry point per instantiation, all with the same arguments: rowptr
// int32 [n + 1]; m [>= e, HALVES*d]; wh, wl bf16 [>= e] (null where unused);
// out f32, written at rows [row_offset, row_offset + n) (row_offset is 0
// for the plain forms); work 4 * tiles * (2d + 1) bytes with tiles =
// ceil(e / kTileMessages) (unused, and may be null, for one tile); e =
// rowptr[n], the messages the rows name.
extern "C" {

#define SGL_SEGMENT_REDUCE(NAME, M, HALVES, WMODE, ACCUMULATE)                                      \
  int NAME(const void* rowptr, const void* m, const void* wh, const void* wl, void* out, void* work, \
           int64_t row_offset, int64_t n, int64_t d, int64_t e, void* stream) {                     \
    return entry<M, HALVES, WMODE, ACCUMULATE>(rowptr, m, wh, wl, out, work, row_offset, n, d, e,   \
                                               stream);                                              \
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
