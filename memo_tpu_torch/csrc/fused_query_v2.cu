// Fused MEMO query, v2: one pass over the events, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel memo_tpu/ops/pallas_query_v2.py::_make_kernel_v2
// (the body that memo_query_pallas_v2 hands to pl.pallas_call), the variant
// for dense windows with tens of events per position. Same contract as v1
// (csrc/fused_query.cu) and the same event streams (event_streams.cuh): the
// coverage cov[p, c] = prefix[c] + sum of the events at positions <= p in
// column c, reduced to conservation (int32[Q, L]) or membership
// (int8[Q, L, C]).
//
// One pass: v1 reads every event twice (its delta pass and its apply pass).
// Here one block per (tile of T positions, window) reads its events once:
//   1. it scatters them with shared-memory atomics into a diff tile;
//   2. it scans the tile along positions, which gives its per-column net in
//      the last position, and publishes that net (the tile's aggregate);
//   3. it gets the coverage entering the tile (its carry) by a decoupled
//      look-back over the earlier tiles of its window: each tile publishes a
//      status word and, in a scratch the wrapper zeroes, aggregate[C] and
//      inclusive[C] (= carry + aggregate). Walking back, a block adds the
//      aggregates of tiles that have only those and stops at the first
//      inclusive; tile 0 starts from prefix[q] and publishes its inclusive
//      at once. This is the Hopper counterpart of v2's in-order carry scratch
//      on the TPU (pallas_query_v2.py:118-127, :269);
//   4. it reduces coverage + carry to the output.
// The tile index comes from an atomic ticket per window, not from blockIdx.x:
// a block that waits on tile t - 1 waits on a block that drew its ticket
// before, so is already running, and the look-back cannot deadlock whatever
// order the hardware starts blocks in. Statuses are published with a fence
// and a release store after the sums, and read with acquire loads.
//
// Layout: the tile is transposed as on the TPU (pallas_query_v2.py:14-18),
// int32 cov[C][T + 1], columns on the slow axis. A warp's events sit at
// nearly one position in random columns; with a row stride of T + 1 (T is a
// multiple of 32) their addresses fall in distinct banks, where a stride of T
// would put them all in one. Each column is scanned along its contiguous
// positions by one warp with shuffles, and the conservation reduction reads
// cov[c][p] with threads over p, free of bank conflicts.
//
// What it does not copy: the TPU kernel's band/full fold split
// (pallas_query_v2.py:26-43, :175-263) exists because a step fold on the TPU
// costs T x E operand work per event row. In the diff form every event costs
// one shared-memory add whatever its span, so there is nothing to split.
// What bounds it: the event bytes (pos + val read once: 8 bytes per event,
// half of v1's 16) plus the output, then the shared-memory atomics of dense
// windows. T is the widest of 256/128/64 whose tile fits the 227 KB a block
// may use (fused_query_v2.py::kernel_constants_v2 picks it).
//
// The launcher runs on the caller's stream, does not synchronise and does not
// allocate: the wrapper passes the zeroed status/ticket words, the sums
// scratch and the output.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "event_streams.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;  // blockIdx.y carries the window
constexpr int kNotReady = 0;      // status words: nothing published yet,
constexpr int kAggregate = 1;     // aggregate[C] published,
constexpr int kInclusive = 2;     // inclusive[C] published

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// Make this block's writes to `sums` visible, then set the tile's status.
__device__ __forceinline__ void publish(int* status, int flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(status, flag);
}

template <bool kMembership>
__global__ void __launch_bounds__(kThreads)
fused_query_v2_kernel(EventStreams streams, const int32_t* __restrict__ prefix,
                      int* __restrict__ status, int* __restrict__ ticket,
                      int32_t* __restrict__ sums, int L, int C, int T, int n_docs,
                      void* __restrict__ out) {
  extern __shared__ int smem[];
  const int stride = T + 1;
  int* cov = smem;                // [C][T + 1]: event diff, then in-tile coverage
  int* carry = smem + C * stride;  // [C]: coverage entering the tile
  int* drawn = carry + C;          // [1]: this block's ticket
  const int q = blockIdx.y;
  const EventStreams s = streams.window(q);
  const int nt = s.nt;

  if (threadIdx.x == 0) *drawn = atomicAdd(&ticket[q], 1);
  for (int i = threadIdx.x; i < C * stride; i += blockDim.x) cov[i] = 0;
  __syncthreads();
  const int t = *drawn;
  const int base = t * T;

  // 1. Scatter the tile's events.
  for (int i = s.off_m[t] + threadIdx.x; i < s.off_m[t + 1]; i += blockDim.x) {
    const int v = s.val_m[i];
    const int p = s.pos_m[i] - base;
    if (live_event(v, p, T, C)) atomicSub(&cov[(v - 1) * stride + p], 1);
  }
  for (int i = s.off_p[t] + threadIdx.x; i < s.off_p[t + 1]; i += blockDim.x) {
    const int v = s.val_p[i];
    const int p = s.pos_p[i] - base;
    if (live_event(v, p, T, C)) atomicAdd(&cov[(v - 1) * stride + p], 1);
  }
  __syncthreads();

  // 2. Inclusive scan of each column along its T positions: one warp per
  // column, 32 positions per step.
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < C; c += kWarps) {
    int* row = cov + c * stride;
    int run = 0;
    for (int p0 = 0; p0 < T; p0 += 32) {
      int x = row[p0 + lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      x += run;
      row[p0 + lane] = x;
      run = __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();

  // 3. Publish, look back, publish the inclusive sums.
  const size_t tile_id = static_cast<size_t>(q) * nt + t;
  int32_t* aggregate = sums + tile_id * 2 * C;
  int32_t* inclusive = aggregate + C;
  const int32_t* window_prefix = prefix + static_cast<size_t>(q) * C;
  if (t == 0) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      carry[c] = window_prefix[c];
      inclusive[c] = window_prefix[c] + cov[c * stride + T - 1];
    }
    publish(&status[tile_id], kInclusive);
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x) aggregate[c] = cov[c * stride + T - 1];
    publish(&status[tile_id], kAggregate);
    // Each thread walks back for its own columns and acquires each status
    // itself before it reads the sums that the status covers.
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      int acc = 0;
      for (int pred = t - 1;; --pred) {
        const size_t pred_id = static_cast<size_t>(q) * nt + pred;
        int flag;
        while ((flag = load_acquire(&status[pred_id])) == kNotReady) __nanosleep(32);
        const int32_t* pred_sums = sums + pred_id * 2 * C;
        if (flag == kInclusive) {
          acc += __ldcg(pred_sums + C + c);
          break;
        }
        acc += __ldcg(pred_sums + c);
      }
      carry[c] = acc;
      inclusive[c] = acc + cov[c * stride + T - 1];
    }
    publish(&status[tile_id], kInclusive);
  }
  __syncthreads();

  // 4. Reduce coverage + carry to the output.
  const int rows = min(T, L - base);
  const size_t first_row = static_cast<size_t>(q) * L + base;
  if constexpr (kMembership) {
    int8_t* o = static_cast<int8_t*>(out) + first_row * C;
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int p = i / C;
      const int c = i - p * C;
      o[i] = cov[c * stride + p] + carry[c] > 0 ? 0 : 1;
    }
  } else {
    int32_t* o = static_cast<int32_t*>(out) + first_row;
    for (int p = threadIdx.x; p < rows; p += blockDim.x) {
      int first = n_docs;
      for (int c = 0; c < C; ++c) {
        if (cov[c * stride + p] + carry[c] > 0) {
          first = c;
          break;
        }
      }
      o[p] = first < n_docs ? first : n_docs;
    }
  }
}

template <bool kMembership>
cudaError_t launch(const EventStreams& streams, const int32_t* prefix, int* status, int* ticket,
                   int32_t* sums, void* out, int Q, int L, int C, int T, int n_docs,
                   cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(C) * (T + 2) + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(fused_query_v2_kernel<kMembership>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_query_v2_kernel<kMembership><<<dim3(streams.nt, Q), kThreads, smem, stream>>>(
      streams, prefix, status, ticket, sums, L, C, T, n_docs, out);
  return cudaGetLastError();
}

}  // namespace

// Launch the one-pass kernel for Q windows on `stream`. The streams are laid
// out as event_streams.cuh says; `state` is int32[Q * nt + Q], zeroed by the
// caller on this stream (the tiles' status words, then one ticket per
// window); `sums` is int32[Q, nt, 2, C] scratch (aggregate, inclusive); out is
// int32[Q, L] or int8[Q, L, C]. Returns the CUDA error code of the launch, 0
// when it was accepted.
extern "C" int memo_fused_query_v2(const int32_t* pos_m, const int32_t* val_m,
                                   const int32_t* off_m, const int32_t* pos_p,
                                   const int32_t* val_p, const int32_t* off_p,
                                   const int32_t* prefix, int32_t* state, int32_t* sums,
                                   void* out, int Q, int m_stride, int p_stride, int L, int C,
                                   int tile, int n_docs, int membership, void* stream) {
  if (Q < 1 || Q > kMaxGridY || L < 1 || C < 1 || tile < 32 || tile % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (L + tile - 1) / tile;
  const EventStreams streams{pos_m, val_m, off_m, pos_p, val_p, off_p, m_stride, p_stride, nt};
  int* status = state;
  int* ticket = state + static_cast<size_t>(Q) * nt;
  if (membership) {
    return launch<true>(streams, prefix, status, ticket, sums, out, Q, L, C, tile, n_docs, s);
  }
  return launch<false>(streams, prefix, status, ticket, sums, out, Q, L, C, tile, n_docs, s);
}
