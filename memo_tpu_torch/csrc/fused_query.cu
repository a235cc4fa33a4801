// Fused MEMO query over a batch of windows for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel memo_tpu/ops/pallas_query.py::_make_kernel (the
// body that memo_query_pallas hands to pl.pallas_call, which memo_tpu runs
// once per window, and in a fori_loop over windows for a batch). Same
// contract: two pre-sorted event streams per window [qs, qs+L) at k, as built
// by memo_tpu_torch/ops/fused_query.py::prepare_streams,
//
//   minus stream: -1 at st = start - qs      (start order)
//   plus stream:  +1 at ce = end - qs - (k-1) (end order)
//   val = column + 1 for live events, 0 for inert ones,
//
// give the coverage cov[p, c] = prefix[c] + sum of the events at positions
// <= p in column c. It is reduced in the kernel to conservation (first column
// with cov > 0, else n_docs; int32[L]) or membership (1 - marked; int8[L, C]).
// A batch of Q windows runs at one L (the longest); blockIdx.y is the window,
// so the whole batch is one launch of each pass.
//
// Why three passes: the TPU walks its grid in order and carries the running
// coverage from one tile to the next in VMEM scratch. Blocks here run in
// parallel and in no order, so the carry comes from a scan instead:
//   1. tile_delta_kernel: one block per (tile of T positions, window) sums
//      the net per-column events of its [off[t], off[t+1]) ranges into
//      delta[q, t, C];
//   2. tile_scan_kernel: one block per (column, window) scans delta over
//      tiles, starting from prefix[q], into carry[q, t, C] (exclusive);
//   3. tile_apply_kernel: one block per (tile, window) scatters its events
//      with shared-memory atomics into a T x C diff tile, scans it over the T
//      positions from carry[q, t], and writes the reduced output. The
//      coverage never goes to device memory.
//
// What bounds it on this card: it does a few integer operations per event and
// per (position, column), far below the compute roof, so it is bound by bytes:
// the event streams read (pos + val in passes 1 and 3: 16 bytes per event)
// plus the output written (4 bytes per position, or C bytes per
// position for membership). delta and carry are Q * nt * C int32 each, small
// next to the streams. Where events are dense (tens per position at pangenome
// widths), the shared-memory atomics of pass 3 are the next limit; they stay in
// shared memory, spread over T * C addresses, and never touch device memory.
// The tile T is the widest of 256/128/64 whose T x C int32 tile fits the
// 227 KB a block may use (fused_query.py::kernel_constants picks it).
//
// The launcher runs on the caller's stream, does not synchronise and does not
// allocate: the wrapper passes delta, carry and the output.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "event_streams.cuh"

namespace {

constexpr int kSeg = 16;  // positions per scan segment in the apply pass
constexpr int kDeltaThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kMaxGridY = 65535;  // blockIdx.y carries the window
static_assert(kScanWarps == 32, "the scan's second level is one warp wide");

__global__ void __launch_bounds__(kDeltaThreads)
tile_delta_kernel(EventStreams streams, int T, int C, int32_t* __restrict__ delta) {
  extern __shared__ int net[];  // [C]
  const int t = blockIdx.x;
  const int q = blockIdx.y;
  const EventStreams s = streams.window(q);
  const int base = t * T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) net[c] = 0;
  __syncthreads();
  for (int i = s.off_m[t] + threadIdx.x; i < s.off_m[t + 1]; i += blockDim.x) {
    const int v = s.val_m[i];
    if (live_event(v, s.pos_m[i] - base, T, C)) atomicSub(&net[v - 1], 1);
  }
  for (int i = s.off_p[t] + threadIdx.x; i < s.off_p[t + 1]; i += blockDim.x) {
    const int v = s.val_p[i];
    if (live_event(v, s.pos_p[i] - base, T, C)) atomicAdd(&net[v - 1], 1);
  }
  __syncthreads();
  int32_t* d = delta + (static_cast<size_t>(q) * s.nt + t) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) d[c] = net[c];
}

__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(const int32_t* __restrict__ delta, const int32_t* __restrict__ prefix, int nt,
                 int C, int32_t* __restrict__ carry) {
  __shared__ int warp_sum[kScanWarps];
  const int c = blockIdx.x;
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t window = static_cast<size_t>(q) * nt * C;
  int running = prefix[static_cast<size_t>(q) * C + c];
  for (int first = 0; first < nt; first += kScanThreads) {
    const int t = first + threadIdx.x;
    const int v = t < nt ? delta[window + static_cast<size_t>(t) * C + c] : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the 32 warp totals
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    if (t < nt) {
      carry[window + static_cast<size_t>(t) * C + c] =
          running + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    }
    running += warp_sum[kScanWarps - 1];
    __syncthreads();  // warp_sum is rewritten by the next round
  }
}

template <bool kMembership>
__global__ void __launch_bounds__(kApplyThreads)
tile_apply_kernel(EventStreams streams, const int32_t* __restrict__ carry, int L, int C, int T,
                  int n_docs, void* __restrict__ out) {
  extern __shared__ int smem[];
  int* cov = smem;          // [T][C]: event diff, then coverage
  int* seg = smem + T * C;  // [T / kSeg][C]: segment sums, then segment carries
  const int S = T / kSeg;
  const int t = blockIdx.x;
  const int q = blockIdx.y;
  const EventStreams s = streams.window(q);
  const int base = t * T;

  for (int i = threadIdx.x; i < T * C; i += blockDim.x) cov[i] = 0;
  __syncthreads();
  for (int i = s.off_m[t] + threadIdx.x; i < s.off_m[t + 1]; i += blockDim.x) {
    const int v = s.val_m[i];
    const int p = s.pos_m[i] - base;
    if (live_event(v, p, T, C)) atomicSub(&cov[p * C + v - 1], 1);
  }
  for (int i = s.off_p[t] + threadIdx.x; i < s.off_p[t + 1]; i += blockDim.x) {
    const int v = s.val_p[i];
    const int p = s.pos_p[i] - base;
    if (live_event(v, p, T, C)) atomicAdd(&cov[p * C + v - 1], 1);
  }
  __syncthreads();

  // Column-wise scan over T positions in two levels: each (segment, column)
  // item sums kSeg positions, one thread per column scans the T / kSeg
  // segment sums from carry[q, t], then each item rescans its segment. Items
  // with consecutive columns sit on consecutive banks.
  for (int w = threadIdx.x; w < S * C; w += blockDim.x) {
    const int* col = cov + (w / C) * kSeg * C + (w % C);
    int acc = 0;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) acc += col[j * C];
    seg[w] = acc;
  }
  __syncthreads();
  const int32_t* tile_carry = carry + (static_cast<size_t>(q) * s.nt + t) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int run = tile_carry[c];
    for (int j = 0; j < S; ++j) {
      const int v = seg[j * C + c];
      seg[j * C + c] = run;
      run += v;
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < S * C; w += blockDim.x) {
    int* col = cov + (w / C) * kSeg * C + (w % C);
    int run = seg[w];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      run += col[j * C];
      col[j * C] = run;
    }
  }
  __syncthreads();

  const int rows = min(T, L - base);
  const size_t first_row = static_cast<size_t>(q) * L + base;
  if constexpr (kMembership) {
    int8_t* o = static_cast<int8_t*>(out) + first_row * C;
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) o[i] = cov[i] > 0 ? 0 : 1;
  } else {
    int32_t* o = static_cast<int32_t*>(out) + first_row;
    for (int p = threadIdx.x; p < rows; p += blockDim.x) {
      const int* row = cov + p * C;
      int first = n_docs;
      for (int c = 0; c < C; ++c) {
        if (row[c] > 0) {
          first = c;
          break;
        }
      }
      o[p] = first < n_docs ? first : n_docs;
    }
  }
}

template <bool kMembership>
cudaError_t launch_apply(const EventStreams& streams, const int32_t* carry, void* out, int Q,
                         int L, int C, int T, int n_docs, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(T + T / kSeg) * C * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(tile_apply_kernel<kMembership>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tile_apply_kernel<kMembership><<<dim3(streams.nt, Q), kApplyThreads, smem, stream>>>(
      streams, carry, L, C, T, n_docs, out);
  return cudaGetLastError();
}

}  // namespace

// Launch the three passes for Q windows on `stream`. Window q's streams hold
// m_stride (minus) and p_stride (plus) events from row q, its offsets nt + 1
// entries with nt = ceil(L / tile), its prefix C entries. delta and carry are
// int32[Q, nt, C] scratch; out is int32[Q, L] (conservation) or int8[Q, L, C]
// (membership). Returns the CUDA error code of the first launch that failed,
// 0 when all three were accepted.
extern "C" int memo_fused_query(const int32_t* pos_m, const int32_t* val_m, const int32_t* off_m,
                                const int32_t* pos_p, const int32_t* val_p, const int32_t* off_p,
                                const int32_t* prefix, int32_t* delta, int32_t* carry, void* out,
                                int Q, int m_stride, int p_stride, int L, int C, int tile,
                                int n_docs, int membership, void* stream) {
  if (Q < 1 || Q > kMaxGridY || L < 1 || C < 1 || tile < kSeg || tile % kSeg != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (L + tile - 1) / tile;
  const EventStreams streams{pos_m, val_m, off_m, pos_p, val_p, off_p, m_stride, p_stride, nt};

  tile_delta_kernel<<<dim3(nt, Q), kDeltaThreads, C * sizeof(int), s>>>(streams, tile, C, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan_kernel<<<dim3(C, Q), kScanThreads, 0, s>>>(delta, prefix, nt, C, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (membership) return launch_apply<true>(streams, carry, out, Q, L, C, tile, n_docs, s);
  return launch_apply<false>(streams, carry, out, Q, L, C, tile, n_docs, s);
}

extern "C" const char* memo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
