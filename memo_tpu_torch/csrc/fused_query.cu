// Fused MEMO query for NVIDIA Hopper (sm_90a), read straight from the placed
// store's rows.
//
// Replaces the TPU function memo_tpu/ops/pallas_query.py::memo_query_pallas
// as a whole: its stream set-up (:270-293, which cuts the minus and plus
// event streams out of the store's rows, shadow-casts them and masks the
// dead ones) and its kernel body (_make_kernel, :100, handed to
// pl.pallas_call at :328). Same contract: window q is [qs, qs + L) at k, with
// candidate rows [mlo, mhi) in start order and [plo, phi) in end order
// (memo_tpu_torch/query/window.py::window_params finds them on the card);
// row i of a range is an event when it is live, end - start < k - 1 and
// 0 <= order < C:
//
//   minus stream: -1 in column order at window position start - qs
//   plus stream:  +1 in column order at window position end - qs - (k - 1)
//
// and the coverage cov[p][c] = prefix[q][c] + the events at positions <= p in
// column c is reduced in the kernel to conservation (first column with
// cov > 0, else n_docs; int32[Q, L]) or membership (1 - marked;
// int8[Q, L, C]). The store's rows are sorted by start (and, through the
// layout's permutation, by end) within a record, so the events of positions
// [p0, p1) are a contiguous run of rows, found in the kernel by a search.
//
// What bounds it on this card: a few integer operations per event and per
// (position, column), far below the compute roof, so bytes: each candidate
// row's start, end and order read once (12 bytes per event), plus the output
// written once (4 bytes per position, or C bytes for membership). At the
// headline (2 Mbp, C=16) that is 4,433,764 x 12 + 2,097,152 x 4 bytes.
//
// Three kernels carry the coverage across tiles of T positions, and no block
// waits on another:
//  - rows_net_kernel: per (tile, window), the tile's row bounds in both
//    streams (four warp-wide searches) and its net events per column;
//  - tile_scan_kernel: the carry into each tile, the prefix plus the scan of
//    the nets over the earlier tiles;
//  - rows_apply_kernel: per (tile, window), the tile's events scattered into
//    a shared diff tile, scanned from the carry and reduced to the output.
// Every row is read twice (net pass and apply pass), 24 bytes per event.
//
// What the design does about the faults of the three-pass stream kernel it
// replaces (kernel plus a stream set-up of some 25 torch operations):
//  1. Set-up over padded rows: there is none. The kernel reads the rows of
//     [mlo, mhi) and [plo, phi) where the store keeps them; no pos/val
//     streams, no pow2-padded M rows, no batch gather, no searchsorted.
//  2. Events read twice: still, once per pass. A single-pass carry (runs of
//     tiles per block with a decoupled look-back across runs) was measured
//     slower at every width and removed, and so was staging the apply pass's
//     rows in shared memory with cp.async (double-buffered rounds; each
//     round's block-wide barriers cost more than the overlap won). Each
//     thread loads its rows directly; the warps of a block wait on their
//     own loads only (PERF.md, section 6).
//  3. Bank conflicts in the conservation reduction: the tile is
//     cov[C][T + 1]. T is a multiple of 32, so column c's row starts at
//     bank (c * (T + 1)) % 32 = c % 32, and word (c, p) sits in bank
//     (c + p) % 32. Every warp access is conflict-free whatever C is (16,
//     90, 160, ...): the scan reads a column's 32 consecutive positions (32
//     banks); the membership write reads (c..c+31, p) with threads over c
//     (32 banks). Conservation reads the tile once: each warp scans its
//     columns in registers and keeps each position's first marked column
//     there, and one atomicMin per position and warp merges them.
//  4. Launches: one host-to-device copy of the parameters and prefix (the
//     wrapper's), then the three kernels; about 30 before.
//
// The store and the tile's scan and reduce live in tile.cuh, shared with v2
// (csrc/fused_query_v2.cu). A launch covers one column group of the store
// (tile.cuh says how) and at most kMaxGridY windows; the wrapper
// (memo_tpu_torch/ops/fused_query.py, launch_groups) launches wider stores
// and larger batches as groups.
//
// The launcher runs on the caller's stream, does not synchronise and does not
// allocate: the wrapper passes the scratch and the output.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;  // blockIdx.y carries the window
constexpr int kNetThreads = 128;  // rows_net_kernel: four warps, one search each
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;
static_assert(kScanWarps == 32, "the tile scan's second level is one warp wide");
static_assert(kNetThreads >= 128, "four warps search the row bounds");

// First row of [lo, hi) whose key is >= v, or hi (the keys are sorted on
// [lo, hi)). One warp: 32 probes cut the range into 33 parts a step, so a
// range of 4M rows takes 5 steps. Every lane returns the answer.
__device__ int warp_lower_bound(const int32_t* __restrict__ key, int lo, int hi, int v) {
  const int lane = threadIdx.x & 31;
  // Invariant: the answer lies in [lo, hi].
  while (lo < hi) {
    const long long n = hi - lo;
    const int probe = lo + static_cast<int>(n * (lane + 1) / 33);  // in [lo, hi)
    const int below = __popc(__ballot_sync(0xffffffffu, key[probe] < v));
    const int new_lo = below == 0 ? lo : lo + static_cast<int>(n * below / 33) + 1;
    hi = below == 32 ? hi : lo + static_cast<int>(n * (below + 1) / 33);
    lo = new_lo;
  }
  return lo;
}

// The rows of window positions [p0, p1): found[0..1] in the minus stream,
// found[2..3] in the plus stream. Warps 0-3 search one bound each; the caller
// synchronises before reading found.
__device__ void find_bounds(const Window& w, int p0, int p1, int* found) {
  const int warp = threadIdx.x >> 5;
  if (warp < 4) {
    const Stream& st = warp < 2 ? w.minus : w.plus;
    const int row = warp_lower_bound(st.key, st.lo, st.hi, st.shift + ((warp & 1) ? p1 : p0));
    if ((threadIdx.x & 31) == 0) found[warp] = row;
  }
}

// Add the live events of rows [lo, hi) at positions [base, base + T) into
// dst[c * S + (p - base) * P] (c within the column group [c0, c0 + C)): a
// diff tile with P = 1, per-column sums with S = 1 and P = 0. Reads the rows
// from device memory.
template <bool kPlus>
__device__ void scatter(const Stream& st, int lo, int hi, int base, int T, int k, int c0, int C,
                        int* dst, int S, int P) {
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int key = st.key[i];
    const int c = live_column<kPlus>(key, st.partner[i], st.order[i], k, c0, C);
    const int p = key - st.shift - base;
    if (c >= 0 && p >= 0 && p < T) atomicAdd(&dst[c * S + p * P], kPlus ? 1 : -1);
  }
}

// Reduce the scattered diff tile cov[C][T + 1] from carry[C] (first[T] all
// `none`) and write the output of its first `rows` positions from out_row
// (an index into out's Q * L positions; membership rows ld bytes apart,
// conservation plus c0, min-combined with out where c0 > 0). The caller has
// synchronised.
template <bool kMembership>
__device__ void finish_tile(int* cov, int* carry, int* first, int T, int C, int rows, int none,
                            void* out, size_t out_row, int ld, int c0) {
  const int S = T + 1;
  const int warp = threadIdx.x >> 5;
  if constexpr (kMembership) {
    scan_tile<kWarps>(cov, carry, T, S, C, warp);
    __syncthreads();
    reduce_membership<kWarps>(cov, S, C, rows, static_cast<int8_t*>(out) + out_row * ld, ld,
                              warp);
  } else {
    scan_conservation<kWarps>(cov, carry, first, T, S, C, none, warp);
    __syncthreads();
    int32_t* o = static_cast<int32_t*>(out) + out_row;
    for (int p = threadIdx.x; p < rows; p += blockDim.x) {
      o[p] = conservation_out(o[p], first[p], c0);
    }
  }
}

// One block per (tile, window): the tile's rows (minus lo, hi, plus lo, hi)
// into bounds[q, t, 4] and its net events per column into delta[q, c, t].
__global__ void __launch_bounds__(kNetThreads)
rows_net_kernel(Store store, const int32_t* __restrict__ params, int c0, int C, int T, int k,
                int32_t* __restrict__ bounds, int32_t* __restrict__ delta) {
  extern __shared__ int smem[];
  int* net = smem;       // [C]
  int* found = net + C;  // [4]
  const int t = blockIdx.x;
  const int q = blockIdx.y;
  const int nt = gridDim.x;
  const Window w = load_window(store, params, q, k);
  const int base = t * T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) net[c] = 0;
  find_bounds(w, base, base + T, found);
  __syncthreads();
  scatter<false>(w.minus, found[0], found[1], base, T, k, c0, C, net, 1, 0);
  scatter<true>(w.plus, found[2], found[3], base, T, k, c0, C, net, 1, 0);
  __syncthreads();
  const size_t tile = static_cast<size_t>(q) * nt + t;
  if (threadIdx.x < 4) bounds[tile * 4 + threadIdx.x] = found[threadIdx.x];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    delta[(static_cast<size_t>(q) * C + c) * nt + t] = net[c];
  }
}

// carry[q, c, t] = prefix[q * ld + c] + sum of delta[q, c, t'] over t' < t:
// one block per (column, window), reading and writing its row of tiles
// contiguously.
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(const int32_t* __restrict__ delta, const int32_t* __restrict__ prefix, int nt,
                 int C, int ld, int32_t* __restrict__ carry) {
  __shared__ int warp_sum[kScanWarps];
  const int c = blockIdx.x;
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (static_cast<size_t>(q) * C + c) * nt;
  int running = prefix[static_cast<size_t>(q) * ld + c];
  for (int first = 0; first < nt; first += kScanThreads) {
    const int t = first + threadIdx.x;
    const int v = t < nt ? delta[row + t] : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the 32 warp totals
      int s = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    if (t < nt) carry[row + t] = running + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    running += warp_sum[kScanWarps - 1];
    __syncthreads();  // warp_sum is rewritten by the next round
  }
}

// One block per (tile, window): the tile applied from its carry.
template <bool kMembership>
__global__ void __launch_bounds__(kThreads)
rows_apply_kernel(Store store, const int32_t* __restrict__ params,
                  const int32_t* __restrict__ bounds, const int32_t* __restrict__ tile_carry,
                  int L, int c0, int C, int ld, int T, int k, int none, void* __restrict__ out) {
  extern __shared__ int smem[];
  int* cov = smem;                 // [C][T + 1]
  int* carry = cov + C * (T + 1);  // [C]
  int* first = carry + C;          // [T]
  const int t = blockIdx.x;
  const int q = blockIdx.y;
  const int nt = gridDim.x;
  const Window w = load_window(store, params, q, k);
  const int32_t* b = bounds + (static_cast<size_t>(q) * nt + t) * 4;
  const int base = t * T;
  for (int i = threadIdx.x; i < C * (T + 1); i += blockDim.x) cov[i] = 0;
  for (int p = threadIdx.x; p < T; p += blockDim.x) first[p] = none;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    carry[c] = tile_carry[(static_cast<size_t>(q) * C + c) * nt + t];
  }
  __syncthreads();
  scatter<false>(w.minus, b[0], b[1], base, T, k, c0, C, cov, T + 1, 1);
  scatter<true>(w.plus, b[2], b[3], base, T, k, c0, C, cov, T + 1, 1);
  __syncthreads();
  finish_tile<kMembership>(cov, carry, first, T, C, min(T, L - base), none, out,
                           static_cast<size_t>(q) * L + base, ld, c0);
}

template <bool kMembership>
cudaError_t launch_apply(dim3 grid, size_t smem, cudaStream_t stream, const Store& store,
                         const int32_t* params, const int32_t* bounds, const int32_t* carry,
                         int L, int c0, int C, int ld, int T, int k, int none, void* out) {
  const cudaError_t err = cudaFuncSetAttribute(rows_apply_kernel<kMembership>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rows_apply_kernel<kMembership><<<grid, kThreads, smem, stream>>>(store, params, bounds, carry, L,
                                                                   c0, C, ld, T, k, none, out);
  return cudaGetLastError();
}

}  // namespace

// Query Q windows of L positions on `stream` from the placed store's six
// row arrays (n_rows rows each), over the store's columns [c0, c0 + G) of
// its C. params is int32[Q, 5] (mlo, mhi, plo, phi, qs per window), prefix
// int32[Q, C], out int32[Q, L] (conservation: c0 plus the group's first
// marked column, or n_docs, min-combined with out where c0 > 0) or
// int8[Q, L, C] (membership: columns [c0, c0 + G) written); scratch holds Q * nt * (4 + 2 * G) int32 words with
// nt = ceil(L / tile). Returns the CUDA error code of the first call that
// failed, 0 when all were accepted.
extern "C" int memo_fused_query_rows(const int32_t* start, const int32_t* end,
                                     const int32_t* order, const int32_t* end_s,
                                     const int32_t* start_by_end, const int32_t* order_by_end,
                                     const int32_t* params, const int32_t* prefix,
                                     int32_t* scratch, void* out, int n_rows, int Q, int L, int C,
                                     int c0, int G, int k, int tile, int n_docs, int membership,
                                     void* stream) {
  if (n_rows < 0 || Q < 1 || Q > kMaxGridY || L < 1 || c0 < 0 || G < 1 || c0 + G > C || k < 1 ||
      tile < 32 || tile % 32 != 0 || tile > 32 * kMaxChunks) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Store store{start, end, order, end_s, start_by_end, order_by_end, n_rows};
  const int T = tile;
  const int nt = (L + T - 1) / T;
  const size_t tiles = static_cast<size_t>(Q) * nt;
  int32_t* bounds = scratch;            // [Q, nt, 4]
  int32_t* delta = bounds + tiles * 4;  // [Q, G, nt]
  int32_t* carry = delta + tiles * G;   // [Q, G, nt]
  const dim3 grid(nt, Q);
  rows_net_kernel<<<grid, kNetThreads, (G + 4) * sizeof(int), s>>>(store, params, c0, G, T, k,
                                                                   bounds, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan_kernel<<<dim3(G, Q), kScanThreads, 0, s>>>(delta, prefix + c0, nt, G, C, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (static_cast<size_t>(G) * (T + 1) + G + T) * sizeof(int);
  const int none = n_docs - c0;
  if (membership) {
    return launch_apply<true>(grid, smem, s, store, params, bounds, carry, L, c0, G, C, T, k,
                              none, static_cast<int8_t*>(out) + c0);
  }
  return launch_apply<false>(grid, smem, s, store, params, bounds, carry, L, c0, G, C, T, k, none,
                             out);
}

extern "C" const char* memo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
