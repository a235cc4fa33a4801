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
// Three passes carry the coverage across tiles of T positions, and no block
// waits on another:
//  - rows_net_kernel: per (tile, window), the tile's row bounds in both
//    streams (four warp-wide searches) and its net events per column;
//  - tile_scan_kernel: the carry into each tile, the prefix plus the scan of
//    the nets over the earlier tiles;
//  - the apply: each tile's events from its carry, reduced to the output.
//    rows_apply_kernel, a block per (tile, window), scatters them into a
//    shared diff tile and scans it; a conservation launch may split its
//    tiles between two kernels instead, each looping over its own (below).
// Every row is read twice (net pass and apply pass), 24 bytes per event.
//
// What bounds the conservation apply, and what the design does about it.
// Finished densely, a tile costs G x T whatever its events: a [G][T + 1]
// tile zeroed, the events scattered, every column shuffle-scanned, and at
// G = 90, T = 256, 94 KB of shared memory a block, two blocks an SM. A
// chromosome's tile holds some 9 live events, an MHC tile some 1,500
// (PERF.md, section 6, with the phases' times). So where a launch splits
// its tiles (split_of), the scan pass lists each tile for the path its
// candidate rows (b[1] - b[0] + b[3] - b[2], from the net pass) choose, and
// each path's kernel takes its own list in even shares, no block launched
// for the other's tiles:
//  - event_apply_kernel, at most kEventRows rows: one warp a tile, 17.8 KB
//    of shared memory at G = 90. The carry gives each column's count and the
//    mask of positive columns; the live events are counting-sorted by
//    position and walked 32 at a time: each event's count from its column's
//    and the earlier events of its column (a match and two ballots), the
//    mask after each event by an XOR scan of the flips, the first positive
//    column from it. A position's answer is the one after the last event at
//    or before it. Work in proportion to (events / 32) x (G / 32) + T.
//  - dense_apply_kernel, the other tiles: the dense finish, one block a
//    tile, as many blocks as fit the card at once.
// Where the split pays depends on what a launch has: the dense finish costs
// in proportion to G, an event tile in proportion to its rows, and the
// event path needs a tile for each of the card's event warps to be worth
// one tile's time on one warp. split_of decides from G, the tile count and
// the card's occupancy, with the costs a sweep on the card measured
// (PERF.md, section 6); a launch that does not split, such as one of few
// tiles or of few columns, runs rows_apply_kernel (ragged_apply_kernel) as
// membership does. A tile's events fit a warp's shared words up to
// kEventRows rows, the largest budget at which the event path still beat
// the dense one on the MHC's tiles at 12 warps an SM.
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
// A ragged batch (windows of different lengths, given as int64 output
// offsets) would waste most of a uniform launch: a gene batch's longest
// window is 50 times its median, so a grid of nt x Q tiles runs 25 tiles for
// each one that answers, and writes 25 positions for each one kept. Its
// launch instead walks one flat list of the windows' own tiles (tile.cuh): a
// small kernel, one block a window, writes each tile's place (window, tile,
// positions, the window's start) into a table; the net and apply kernels run
// one block a tile of the list and start from its place, one load, as the
// uniform kernels start from blockIdx (blocks that first had to find their
// window, or load its parameters through it, measured slower a tile,
// PERF.md); the scan takes each window's own tiles; each tile writes
// min(T, len - base) positions at its window's offset of one packed output.
// Uniform launches (no offsets) keep the nt x Q grid and kernels.
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

#include <mutex>

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

__device__ __forceinline__ void zero_counts(int32_t* counts, int32_t* event_count) {
  if (threadIdx.x < 2) counts[threadIdx.x] = 0;
  if (threadIdx.x == 2 && event_count != nullptr) *event_count = 0;
}

// One block per (tile, window): the tile's rows (minus lo, hi, plus lo, hi)
// into bounds[q, t, 4] and its net events per column into delta[q, c, t].
// The first block zeroes the counts of the conservation apply's lists, and
// event_count (where not null), which the event path sets where it runs.
__global__ void __launch_bounds__(kNetThreads)
rows_net_kernel(Store store, const int32_t* __restrict__ params, int c0, int C, int T, int k,
                int32_t* __restrict__ bounds, int32_t* __restrict__ delta, int32_t* counts,
                int32_t* event_count) {
  extern __shared__ int smem[];
  int* net = smem;       // [C]
  int* found = net + C;  // [4]
  const int t = blockIdx.x;
  const int q = blockIdx.y;
  const int nt = gridDim.x;
  if (t == 0 && q == 0) zero_counts(counts, event_count);
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

// Exclusive scan of one row of n tile nets from `running` into carry_row:
// the rounds of one block of kScanThreads threads.
__device__ __forceinline__ void scan_row(const int32_t* __restrict__ delta_row, int n, int running,
                                         int32_t* __restrict__ carry_row, int* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int first = 0; first < n; first += kScanThreads) {
    const int t = first + threadIdx.x;
    const int v = t < n ? delta_row[t] : 0;
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
    if (t < n) carry_row[t] = running + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    running += warp_sum[kScanWarps - 1];
    __syncthreads();  // warp_sum is rewritten by the next round
  }
}

// The conservation apply's two paths (the header says why): in a launch
// that splits its tiles (split_of), a tile of at most kEventRows candidate
// rows may take the event path; the words of one event tile hold that many.
constexpr int kEventRows = 2048;
constexpr int kEventWarps = 4;
constexpr int kEventThreads = kEventWarps * 32;
static_assert(kEventRows < 4096, "an event's rank within its position fits 12 bits");

// Tile i (where `valid`) listed for its path by its candidate rows, at
// most rows_max for the event path: the event path's from the front of
// list[tiles], counted in counts[0], the dense path's from the back, counted
// in counts[1]. Every lane of the warp calls it.
__device__ void list_tile(bool valid, int i, const int32_t* __restrict__ bounds, int32_t* list,
                          int32_t* counts, int tiles, int rows_max) {
  const int lane = threadIdx.x & 31;
  bool events = false;
  if (valid) {
    const int4 b = reinterpret_cast<const int4*>(bounds)[i];
    events = b.y - b.x + b.w - b.z <= rows_max;
  }
  const unsigned to_events = __ballot_sync(0xffffffffu, valid && events);
  const unsigned to_dense = __ballot_sync(0xffffffffu, valid && !events);
  int at_events = 0;
  int at_dense = 0;
  if (lane == 0 && to_events) at_events = atomicAdd(&counts[0], __popc(to_events));
  if (lane == 0 && to_dense) at_dense = atomicAdd(&counts[1], __popc(to_dense));
  at_events = __shfl_sync(0xffffffffu, at_events, 0);
  at_dense = __shfl_sync(0xffffffffu, at_dense, 0);
  const unsigned below = (1u << lane) - 1;
  if (valid && events) list[at_events + __popc(to_events & below)] = i;
  if (valid && !events) list[tiles - 1 - at_dense - __popc(to_dense & below)] = i;
}

// Lists a window's n tiles, first .. first + n - 1, for a conservation
// launch that splits them (list not null): the window's blocks take kScanThreads consecutive
// tiles each, a warp's 32 at a time, so a warp makes at most one atomic a
// list.
__device__ __forceinline__ void list_tiles(int first, int n, const int32_t* bounds, int32_t* list,
                                           int32_t* counts, int tiles, int rows_max) {
  if (list == nullptr) return;
  for (int t0 = blockIdx.x * blockDim.x; t0 < n; t0 += gridDim.x * blockDim.x) {
    const int t = t0 + threadIdx.x;
    list_tile(t < n, first + t, bounds, list, counts, tiles, rows_max);
  }
}

// carry[q, c, t] = prefix[q * ld + c] + sum of delta[q, c, t'] over t' < t:
// one block per (column, window), reading and writing its row of tiles
// contiguously. In a launch that splits its tiles, the blocks of window q
// also list its tiles for the apply (list_tiles).
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(const int32_t* __restrict__ delta, const int32_t* __restrict__ prefix, int nt,
                 int C, int ld, int32_t* __restrict__ carry, const int32_t* __restrict__ bounds,
                 int32_t* list, int32_t* counts, int rows_max) {
  __shared__ int warp_sum[kScanWarps];
  const int c = blockIdx.x;
  const int q = blockIdx.y;
  const size_t row = (static_cast<size_t>(q) * C + c) * nt;
  scan_row(delta + row, nt, prefix[static_cast<size_t>(q) * ld + c], carry + row, warp_sum);
  list_tiles(q * nt, nt, bounds, list, counts, gridDim.y * nt, rows_max);
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

// The conservation apply (the header says why two kernels). A launch's
// tiles are numbered 0 .. tiles - 1: uniform, tile t of window q is
// q * nt + t; ragged, a unit of the flat list (a spare unit is listed for
// neither path).

struct ApplyTiles {
  Store store;
  const int32_t* params;  // uniform: the windows' parameters
  const int4* place;      // ragged: each unit's place
  const int64_t* off;     // ragged: the output offsets
  const int32_t* bounds;  // [tiles, 4]
  const int32_t* carry;   // uniform [Q, G, nt]; ragged [G, units]
  int32_t* out;
  const int32_t* list;    // [tiles]: the event path's tiles from the front, the dense
                          // path's from the back (list_tile)
  const int32_t* counts;  // [2]: how many of each
  int32_t* event_count;   // null, or where the event path's count is copied
  int tiles, nt, L, c0, G, T, k, none;
  int min_events;  // the event path runs where at least this many tiles were listed for it
};

// One tile of a conservation launch: its two streams over the tile's rows,
// its carry (column c at carry[c * stride]), its first position and
// positions, and where they are written.
struct Tile {
  Stream minus;
  Stream plus;
  const int32_t* carry;
  size_t stride;
  int base;
  int rows;
  int32_t* out;
};

template <bool kRagged>
__device__ __forceinline__ Tile tile_at(const ApplyTiles& a, int i) {
  Tile tile;
  if constexpr (kRagged) {
    const int4 at = a.place[i];
    const Store& s = a.store;
    tile.minus = Stream{s.start, s.end, s.order, 0, 0, at.w};
    tile.plus = Stream{s.end_s, s.start_by_end, s.order_by_end, 0, 0, at.w + a.k - 1};
    tile.carry = a.carry + i;
    tile.stride = a.tiles;
    tile.base = at.y * a.T;
    tile.rows = at.z;
    tile.out = a.out + (a.off[at.x] - a.off[0]) + tile.base;
  } else {
    const int q = i / a.nt;
    const int t = i - q * a.nt;
    const Window w = load_window(a.store, a.params, q, a.k);
    tile.minus = w.minus;
    tile.plus = w.plus;
    tile.carry = a.carry + static_cast<size_t>(q) * a.G * a.nt + t;
    tile.stride = a.nt;
    tile.base = t * a.T;
    tile.rows = min(a.T, a.L - tile.base);
    tile.out = a.out + static_cast<size_t>(q) * a.L + tile.base;
  }
  const int4 b = reinterpret_cast<const int4*>(a.bounds)[i];
  tile.minus.lo = b.x;
  tile.minus.hi = b.y;
  tile.plus.lo = b.z;
  tile.plus.hi = b.w;
  return tile;
}

// Shared words of one warp of event_apply_kernel.
__host__ __device__ constexpr int event_words(int T, int G) {
  return T + 1 + 2 * kEventRows + G + (G + 31) / 32;
}

// The live events of rows [st.lo, st.hi) in the tile from `base`, appended
// to ev from E in row order (so by position), each with its rank among the
// events of its position, counted in at[]: (rank << 19) | (p << 11) |
// (c << 1) | kPlus. Returns the new E. One warp; the rows of kGatherRounds
// rounds are loaded before any is used, so their loads overlap.
constexpr int kGatherRounds = 4;

template <bool kPlus>
__device__ int gather_events(const Stream& st, int base, int T, int k, int c0, int G, int* at,
                             int* ev, int E) {
  const int lane = threadIdx.x & 31;
  for (int i0 = st.lo; i0 < st.hi; i0 += 32 * kGatherRounds) {
    int key[kGatherRounds];
    int partner[kGatherRounds];
    int order[kGatherRounds];
#pragma unroll
    for (int u = 0; u < kGatherRounds; ++u) {
      const int i = i0 + u * 32 + lane;
      if (i < st.hi) {
        key[u] = st.key[i];
        partner[u] = st.partner[i];
        order[u] = st.order[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherRounds; ++u) {
      int e = -1;
      if (i0 + u * 32 + lane < st.hi) {
        const int c = live_column<kPlus>(key[u], partner[u], order[u], k, c0, G);
        const int p = key[u] - st.shift - base;
        if (c >= 0 && p >= 0 && p < T) {
          e = (atomicAdd(&at[p], 1) << 19) | (p << 11) | (c << 1) | (kPlus ? 1 : 0);
        }
      }
      const unsigned live = __ballot_sync(0xffffffffu, e >= 0);
      if (e >= 0) ev[E + __popc(live & ((1u << lane) - 1))] = e;
      E += __popc(live);
    }
  }
  return E;
}

// A tile finished from its events, by one warp, in its own shared words:
// at[T + 1] (events a position, then the first of each), ev[kEventRows]
// (as read), srt[kEventRows] (by position, then the answer after each),
// cnt[G] (each column's count), mask[(G + 31) / 32] (the positive
// columns).
__device__ void event_tile(const Tile& tile, int T, int G, int k, int c0, int none, int* smem) {
  const int lane = threadIdx.x & 31;
  const int words = (G + 31) / 32;
  int* at = smem;
  int* ev = at + T + 1;
  int* srt = ev + kEventRows;
  int* cnt = srt + kEventRows;
  unsigned* mask = reinterpret_cast<unsigned*>(cnt + G);
  for (int p = lane; p <= T; p += 32) at[p] = 0;
  int first = none;  // the first positive column at the tile's start
  for (int w = 0; w < words; ++w) {
    const int c = w * 32 + lane;
    const int v = c < G ? tile.carry[c * tile.stride] : 0;
    if (c < G) cnt[c] = v;
    const unsigned bits = __ballot_sync(0xffffffffu, v > 0);
    if (lane == 0) mask[w] = bits;
    if (bits) first = min(first, w * 32 + __ffs(bits) - 1);
  }
  __syncwarp();
  int E = gather_events<false>(tile.minus, tile.base, T, k, c0, G, at, ev, 0);
  E = gather_events<true>(tile.plus, tile.base, T, k, c0, G, at, ev, E);
  __syncwarp();
  // at[] from events a position to the first event of each: lane l scans
  // its T / 32 positions, the warp its lanes' sums.
  const int per = T / 32;
  int sum = 0;
  for (int j = 0; j < per; ++j) sum += at[lane * per + j];
  int run = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o) run += y;
  }
  run -= sum;
  for (int j = 0; j < per; ++j) {
    const int n = at[lane * per + j];
    at[lane * per + j] = run;
    run += n;
  }
  if (lane == 31) at[T] = run;
  __syncwarp();
  for (int j = lane; j < E; j += 32) {
    const int e = ev[j];
    srt[at[(e >> 11) & 0xff] + (e >> 19)] = e & 0x7ff;
  }
  __syncwarp();
  // The walk, 32 events a step in position order: each event's count before
  // and after from its column's count and the earlier events of its column
  // in the step; the mask after each event from the mask before the step
  // and an XOR scan of the flips; the answer after each event written over
  // it in srt.
  const unsigned below = (1u << lane) - 1;
  for (int j0 = 0; j0 < E; j0 += 32) {
    const int j = j0 + lane;
    const int e = j < E ? srt[j] : -1;
    const int c = e >= 0 ? e >> 1 : -1;
    const unsigned same = __match_any_sync(0xffffffffu, c);
    const unsigned ups = __ballot_sync(0xffffffffu, e >= 0 && (e & 1));
    const unsigned downs = __ballot_sync(0xffffffffu, e >= 0 && !(e & 1));
    const int held = c >= 0 ? cnt[c] : 0;
    __syncwarp();
    const int was = held + __popc(same & below & ups) - __popc(same & below & downs);
    const int now = was + ((e & 1) ? 1 : -1);
    if (c >= 0 && (same >> lane) == 1) cnt[c] = now;  // the last of its column's events
    const bool flip = c >= 0 && (was > 0) != (now > 0);
    int ans = none;
    for (int w = 0; w < words; ++w) {
      unsigned x = flip && (c >> 5) == w ? 1u << (c & 31) : 0u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x ^= y;
      }
      const unsigned m = mask[w] ^ x;
      if (m) ans = min(ans, w * 32 + __ffs(m) - 1);
      __syncwarp();
      if (lane == 31) mask[w] = m;
    }
    if (j < E) srt[j] = ans;
    __syncwarp();
  }
  for (int p = lane; p < tile.rows; p += 32) {
    const int n = at[p + 1];  // the events at positions <= p
    tile.out[p] = conservation_out(tile.out[p], n > 0 ? srt[n - 1] : first, c0);
  }
  __syncwarp();  // the next tile rewrites these words
}

// The event path: warp w of the grid finishes the listed tiles w, w + the
// grid's warps, ..., where at least a.min_events were listed; fewer are
// left to the dense path.
template <bool kRagged>
__global__ void __launch_bounds__(kEventThreads) event_apply_kernel(ApplyTiles a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  int* mine = smem + warp * event_words(a.T, a.G);
  const int listed = a.counts[0] < a.min_events ? 0 : a.counts[0];
  if (a.event_count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *a.event_count = listed;
  const int stride = gridDim.x * kEventWarps;
  int j = blockIdx.x * kEventWarps + warp;
  int i = j < listed ? a.list[j] : 0;
  for (; j < listed; j += stride) {
    const Tile tile = tile_at<kRagged>(a, i);
    i = j + stride < listed ? a.list[j + stride] : 0;  // read ahead
    event_tile(tile, a.T, a.G, a.k, a.c0, a.none, mine);
  }
}

// The dense path: block b finishes the listed tiles b, b + gridDim.x, ...
// of its own list, after the event path's where that did not run. Two
// blocks an SM, as many as the tile's shared memory lets in at G = 90: left
// to fit more, the compiler held the scan to 40 registers, and a tile took
// 1.6 times as long (PERF.md, section 6).
template <bool kRagged>
__global__ void __launch_bounds__(kThreads, 2) dense_apply_kernel(ApplyTiles a) {
  extern __shared__ int smem[];
  const int G = a.G;
  const int T = a.T;
  int* cov = smem;                 // [G][T + 1]
  int* carry = cov + G * (T + 1);  // [G]
  int* first = carry + G;          // [T]
  const int events = a.counts[0] < a.min_events ? a.counts[0] : 0;
  const int listed = events + a.counts[1];
  const int32_t* dense = a.list + a.tiles - 1 + events;  // its own list, from the back
  const int stride = gridDim.x;
  int j = blockIdx.x;
  int i = j < listed ? (j < events ? a.list[j] : dense[-j]) : 0;
  for (; j < listed; j += stride) {
    const Tile tile = tile_at<kRagged>(a, i);
    const int next = j + stride;  // read ahead
    i = next < listed ? (next < events ? a.list[next] : dense[-next]) : 0;
    for (int w = threadIdx.x; w < G * (T + 1); w += blockDim.x) cov[w] = 0;
    for (int p = threadIdx.x; p < T; p += blockDim.x) first[p] = a.none;
    for (int c = threadIdx.x; c < G; c += blockDim.x) carry[c] = tile.carry[c * tile.stride];
    __syncthreads();
    scatter<false>(tile.minus, tile.minus.lo, tile.minus.hi, tile.base, T, a.k, a.c0, G, cov,
                   T + 1, 1);
    scatter<true>(tile.plus, tile.plus.lo, tile.plus.hi, tile.base, T, a.k, a.c0, G, cov, T + 1,
                  1);
    __syncthreads();
    finish_tile<false>(cov, carry, first, T, G, tile.rows, a.none, tile.out, 0, 0, a.c0);
    __syncthreads();  // the next tile rewrites the shared tile
  }
}

// Blocks of `kernel` (threads, smem bytes of dynamic shared memory) that
// fit the current card at once. Cached by kernel, smem and device; on first
// use the kernel's shared memory limit is raised to the card's, so that no
// later launch of it needs the call again.
int resident_blocks(const void* kernel, int threads, size_t smem, cudaError_t* err) {
  struct Entry {
    const void* kernel;
    size_t smem;
    int device;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cache = 0;
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  int blocks = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int j = 0; j < n_cache && blocks == 0; ++j) {
      const Entry& e = cache[j];
      if (e.kernel == kernel && e.smem == smem && e.device == device) blocks = e.blocks;
    }
  }
  if (blocks == 0) {
    int limit = 0;
    int sms = 0;
    int per_sm = 0;
    *err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (*err == cudaSuccess) {
      *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    }
    if (*err == cudaSuccess) {
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (*err == cudaSuccess) {
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    }
    if (*err != cudaSuccess) return 0;
    blocks = max(1, sms * per_sm);
    std::lock_guard<std::mutex> lock(mu);
    if (n_cache < 64) cache[n_cache++] = Entry{kernel, smem, device, blocks};
  }
  return blocks;
}


// A ragged launch (tile.cuh) over `units` units of the flat tile list. First
// one block per window writes each of its units' place: (window, tile of
// the window, the tile's positions, the window's start), no positions for a
// spare unit; and the window's run of the list: (first unit, tiles). The
// net and apply kernels then take one block per unit and start from that
// one load, as the uniform ones start from blockIdx, and the scan from the
// run, with no division in any of their threads; they lay out
// bounds[unit, 4] and delta and carry [c, unit].
constexpr int kPlaceThreads = 256;

__global__ void __launch_bounds__(kPlaceThreads)
ragged_place_kernel(const int32_t* __restrict__ params, const int64_t* __restrict__ off, int T,
                    int4* __restrict__ place, int2* __restrict__ runs) {
  const int q = blockIdx.x;
  const int first = ragged_first(off, q, T);
  const int last = ragged_first(off, q + 1, T);  // the next window's first unit
  const long long len = off[q + 1] - off[q];
  const int qs = params[static_cast<size_t>(q) * 5 + 4];
  if (threadIdx.x == 0) runs[q] = make_int2(first, ragged_units(off, q, T));
  for (int u = first + threadIdx.x; u < last; u += blockDim.x) {
    const long long base = static_cast<long long>(u - first) * T;
    const int rows = base < len ? static_cast<int>(min(static_cast<long long>(T), len - base)) : 0;
    place[u] = make_int4(q, u - first, rows, qs);
  }
}

__global__ void __launch_bounds__(kNetThreads)
ragged_net_kernel(Store store, const int32_t* __restrict__ params,
                  const int4* __restrict__ place, int c0, int C, int T, int k,
                  int32_t* __restrict__ bounds, int32_t* __restrict__ delta, int32_t* counts,
                  int32_t* event_count) {
  extern __shared__ int smem[];
  int* net = smem;       // [C]
  int* found = net + C;  // [4]
  const int unit = blockIdx.x;
  const int units = gridDim.x;
  if (unit == 0) zero_counts(counts, event_count);  // as rows_net_kernel
  const int4 at = place[unit];
  if (at.z == 0) return;  // a spare unit
  const Window w = load_window(store, params, at.x, k);
  const int base = at.y * T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) net[c] = 0;
  find_bounds(w, base, base + T, found);
  __syncthreads();
  scatter<false>(w.minus, found[0], found[1], base, T, k, c0, C, net, 1, 0);
  scatter<true>(w.plus, found[2], found[3], base, T, k, c0, C, net, 1, 0);
  __syncthreads();
  if (threadIdx.x < 4) bounds[static_cast<size_t>(unit) * 4 + threadIdx.x] = found[threadIdx.x];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    delta[static_cast<size_t>(c) * units + unit] = net[c];
  }
}

// The ragged carries: one block per (column, window) over the window's own
// tiles, the row of column c from the window's first unit.
__global__ void __launch_bounds__(kScanThreads)
ragged_scan_kernel(const int32_t* __restrict__ delta, const int32_t* __restrict__ prefix,
                   const int2* __restrict__ runs, int units, int ld,
                   int32_t* __restrict__ carry, const int32_t* __restrict__ bounds, int32_t* list,
                   int32_t* counts, int rows_max) {
  __shared__ int warp_sum[kScanWarps];
  const int c = blockIdx.x;
  const int q = blockIdx.y;
  const int2 run = runs[q];
  const size_t row = static_cast<size_t>(c) * units + run.x;
  scan_row(delta + row, run.y, prefix[static_cast<size_t>(q) * ld + c], carry + row, warp_sum);
  list_tiles(run.x, run.y, bounds, list, counts, units, rows_max);
}

// A ragged unit applied from its carry: its positions written at its
// window's offset of the packed output. The scatter needs of the window
// only its start (the streams' shifts): the rows come from bounds.
template <bool kMembership>
__global__ void __launch_bounds__(kThreads)
ragged_apply_kernel(Store store, const int64_t* __restrict__ off, const int4* __restrict__ place,
                    const int32_t* __restrict__ bounds, const int32_t* __restrict__ tile_carry,
                    int c0, int C, int ld, int T, int k, int none, void* __restrict__ out) {
  extern __shared__ int smem[];
  int* cov = smem;                 // [C][T + 1]
  int* carry = cov + C * (T + 1);  // [C]
  int* first = carry + C;          // [T]
  const int unit = blockIdx.x;
  const int units = gridDim.x;
  const int4 at = place[unit];
  if (at.z == 0) return;  // a spare unit
  const Stream minus{store.start, store.end, store.order, 0, 0, at.w};
  const Stream plus{store.end_s, store.start_by_end, store.order_by_end, 0, 0, at.w + k - 1};
  const int32_t* b = bounds + static_cast<size_t>(unit) * 4;
  const int base = at.y * T;
  for (int i = threadIdx.x; i < C * (T + 1); i += blockDim.x) cov[i] = 0;
  for (int p = threadIdx.x; p < T; p += blockDim.x) first[p] = none;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    carry[c] = tile_carry[static_cast<size_t>(c) * units + unit];
  }
  __syncthreads();
  scatter<false>(minus, b[0], b[1], base, T, k, c0, C, cov, T + 1, 1);
  scatter<true>(plus, b[2], b[3], base, T, k, c0, C, cov, T + 1, 1);
  __syncthreads();
  finish_tile<kMembership>(cov, carry, first, T, C, at.z, none, out,
                           static_cast<size_t>(off[at.x] - off[0]) + base, ld, c0);
}

// What the two paths cost, from a sweep on the card over G = 16 ... 90 and
// densities from the MHC's to the chromosome's (PERF.md, section 6): the
// event path finishes a tile on one warp in about kEventTileNs plus
// kEventRowNs a candidate row, and the dense finish takes the card about
// kDenseCellNs a (tile, column).
constexpr double kEventTileNs = 6000.0;
constexpr double kEventRowNs = 31.0;
constexpr double kDenseCellNs = 0.49;

// Whether, and where, a conservation launch of `tiles` tiles of T positions
// over G columns splits its tiles between the two paths.
struct Split {
  int rows;          // a tile of at most this many candidate rows takes the event path; 0: none
  int event_warps;   // warps of event_apply_kernel the card holds at once
  int dense_blocks;  // blocks of dense_apply_kernel the card holds at once
};

// A launch splits only where dense_apply_kernel fits as many blocks an SM
// as the one-block-a-tile kernel (at small G its loop's registers let in
// fewer, and its tiles would finish slower than unsplit) and the launch has
// at least a tile for each event warp the card holds (fewer, and the event
// path's time is one tile's, on one warp). A tile then takes the event path
// where that time is at most the dense finish's for as many tiles as the
// card holds event warps; event_apply_kernel runs only where at least that
// many tiles were listed for it, and leaves them to the dense one else.
template <bool kRagged>
Split split_of(int G, int T, long long tiles, cudaError_t* err) {
  Split split{0, 0, 0};
  const size_t event_smem = static_cast<size_t>(kEventWarps) * event_words(T, G) * sizeof(int);
  const size_t dense_smem = (static_cast<size_t>(G) * (T + 1) + G + T) * sizeof(int);
  const void* one = kRagged ? reinterpret_cast<const void*>(ragged_apply_kernel<false>)
                            : reinterpret_cast<const void*>(rows_apply_kernel<false>);
  const int unsplit = resident_blocks(one, kThreads, dense_smem, err);
  if (*err != cudaSuccess) return split;
  split.dense_blocks = resident_blocks(reinterpret_cast<const void*>(dense_apply_kernel<kRagged>),
                                       kThreads, dense_smem, err);
  if (*err != cudaSuccess) return split;
  split.event_warps = kEventWarps * resident_blocks(
      reinterpret_cast<const void*>(event_apply_kernel<kRagged>), kEventThreads, event_smem, err);
  if (*err != cudaSuccess || split.dense_blocks < unsplit || tiles < split.event_warps) {
    return split;
  }
  const double rows = (split.event_warps * kDenseCellNs * G - kEventTileNs) / kEventRowNs;
  split.rows = rows < 1 ? 0 : static_cast<int>(min(rows, static_cast<double>(kEventRows)));
  return split;
}

// The conservation apply of a launch that splits its tiles: the event
// path, then the dense one.
template <bool kRagged>
cudaError_t launch_conservation(ApplyTiles a, const Split& split, cudaStream_t s) {
  a.min_events = split.event_warps;
  const size_t event_smem = static_cast<size_t>(kEventWarps) * event_words(a.T, a.G) * sizeof(int);
  const int event_blocks = min(split.event_warps, a.tiles + kEventWarps - 1) / kEventWarps;
  event_apply_kernel<kRagged><<<event_blocks, kEventThreads, event_smem, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t dense_smem = (static_cast<size_t>(a.G) * (a.T + 1) + a.G + a.T) * sizeof(int);
  dense_apply_kernel<kRagged><<<min(split.dense_blocks, a.tiles), kThreads, dense_smem, s>>>(a);
  return cudaGetLastError();
}

// The ragged kernels over `units` units; scratch as the entry point says.
cudaError_t launch_ragged(const Store& store, const int32_t* params, const int32_t* prefix,
                          const int64_t* off, int32_t* scratch, void* out, int32_t* event_count,
                          int Q, int C, int c0, int G, int k, int T, int n_docs, int membership,
                          int units, cudaStream_t s) {
  int4* place = reinterpret_cast<int4*>(scratch);              // [units]
  int32_t* bounds = scratch + static_cast<size_t>(units) * 4;  // [units, 4]
  int32_t* delta = bounds + static_cast<size_t>(units) * 4;    // [G, units]
  int32_t* carry = delta + static_cast<size_t>(units) * G;     // [G, units]
  int2* runs = reinterpret_cast<int2*>(carry + static_cast<size_t>(units) * G);  // [Q]
  int32_t* list = reinterpret_cast<int32_t*>(runs + Q);                          // [units]
  int32_t* counts = list + units;                                                // [2]
  ragged_place_kernel<<<Q, kPlaceThreads, 0, s>>>(params, off, T, place, runs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ragged_net_kernel<<<units, kNetThreads, (G + 4) * sizeof(int), s>>>(
      store, params, place, c0, G, T, k, bounds, delta, counts, event_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Split split = membership ? Split{0, 0, 0} : split_of<true>(G, T, units, &err);
  if (err != cudaSuccess) return err;
  ragged_scan_kernel<<<dim3(G, Q), kScanThreads, 0, s>>>(
      delta, prefix + c0, runs, units, C, carry, bounds, split.rows > 0 ? list : nullptr, counts,
      split.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (split.rows > 0) {
    const ApplyTiles a{store, params, place, off, bounds, carry, static_cast<int32_t*>(out), list,
                       counts, event_count, units, 0, 0, c0, G, T, k, n_docs - c0, 0};
    return launch_conservation<true>(a, split, s);
  }
  const size_t smem = (static_cast<size_t>(G) * (T + 1) + G + T) * sizeof(int);
  auto* apply = membership ? ragged_apply_kernel<true> : ragged_apply_kernel<false>;
  err = cudaFuncSetAttribute(apply, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* group_out = membership ? static_cast<void*>(static_cast<int8_t*>(out) + c0) : out;
  apply<<<units, kThreads, smem, s>>>(store, off, place, bounds, carry, c0, G, C, T, k,
                                      n_docs - c0, group_out);
  return cudaGetLastError();
}

}  // namespace

// Query Q windows on `stream` from the placed store's six row arrays (n_rows
// rows each), over the store's columns [c0, c0 + G) of its C. params is
// int32[Q, 5] (mlo, mhi, plo, phi, qs per window), prefix int32[Q, C].
// Uniform (offsets null): every window L positions, out int32[Q, L]
// (conservation: c0 plus the group's first marked column, or n_docs,
// min-combined with out where c0 > 0) or int8[Q, L, C] (membership: columns
// [c0, c0 + G) written), scratch Q * nt * (5 + 2 * G) + 2 int32 words with
// nt = ceil(L / tile). Ragged: offsets int64[Q + 1] on the card, window q's
// positions [offsets[q] - offsets[0], offsets[q + 1] - offsets[0]) of the
// packed out int32[total] or int8[total, C], each at most L long (its
// parameters are those of [qs, qs + L)); scratch units * (9 + 2 * G) +
// 2 * Q + 2 words, 16-byte aligned, with units = total / tile + Q
// (tile.cuh).
// event_count (conservation; may be null): one int32 on the card, set to
// the tiles that took the event path. Returns the CUDA error code of the
// first call that failed, 0 when all were accepted.
extern "C" int memo_fused_query_rows(const int32_t* start, const int32_t* end,
                                     const int32_t* order, const int32_t* end_s,
                                     const int32_t* start_by_end, const int32_t* order_by_end,
                                     const int32_t* params, const int32_t* prefix,
                                     int32_t* scratch, void* out, const int64_t* offsets,
                                     int32_t* event_count, long long total, int n_rows, int Q,
                                     int L, int C, int c0, int G, int k, int tile, int n_docs,
                                     int membership, void* stream) {
  if (n_rows < 0 || Q < 1 || Q > kMaxGridY || L < 1 || c0 < 0 || G < 1 || G >= 1024 ||
      c0 + G > C || k < 1 || tile < 32 || tile % 32 != 0 || tile > 32 * kMaxChunks || total < 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Store store{start, end, order, end_s, start_by_end, order_by_end, n_rows};
  if (offsets != nullptr) {
    const long long units = total / tile + Q;
    if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
    return launch_ragged(store, params, prefix, offsets, scratch, out, event_count, Q, C, c0, G,
                         k, tile, n_docs, membership, static_cast<int>(units), s);
  }
  const int T = tile;
  const int nt = (L + T - 1) / T;
  const size_t tiles = static_cast<size_t>(Q) * nt;
  if (tiles > 0x7fffffffULL) return cudaErrorInvalidValue;
  int32_t* bounds = scratch;            // [Q, nt, 4]
  int32_t* delta = bounds + tiles * 4;  // [Q, G, nt]
  int32_t* carry = delta + tiles * G;   // [Q, G, nt]
  int32_t* list = carry + tiles * G;    // [Q * nt]
  int32_t* counts = list + tiles;       // [2]
  const dim3 grid(nt, Q);
  rows_net_kernel<<<grid, kNetThreads, (G + 4) * sizeof(int), s>>>(store, params, c0, G, T, k,
                                                                   bounds, delta, counts,
                                                                   event_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Split split = membership ? Split{0, 0, 0} : split_of<false>(G, T, tiles, &err);
  if (err != cudaSuccess) return err;
  tile_scan_kernel<<<dim3(G, Q), kScanThreads, 0, s>>>(delta, prefix + c0, nt, G, C, carry, bounds,
                                                       split.rows > 0 ? list : nullptr, counts,
                                                       split.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int none = n_docs - c0;
  if (split.rows > 0) {
    const ApplyTiles a{store, params, nullptr, nullptr, bounds, carry,
                       static_cast<int32_t*>(out), list, counts, event_count,
                       static_cast<int>(tiles), nt, L, c0, G, T, k, none, 0};
    return launch_conservation<false>(a, split, s);
  }
  const size_t smem = (static_cast<size_t>(G) * (T + 1) + G + T) * sizeof(int);
  if (membership) {
    return launch_apply<true>(grid, smem, s, store, params, bounds, carry, L, c0, G, C, T, k,
                              none, static_cast<int8_t*>(out) + c0);
  }
  return launch_apply<false>(grid, smem, s, store, params, bounds, carry, L, c0, G, C, T, k, none,
                             out);
}

// Candidate rows up to which a tile of a conservation launch of `tiles`
// tiles (units, where ragged) of `tile` positions over G columns takes the
// event path on the current card; 0 where such a launch does not split its
// tiles, minus the CUDA error code where a call failed.
extern "C" int memo_fused_query_event_rows(int G, int tile, long long tiles, int ragged) {
  cudaError_t err = cudaSuccess;
  const Split split = ragged ? split_of<true>(G, tile, tiles, &err)
                             : split_of<false>(G, tile, tiles, &err);
  return err != cudaSuccess ? -static_cast<int>(err) : split.rows;
}

extern "C" const char* memo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
