// What both fused-query kernels share (csrc/fused_query.cu, v1, and
// csrc/fused_query_v2.cu, v2): the placed store's rows, a window's two event
// streams, and the finish of a tile: the scan of its [C][T + 1] diff tile
// from a carry, reduced to conservation or membership.
//
// The finish functions run on kWarps warps numbered 0 .. kWarps - 1 (`warp`
// is the caller's warp index among them); warp w takes columns w, w + kWarps,
// ... (scan) or positions w, w + kWarps, ... (membership).
//
// A launch covers one group of columns [c0, c0 + G) of a store C wide (the
// whole store where it fits the block's shared memory): its tile, carry and
// sums are G columns wide, a row of another column is no event, and the
// prefix and the membership output keep the store's row stride C. The
// tile's conservation is the group's first marked column, or "none" =
// n_docs - c0; the launch writes it plus c0 (conservation_out): as it is
// for the first group, else the minimum of that and what out holds. Each
// position has one writer in a launch and the groups' launches run in
// stream order, so after the last group out holds the store's first marked
// column, or n_docs.
#pragma once

#include <cstddef>
#include <cstdint>

constexpr int kMaxChunks = 8;  // 32-position chunks of the widest tile (256)

// The placed store (memo_tpu_torch/index/placement.py::PlacedStore): n_rows
// int32 rows in start order and, permuted, in end order.
struct Store {
  const int32_t* start;
  const int32_t* end;
  const int32_t* order;
  const int32_t* end_s;
  const int32_t* start_by_end;
  const int32_t* order_by_end;
  int n_rows;
};

// One event stream of one window: rows [lo, hi) of the sorted coordinate
// `key` (start for the minus stream, end for the plus one), with the partner
// coordinate and the column; row i's event sits at key[i] - shift.
struct Stream {
  const int32_t* key;
  const int32_t* partner;
  const int32_t* order;
  int lo;
  int hi;
  int shift;
};

struct Window {
  Stream minus;
  Stream plus;
};

// Window q's streams from its parameter row (mlo, mhi, plo, phi, qs); the
// row ranges are clamped to the store, so no parameter reads outside it.
__device__ inline Window load_window(const Store& s, const int32_t* params, int q, int k) {
  const int32_t* w = params + static_cast<size_t>(q) * 5;
  const int mlo = min(max(w[0], 0), s.n_rows);
  const int plo = min(max(w[2], 0), s.n_rows);
  const int qs = w[4];
  return {{s.start, s.end, s.order, mlo, min(max(w[1], mlo), s.n_rows), qs},
          {s.end_s, s.start_by_end, s.order_by_end, plo, min(max(w[3], plo), s.n_rows),
           qs + k - 1}};
}

// A row's event column within the launch's column group [c0, c0 + G), or
// -1 when the row is not live there. end - start is key - partner in end
// order and partner - key in start order.
template <bool kPlus>
__device__ __forceinline__ int live_column(int key, int partner, int o, int k, int c0, int G) {
  const int span = kPlus ? key - partner : partner - key;
  const int c = o - c0;
  return span < k - 1 && c >= 0 && c < G ? c : -1;
}

// What a launch over the column group from c0 writes at a conservation
// position whose group's first marked column is `first` (or none), where out
// holds `held`: the first group writes c0 + first, a later one the minimum.
__device__ __forceinline__ int conservation_out(int held, int first, int c0) {
  return c0 > 0 ? min(held, first + c0) : first;
}

// Coverage along each column of the tile from carry[c]: one warp per column.
// The column's T / 32 chunks of 32 positions are scanned with shuffles side
// by side (independent chains), then chained by their totals. kCarryOut
// leaves the coverage at the tile's last position in carry[c] (the next
// tile's carry; column c belongs to one warp, so the update is its own).
template <int kWarps, bool kCarryOut = false>
__device__ void scan_tile(int* cov, int* carry, int T, int S, int C, int warp) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = T / 32;
  for (int c = warp; c < C; c += kWarps) {
    int* row = cov + c * S;
    int x[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) x[j] = j < n_chunks ? row[j * 32 + lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int y = __shfl_up_sync(0xffffffffu, x[j], o);
        if (lane >= o) x[j] += y;
      }
    }
    int run = carry[c];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int total = __shfl_sync(0xffffffffu, x[j], 31);
      if (j < n_chunks) row[j * 32 + lane] = x[j] + run;
      run += total;
    }
    if (kCarryOut && lane == 0) carry[c] = run;
  }
}

// Conservation of the tile: the scan of scan_tile, reduced in registers.
// Each lane keeps, for its positions, the first of its warp's columns with
// coverage > 0 (a warp takes its columns in increasing order), and one shared
// atomicMin per position and warp merges the warps into first[T] (which
// holds n_docs on entry). kCarryOut as in scan_tile; kZero writes 0 over
// each word of the tile once it is read, so the tile is zero again after.
template <int kWarps, bool kCarryOut = false, bool kZero = false>
__device__ void scan_conservation(int* cov, int* carry, int* first, int T, int S, int C,
                                  int n_docs, int warp) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = T / 32;
  int best[kMaxChunks];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) best[j] = n_docs;
  for (int c = warp; c < C; c += kWarps) {
    int* row = cov + c * S;
    int x[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) x[j] = j < n_chunks ? row[j * 32 + lane] : 0;
    if (kZero) {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        if (j < n_chunks) row[j * 32 + lane] = 0;
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int y = __shfl_up_sync(0xffffffffu, x[j], o);
        if (lane >= o) x[j] += y;
      }
    }
    int run = carry[c];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int total = __shfl_sync(0xffffffffu, x[j], 31);
      if (x[j] + run > 0) best[j] = min(best[j], c);
      run += total;
    }
    if (kCarryOut && lane == 0) carry[c] = run;
  }
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    if (j < n_chunks && best[j] < n_docs) atomicMin(&first[j * 32 + lane], best[j]);
  }
}

// Membership of the tile from its scanned coverage (scan_tile): one warp per
// position, lanes over columns, coalesced int8 stores of the first `rows`
// positions from out, whose positions lie ld bytes apart.
template <int kWarps>
__device__ void reduce_membership(const int* cov, int S, int C, int rows, int8_t* out, int ld,
                                  int warp) {
  const int lane = threadIdx.x & 31;
  for (int p = warp; p < rows; p += kWarps) {
    for (int c = lane; c < C; c += 32) {
      out[static_cast<size_t>(p) * ld + c] = cov[c * S + p] > 0 ? 0 : 1;
    }
  }
}
