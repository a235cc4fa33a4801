// Fused MEMO query, v2: one pass over the placed store's rows, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel memo_tpu/ops/pallas_query_v2.py::memo_query_pallas_v2
// (its set-up and the body _make_kernel_v2 that it hands to pl.pallas_call),
// the variant for dense windows. Same contract as v1 (csrc/fused_query.cu,
// fused_query_rows): window q is [qs, qs + L) at k, with candidate rows
// [mlo, mhi) in start order and [plo, phi) in end order; a live row adds -1
// in its column at start - qs and +1 at end - qs - (k - 1); the coverage
// cov[p][c] = prefix[q][c] + the events at positions <= p is reduced to
// conservation (int32[Q, L]) or membership (int8[Q, L, C]). No stream
// set-up: the kernel reads the rows where engine.place_store put them.
//
// What bounds it on this card: bytes, as v1 (12 bytes per candidate row read
// once, plus the output).
//
// One pass: v1 reads every row twice from device memory (its net pass and
// its apply pass) and carries the coverage by a scan over tiles in between.
// Here every row is read from device memory once, and the carry into a run
// of R tiles comes from a decoupled look-back over the earlier runs of its
// window: a run publishes its aggregate (net events per column) and, once it
// has its carry, its inclusive sum; a run walks back over its predecessors
// 32 at a time and stops at the nearest inclusive. Runs are drawn by one
// atomic ticket in window-major order, so a run waits only on runs drawn
// before it, whose blocks are running: the look-back cannot deadlock.
// Statuses carry the launch's epoch, and the last block to leave resets the
// ticket and moves the epoch on, so the state is zeroed once when the
// wrapper allocates it (a launch is one kernel node, no memset).
//
// The grid is persistent (as many blocks as are resident, each walking
// runs). A block's producer warp finds the run's row bounds (the run's ends
// by four searches side by side, eight lanes each; the tile bounds inside it
// by one binary search per lane) and streams the rows with bulk copies
// (cp.async.bulk, the 1-D TMA) into an S-stage shared-memory ring, each
// stage a chunk of one stream's rows of [floor4(lo), ceil4(hi)) with full
// and empty mbarriers. The run's rows pass twice through the ring: first for
// its aggregate, then, after the look-back, tile by tile into the diff tile
// (the second read comes from L2). The eight consumer warps wait only on
// their stage's barrier; the producer runs ahead, so the next rows land
// while a tile is scanned. The finish is v1's (tile.cuh), with the carry
// handed from tile to tile in shared memory and the tile zeroed as the scan
// reads it.
//
// Measured and dropped: one block per tile that reads its rows directly and
// looks back per tile (1.4-3.3x slower than this design at every cell,
// PERF.md).
//
// Bank conflicts as in v1: the tile is cov[C][T + 1], word (c, p) in bank
// (c + p) % 32. As in v1, a launch covers one column group of the store
// (tile.cuh), and the wrapper launches wider stores as groups.
//
// What it does not copy: the TPU kernel's band/full fold split
// (pallas_query_v2.py:26-43, :175-263) exists because a step fold on the TPU
// costs T x E operand work per event row; in the diff form every event costs
// one shared-memory add whatever its span.
//
// The launcher runs on the caller's stream, does not synchronise and does
// not allocate: the wrapper passes the state words (zeroed once), the sums
// scratch and the output.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kConsumers = 256;  // threads that scatter, scan and reduce
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // the consumers and one producer warp
constexpr int kStageRows = 512;               // rows of one stream in one ring stage
constexpr int kMaxStages = 8;
constexpr int kMaxRun = 16;  // tiles of a run: the producer's lanes 0-14 and 16-30 search
constexpr int kMetaInts = 8;
constexpr int kRingHeader = kMaxStages * (2 * 8 + kMetaInts * 4);  // barriers and metadata
constexpr int kSpinLimit = 1 << 24;  // waits that never end trap instead of hanging
constexpr int kEpochMask = (1 << 29) - 1;
static_assert(kMaxRun <= 16, "lanes 0-15 and 16-31 search the tile bounds of one stream each");
static_assert(kRingHeader % 128 == 0, "the ring's rows start 128-byte aligned");

// The state words: ticket, blocks that left, epoch, then one status per run
// (or tile) of every window, (epoch << 2) | flag.
constexpr int kTicket = 0;
constexpr int kExited = 1;
constexpr int kEpoch = 2;
constexpr int kStatus = 4;
constexpr int kAggregate = 1;  // aggregate[C] published
constexpr int kInclusive = 2;  // inclusive[C] published

// Ring stage kinds.
constexpr int kAggStage = 0;
constexpr int kApplyStage = 1;
constexpr int kEndStage = 2;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// Barrier 1 over the 256 consumer threads (warps 0-7); the producer warp
// never takes it.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" : : "n"(kConsumers) : "memory");
}

// Make this block's writes visible, then set a status.
__device__ __forceinline__ void publish(int* status, int value) {
  __threadfence();
  consumer_sync();
  if (threadIdx.x == 0) store_release(status, value);
}

// Run j of a window (its runs are first .. first + n - 1 of the status
// words and of sums[.., 2, C]) publishes its aggregate net[C] and gets its
// carry[C] from the prefix (the window's row of the group's C columns) when
// j == 0, or by walking back over the window's
// earlier runs, 32 at a time: warp 0 waits until the 32 nearest unread
// predecessors have published, each lane acquiring one status, and finds
// the nearest inclusive among them (`code` in shared memory: n > 0, the
// n-th is inclusive; -n, n aggregates and no inclusive); then every thread
// adds those sums for its columns. Called by the 256 consumer threads.
__device__ void look_back(int* status, int32_t* sums, const int32_t* prefix, size_t first, int j,
                          const int* net, int* carry, int C, int epoch, int* code) {
  const int tid = threadIdx.x;
  const size_t unit = first + j;
  int32_t* aggregate = sums + unit * 2 * C;
  int32_t* inclusive = aggregate + C;
  if (j == 0) {
    for (int c = tid; c < C; c += kConsumers) {
      carry[c] = prefix[c];
      inclusive[c] = prefix[c] + net[c];
    }
  } else {
    for (int c = tid; c < C; c += kConsumers) {
      aggregate[c] = net[c];
      carry[c] = 0;
    }
    publish(&status[unit], (epoch << 2) | kAggregate);
    for (int end = j;;) {  // predecessors end - 1, end - 2, ... not read yet
      if (tid < 32) {
        const int pred = end - 1 - tid;
        int flag = 0;
        if (pred >= 0) {
          int v, spins = 0;
          while (((v = load_acquire(&status[first + pred])) >> 2) != epoch || (v & 3) == 0) {
            __nanosleep(32);
            if (++spins > kSpinLimit) __trap();
          }
          flag = v & 3;
        }
        const unsigned found = __ballot_sync(0xffffffffu, flag == kInclusive);
        if (tid == 0) *code = found ? __ffs(found) : -min(32, end);
      }
      consumer_sync();
      const int got = *code;
      const int n = got > 0 ? got : -got;
      // Predecessor end - 1 - i's aggregate (its inclusive for the last one
      // when got > 0), 8 loads in flight at a time.
      const int32_t* base = sums + (first + end - 1) * 2 * C;
      const int last = got > 0 ? n - 1 : n;
      for (int c = tid; c < C; c += kConsumers) {
        int acc = carry[c];
        int i = 0;
        for (; i + 8 <= n; i += 8) {
          int v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            v[u] = __ldcg(base - static_cast<long long>(i + u) * 2 * C +
                          (i + u == last ? C : 0) + c);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) acc += v[u];
        }
        for (; i < n; ++i) {
          acc += __ldcg(base - static_cast<long long>(i) * 2 * C + (i == last ? C : 0) + c);
        }
        carry[c] = acc;
      }
      consumer_sync();  // code is rewritten by the next round
      if (got > 0) break;
      end -= n;
    }
    for (int c = tid; c < C; c += kConsumers) inclusive[c] = carry[c] + net[c];
  }
  publish(&status[unit], (epoch << 2) | kInclusive);
}

// After every thread of the block is done: the last block to leave resets
// the ticket and the exit count and moves the epoch on.
__device__ void leave(int* state, int epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int blocks = gridDim.x * gridDim.y;
    if (atomicAdd(&state[kExited], 1) == blocks - 1) {
      state[kTicket] = 0;
      state[kExited] = 0;
      state[kEpoch] = (epoch + 1) & kEpochMask;
      __threadfence();
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  int spins = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (++spins > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" : : "r"(smem_addr(bar)) : "memory");
}

// The ring as one side sees it: S stages of kStageRows rows of three arrays
// (key, partner, order), a full and an empty barrier and kMetaInts words of
// metadata per stage, and this side's stage and phase.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int* meta;
  int* rows;
  int S;
  int stage;
  uint32_t phase;

  __device__ int* stage_rows() const { return rows + stage * 3 * kStageRows; }
  __device__ int* stage_meta() const { return meta + stage * kMetaInts; }
  __device__ void advance() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Producer (one warp): fill the next stage with rows [a, a + n_copy) of
// `st` (valid rows [lo, hi) of it) and its metadata. Lane 0 waits for the
// stage to be free, writes the metadata, sets the bytes the full barrier
// expects and issues one bulk copy per array.
__device__ void push(Ring& r, int kind, bool plus, bool last, const Stream* st, int lo, int hi,
                     int a, int n_copy, int q, int j, int t, int off) {
  if ((threadIdx.x & 31) == 0) {
    wait_parity(&r.empty[r.stage], r.phase ^ 1);
    int* m = r.stage_meta();
    m[0] = kind | (plus ? 4 : 0) | (last ? 8 : 0);
    m[1] = lo;
    m[2] = hi;
    m[3] = a;
    m[4] = q;
    m[5] = j;
    m[6] = t;
    m[7] = off;
    uint64_t* full = &r.full[r.stage];
    const uint32_t bytes = static_cast<uint32_t>(n_copy) * 4;
    if (bytes == 0) {
      arrive(full);
    } else {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   : : "r"(smem_addr(full)), "r"(3 * bytes) : "memory");
      const int32_t* src[3] = {st->key + a, st->partner + a, st->order + a};
      int* dst = r.stage_rows();
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            : : "r"(smem_addr(dst + x * kStageRows)), "l"(src[x]), "r"(bytes), "r"(smem_addr(full))
            : "memory");
      }
    }
  }
  __syncwarp();
  r.advance();
}

// Producer: the rows [lo, hi) of one stream in chunks of kStageRows rows,
// each copied from a multiple of 4 rows to ceil4(hi) (16-byte aligned
// copies; the wrapper leaves 3 rows after the last one a window may name).
// `last` marks the final chunk; with no rows, a `last` emits an empty stage.
__device__ void push_rows(Ring& r, int kind, bool plus, bool last, const Stream& st, int lo, int hi,
                          int q, int j, int t, int off) {
  if (lo >= hi) {
    if (last) push(r, kind, plus, true, &st, 0, 0, 0, 0, q, j, t, off);
    return;
  }
  const int copy_end = (hi + 3) & ~3;
  for (int a = lo & ~3; a < hi; a += kStageRows) {
    push(r, kind, plus, last && a + kStageRows >= hi, &st, max(lo, a), min(hi, a + kStageRows), a,
         min(kStageRows, copy_end - a), q, j, t, off);
  }
}

// First row of [lo, hi) whose key is >= v (one thread).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ key, int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (key[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// First row of [lo, hi) whose key is >= v, searched by the eight lanes of
// this lane's group of eight: 8 probes cut the range into 9 parts a step (7
// steps for 4M rows), and the four groups of a warp search side by side.
// Every lane of the group returns the answer.
__device__ int group_lower_bound(const int32_t* __restrict__ key, int lo, int hi, int v) {
  const int sub = threadIdx.x & 7;
  const int shift = threadIdx.x & 24;  // the group's first lane
  while (__any_sync(0xffffffffu, lo < hi)) {
    const long long n = hi - lo;
    const int probe = lo + static_cast<int>(n * (sub + 1) / 9);
    const bool lt = lo < hi && key[probe] < v;
    const int below = __popc((__ballot_sync(0xffffffffu, lt) >> shift) & 0xffu);
    if (lo < hi) {
      const int new_lo = below == 0 ? lo : lo + static_cast<int>(n * below / 9) + 1;
      hi = below == 8 ? hi : lo + static_cast<int>(n * (below + 1) / 9);
      lo = new_lo;
    }
  }
  return lo;
}

// The producer warp: draw runs until none is left; for each, find its tile
// bounds and stream its rows twice (aggregate pass, then tile by tile).
__device__ void produce(Ring r, const Store& store, const int32_t* params, int* ticket, int Q,
                        int nt, int runs, int R, int T, int k) {
  const int lane = threadIdx.x & 31;
  const Stream none{};
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(ticket, 1);
    g = __shfl_sync(0xffffffffu, g, 0);
    if (g >= Q * runs) {
      push(r, kEndStage, false, true, &none, 0, 0, 0, 0, 0, 0, 0, 0);
      return;
    }
    const int q = g / runs;
    const int j = g - q * runs;
    const int t0 = j * R;
    const int n = min(R, nt - t0);
    const Window w = load_window(store, params, q, k);
    const Stream* streams[2] = {&w.minus, &w.plus};
    // The run's first and last rows in each stream: four searches side by
    // side, eight lanes each (group g: stream g >> 1, end g & 1).
    const int group = lane >> 3;
    const Stream& mine = *streams[group >> 1];
    const int found = group_lower_bound(mine.key, mine.lo, mine.hi,
                                        mine.shift + (t0 + (group & 1) * n) * T);
    int lo[2], hi[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      lo[s] = __shfl_sync(0xffffffffu, found, s * 16);
      hi[s] = __shfl_sync(0xffffffffu, found, s * 16 + 8);
    }
    push_rows(r, kAggStage, false, false, w.minus, lo[0], hi[0], q, j, t0, 0);
    push_rows(r, kAggStage, true, true, w.plus, lo[1], hi[1], q, j, t0, 0);
    // Lane l < 15 holds the minus stream's bound of tile t0 + l + 1, lane
    // 16 + l the plus stream's; searched while the consumers aggregate.
    const int s = lane >> 4;
    const int i = (lane & 15) + 1;
    const int inner = i < n ? lower_bound(streams[s]->key, lo[s], hi[s],
                                          streams[s]->shift + (t0 + i) * T)
                            : 0;
    int from[2] = {lo[0], lo[1]};
    for (int x = 0; x < n; ++x) {
      const int t = t0 + x;
      int to[2];
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int held = __shfl_sync(0xffffffffu, inner, y * 16 + x);
        to[y] = x + 1 == n ? hi[y] : held;
      }
      push_rows(r, kApplyStage, false, false, w.minus, from[0], to[0], q, j, t,
                w.minus.shift + t * T);
      push_rows(r, kApplyStage, true, true, w.plus, from[1], to[1], q, j, t, w.plus.shift + t * T);
      from[0] = to[0];
      from[1] = to[1];
    }
  }
}

// A stage's live rows of the column group [c0, c0 + C) into net[C]
// (aggregate) or into the diff tile at position key - off.
template <bool kPlus, bool kApply>
__device__ void consume_rows(const int* rows, int lo, int hi, int a, int off, int T, int k, int c0,
                             int C, int* cov, int* net) {
  for (int i = lo + threadIdx.x; i < hi; i += kConsumers) {
    const int x = i - a;
    const int key = rows[x];
    const int c =
        live_column<kPlus>(key, rows[kStageRows + x], rows[2 * kStageRows + x], k, c0, C);
    if (c < 0) continue;
    if (kApply) {
      const int p = key - off;
      if (p >= 0 && p < T) atomicAdd(&cov[c * (T + 1) + p], kPlus ? 1 : -1);
    } else {
      atomicAdd(&net[c], kPlus ? 1 : -1);
    }
  }
}

// The consumer warps: take stages until the end stage; after a run's last
// aggregate stage, look back; after a tile's last stage, finish the tile.
// The group's columns are [c0, c0 + C) of ld; membership rows lie ld bytes
// apart in out, and conservation writes first + c0, min-combined with out
// where c0 > 0 (first[T] holds none).
template <bool kMembership>
__device__ void consume(Ring r, int* status, int32_t* sums, const int32_t* prefix, int L, int c0,
                        int C, int ld, int T, int k, int none, int runs, int epoch, int* cov,
                        int* carry, int* net, int* first, int* code, void* out) {
  const int warp = threadIdx.x >> 5;
  const int S = T + 1;
  for (;;) {
    wait_parity(&r.full[r.stage], r.phase);
    const int* m = r.stage_meta();
    const int head = m[0], lo = m[1], hi = m[2], a = m[3], q = m[4], j = m[5], t = m[6];
    const int off = m[7];
    const int kind = head & 3;
    const bool plus = head & 4;
    const int* rows = r.stage_rows();
    if (kind == kAggStage) {
      if (plus) consume_rows<true, false>(rows, lo, hi, a, off, T, k, c0, C, cov, net);
      else consume_rows<false, false>(rows, lo, hi, a, off, T, k, c0, C, cov, net);
    } else if (kind == kApplyStage) {
      if (plus) consume_rows<true, true>(rows, lo, hi, a, off, T, k, c0, C, cov, net);
      else consume_rows<false, true>(rows, lo, hi, a, off, T, k, c0, C, cov, net);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) arrive(&r.empty[r.stage]);
    r.advance();
    if (kind == kEndStage) return;
    if (!(head & 8)) continue;
    consumer_sync();
    if (kind == kAggStage) {
      look_back(status, sums, prefix + static_cast<size_t>(q) * ld, static_cast<size_t>(q) * runs,
                j, net, carry, C, epoch, code);
      for (int c = threadIdx.x; c < C; c += kConsumers) net[c] = 0;
      continue;  // the tile's scatter ends in a consumer_sync before carry is read
    }
    const int base = t * T;
    const int rows_out = min(T, L - base);
    const size_t out_row = static_cast<size_t>(q) * L + base;
    if constexpr (kMembership) {
      scan_tile<kConsumerWarps, true>(cov, carry, T, S, C, warp);
      consumer_sync();
      reduce_membership<kConsumerWarps>(cov, S, C, rows_out,
                                        static_cast<int8_t*>(out) + out_row * ld, ld, warp);
      consumer_sync();
      for (int i = threadIdx.x; i < C * S; i += kConsumers) cov[i] = 0;
      consumer_sync();
    } else {
      scan_conservation<kConsumerWarps, true, true>(cov, carry, first, T, S, C, none, warp);
      consumer_sync();
      int32_t* o = static_cast<int32_t*>(out) + out_row;
      for (int p = threadIdx.x; p < T; p += kConsumers) {
        if (p < rows_out) o[p] = conservation_out(o[p], first[p], c0);
        first[p] = none;
      }
    }
  }
}

template <bool kMembership>
__global__ void __launch_bounds__(kThreads)
fused_query_v2_kernel(Store store, const int32_t* __restrict__ params, const int32_t* __restrict__ prefix,
               int* __restrict__ state, int32_t* __restrict__ sums, int Q, int L, int c0, int C,
               int ld, int T, int k, int none, int R, int S, void* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  int* meta = reinterpret_cast<int*>(empty + kMaxStages);
  int* ring = reinterpret_cast<int*>(smem_raw + kRingHeader);
  int* cov = ring + S * 3 * kStageRows;  // [C][T + 1]
  int* carry = cov + C * (T + 1);        // [C]
  int* net = carry + C;                  // [C]
  int* first = net + C;                  // [T]
  int* epoch_word = first + T;           // [1]
  int* code = epoch_word + 1;            // [1]: look_back's word
  const int nt = (L + T - 1) / T;
  const int runs = (nt + R - 1) / R;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   : : "r"(smem_addr(&full[s])), "r"(1) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   : : "r"(smem_addr(&empty[s])), "r"(kConsumerWarps) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
    *epoch_word = *static_cast<volatile int*>(&state[kEpoch]);
  }
  for (int i = threadIdx.x; i < C * (T + 1); i += blockDim.x) cov[i] = 0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) net[c] = 0;
  for (int p = threadIdx.x; p < T; p += blockDim.x) first[p] = none;
  __syncthreads();
  const int epoch = *epoch_word;
  const Ring r{full, empty, meta, ring, S, 0, 0};
  if (threadIdx.x >= kConsumers) {
    produce(r, store, params, &state[kTicket], Q, nt, runs, R, T, k);
  } else {
    consume<kMembership>(r, state + kStatus, sums, prefix, L, c0, C, ld, T, k, none, runs, epoch,
                         cov, carry, net, first, code, out);
  }
  leave(state, epoch);
}

// Shared memory of one block: the ring, the tile, carry, aggregate, first
// marked columns, the epoch and look_back's word.
size_t smem_bytes(int C, int T, int S) {
  return kRingHeader + static_cast<size_t>(S) * 3 * kStageRows * sizeof(int) +
         (static_cast<size_t>(C) * (T + 1) + 2 * C + T + 2) * sizeof(int);
}

// The kernel over the column group [c0, c0 + G) of the store's C columns.
template <bool kMembership>
cudaError_t launch(cudaStream_t stream, const Store& store, const int32_t* params,
                   const int32_t* prefix, int* state, int32_t* sums, int Q, int L, int C, int c0,
                   int G, int T, int S, int k, int n_docs, void* out) {
  const size_t smem = smem_bytes(G, T, S);
  cudaError_t err = cudaFuncSetAttribute(fused_query_v2_kernel<kMembership>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_query_v2_kernel<kMembership>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = per_sm * sms;  // every block resident
  // Runs of R tiles: as long as keeps every block busy (one run each), at
  // most kMaxRun. Longer runs pay fewer searches and look-backs; a block's
  // runs are drawn one ahead, so many short runs chain their waits (PERF.md).
  const long long tiles = static_cast<long long>(Q) * ((L + T - 1) / T);
  long long R = (tiles + grid - 1) / grid;
  R = R < 1 ? 1 : (R > kMaxRun ? kMaxRun : R);
  void* group_out = kMembership ? static_cast<void*>(static_cast<int8_t*>(out) + c0) : out;
  fused_query_v2_kernel<kMembership><<<grid, kThreads, smem, stream>>>(
      store, params, prefix + c0, state, sums, Q, L, c0, G, C, T, k, n_docs - c0,
      static_cast<int>(R), S, group_out);
  return cudaGetLastError();
}

}  // namespace

// Query Q windows of L positions on `stream` from the placed store's six
// row arrays, each holding n_rows + 3 rows (the bulk copies read up to 3
// rows past a window's last), over the store's columns [c0, c0 + G) of its
// C. params is int32[Q, 5] (mlo, mhi, plo, phi, qs per window), prefix
// int32[Q, C]; state is int32[4 + Q * nt] (nt = ceil(L / tile)), zeroed
// once when it was allocated and left for the next launch on this device;
// sums is int32[Q * nt * 2 * G] scratch; out is int32[Q, L] (c0 plus the
// group's first marked column, or n_docs, min-combined with out where
// c0 > 0) or int8[Q, L, C] (columns [c0, c0 + G) written); the ring has `stages` stages. Returns the CUDA error code of
// the first call that failed, 0 when all were accepted.
extern "C" int memo_fused_query_v2_rows(const int32_t* start, const int32_t* end,
                                        const int32_t* order, const int32_t* end_s,
                                        const int32_t* start_by_end,
                                        const int32_t* order_by_end, const int32_t* params,
                                        const int32_t* prefix, int32_t* state, int32_t* sums,
                                        void* out, int n_rows, int Q, int L, int C, int c0,
                                        int G, int k, int tile, int stages, int n_docs,
                                        int membership, void* stream) {
  if (n_rows < 0 || Q < 1 || L < 1 || c0 < 0 || G < 1 || c0 + G > C || k < 1 || tile < 32 ||
      tile % 32 != 0 || tile > 32 * kMaxChunks || stages < 2 || stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Store store{start, end, order, end_s, start_by_end, order_by_end, n_rows};
  return membership ? launch<true>(s, store, params, prefix, state, sums, Q, L, C, c0, G, tile,
                                   stages, k, n_docs, out)
                    : launch<false>(s, store, params, prefix, state, sums, Q, L, C, c0, G, tile,
                                    stages, k, n_docs, out);
}
