// The fused kernels' window parameters, found on the card (sm_90a).
//
// No TPU kernel stands behind this one: memo_tpu finds these parameters on
// the host (memo_tpu/query/engine.py::_window_params, :385-400, and
// memo_tpu/index/store.py::QueryLayout.prefix_counts, :253-278), and the
// port's plain version does the same searches as torch operations
// (memo_tpu_torch/query/window.py::window_params_reference). For window w,
// [qs, qs + L) of record r at k, over the placed rows of the record, rows
// [rec_lo, rec_lo + rec_n) of each order:
//
//   mlo = rec_lo + #(start <= qs)          mhi = rec_lo + #(start <= qs + L - 1)
//   plo = rec_lo + #(end <= qs + k - 1)    phi = rec_lo + #(end <= qs + L + k - 2)
//
// (searchsorted "right", and "left" as "right" of the value less one), and
// the coverage entering position 0 per column c:
//
//   monotone store: #(e_keys <= key(c) + min(qs + k - 1, stride - 1))
//                   - #(s_keys <= key(c) + qs), at least 0, for c >= 1;
//                   column 0 is 0; key(c) = (r * C + c) * stride
//   other stores:   #(rows of the record with end <= qs + k - 1,
//                   start > qs and order == c)
//
// One block per window. Threads 0-3 run the four range searches and thread
// 4 writes qs; the block's threads take the columns, two searches each over
// the composite keys, or scan the record's rows into a shared histogram.
// Comparisons are in 64 bits, so no probe is clamped. The output is one
// int32 buffer: params [Q][5] (mlo, mhi, plo, phi, qs), the candidate
// counts [2][Q] (mhi - mlo, phi - plo) and the prefix [Q][C].
//
// What bounds it: each search reads about log2(rows) words, so a window
// costs (4 + 2(C - 1)) x log2(rows) dependent loads: latency, not bytes or
// operations. What it replaces on the card is a dozen torch operations,
// each a launch of its own (PERF.md, section 6).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHistBytes = 48 * 1024;  // shared memory without an opt-in

template <typename T>
__device__ __forceinline__ long long count_at_most(const T* __restrict__ a, long long n,
                                                   long long v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(a[mid]) <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Args {
  const int32_t* start;      // placed rows, start order
  const int32_t* end;
  const int32_t* order;
  const int32_t* end_s;      // placed ends, end order
  const int64_t* s_keys;     // composite keys of the (record, order) segments
  const int64_t* e_keys;
  const int64_t* starts;     // [Q] window starts
  int32_t* out;              // params [Q][5] | counts [2][Q] | prefix [Q][C]
  long long rec_lo, rec_n, n_keys, L, k, stride, first_key;
  int Q, C, monotone;
};

__global__ void __launch_bounds__(kThreads) window_params_kernel(const Args a) {
  extern __shared__ int hist[];  // [C], the scan's histogram
  __shared__ long long found[4];
  const int w = blockIdx.x;
  const long long qs = a.starts[w];
  const int t = threadIdx.x;
  if (t < 4) {
    const int32_t* rows = (t < 2 ? a.start : a.end_s) + a.rec_lo;
    const long long probe = qs + (t == 1 ? a.L - 1 : t == 2 ? a.k - 1 : t == 3 ? a.L + a.k - 2 : 0);
    found[t] = count_at_most(rows, a.rec_n, probe);
    a.out[5LL * w + t] = static_cast<int32_t>(a.rec_lo + found[t]);
  } else if (t == 4) {
    a.out[5LL * w + 4] = static_cast<int32_t>(qs);
  }
  int32_t* prefix = a.out + 7LL * a.Q + static_cast<long long>(w) * a.C;
  if (a.monotone) {
    const long long e0 = min(qs + a.k - 1, a.stride - 1);
    for (int c = t; c < a.C; c += kThreads) {
      long long v = 0;
      if (c > 0) {
        const long long key = a.first_key + c * a.stride;
        v = count_at_most(a.e_keys, a.n_keys, key + e0) -
            count_at_most(a.s_keys, a.n_keys, key + qs);
      }
      prefix[c] = static_cast<int32_t>(v > 0 ? v : 0);
    }
  } else {
    for (int c = t; c < a.C; c += kThreads) hist[c] = 0;
    __syncthreads();
    const long long e0 = qs + a.k - 1;
    for (long long i = t; i < a.rec_n; i += kThreads) {
      const long long row = a.rec_lo + i;
      const int o = a.order[row];
      if (o >= 0 && o < a.C && a.end[row] <= e0 && a.start[row] > qs) atomicAdd(&hist[o], 1);
    }
    __syncthreads();
    for (int c = t; c < a.C; c += kThreads) prefix[c] = hist[c];
  }
  __syncthreads();
  if (t == 0) {
    a.out[5LL * a.Q + w] = static_cast<int32_t>(found[1] - found[0]);
    a.out[6LL * a.Q + w] = static_cast<int32_t>(found[3] - found[2]);
  }
}

}  // namespace

extern "C" int memo_window_params(const int32_t* start, const int32_t* end, const int32_t* order,
                                  const int32_t* end_s, const int64_t* s_keys,
                                  const int64_t* e_keys, const int64_t* starts, int32_t* out,
                                  long long rec_lo, long long rec_n, long long n_keys, long long L,
                                  long long k, long long stride, long long first_key, int Q, int C,
                                  int monotone, void* stream) {
  const size_t hist_bytes = monotone ? 0 : static_cast<size_t>(C) * sizeof(int);
  if (Q < 1 || C < 1 || rec_lo < 0 || rec_n < 0 || n_keys < 0 || hist_bytes > kMaxHistBytes) {
    return cudaErrorInvalidValue;
  }
  const Args a{start, end, order, end_s, s_keys, e_keys, starts, out,
               rec_lo, rec_n, n_keys, L, k, stride, first_key, Q, C, monotone};
  window_params_kernel<<<Q, kThreads, hist_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
