// The event streams of a batch of query windows, as the v2 kernel reads them
// (memo_tpu_torch/ops/fused_query.py::prepare_streams lays them out): for
// window q, the minus stream pos_m/val_m holds m_stride events from
// q * m_stride and the plus stream p_stride events from q * p_stride; tile t
// of window q reads events [off[q][t], off[q][t + 1]) of each stream, with
// off holding nt + 1 entries per window.
#pragma once

#include <cstddef>
#include <cstdint>

struct EventStreams {
  const int32_t* pos_m;
  const int32_t* val_m;
  const int32_t* off_m;
  const int32_t* pos_p;
  const int32_t* val_p;
  const int32_t* off_p;
  int m_stride;
  int p_stride;
  int nt;

  // The same streams seen from window q: every pointer moved to its row.
  __device__ EventStreams window(int q) const {
    EventStreams w = *this;
    const size_t off = static_cast<size_t>(q) * (nt + 1);
    w.pos_m += static_cast<size_t>(q) * m_stride;
    w.val_m += static_cast<size_t>(q) * m_stride;
    w.pos_p += static_cast<size_t>(q) * p_stride;
    w.val_p += static_cast<size_t>(q) * p_stride;
    w.off_m += off;
    w.off_p += off;
    return w;
  }
};

// Events outside a tile's T positions or with no live column are ignored, so
// a malformed offset range can never write outside a shared tile.
__device__ __forceinline__ bool live_event(int v, int p, int T, int C) {
  return v > 0 && v <= C && p >= 0 && p < T;
}
