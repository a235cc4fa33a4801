"""memo_tpu's own ``QueryStats`` of a query, a batch or a stratified query
on its fused (``pallas``) backend, with its kernels stood in for by zeros:
what its halving counts, at any ``max_intervals_per_chunk``, without
compiling a Pallas program. The port's ``last_stats`` is held to these.

memo_tpu leaves two gaps that the port fills as its own per-window path
sums: a batch over the cap runs window by window and keeps only the last
window's stats, and a stratified batch sets none; here both are the sums
of memo_tpu's per-window (and per-bucket) stats."""

from __future__ import annotations

import numpy as np
import pytest

from memo_tpu.query import engine as jax_engine_mod
from memo_tpu.query.engine import QueryEngine as JaxEngine

FIELDS = ("candidate_intervals", "chunks", "positions")


def _zeros(L: int, n: int, membership: bool, lead: tuple = ()) -> np.ndarray:
    return np.zeros(lead + ((L, n) if membership else (L,)), np.int8 if membership else np.int32)


def _stubbed(mp: pytest.MonkeyPatch, launched: list) -> None:
    """memo_tpu's device programs as zeros of their output shapes; each
    batched program run appends to ``launched``."""
    import memo_tpu.ops.pallas_query as v1
    import memo_tpu.ops.pallas_query_v2 as v2

    def kernel(*args, L, C, membership, **kwargs):
        return _zeros(L, C, membership)

    def batched(Q, M, L, n, membership, *args):
        def run(*inputs):
            launched.append(Q)
            return _zeros(L, n, membership, (Q,))

        return run

    mp.setattr(v1, "memo_query_pallas", kernel)
    mp.setattr(v2, "memo_query_pallas_v2", kernel)
    mp.setattr(jax_engine_mod, "_batched_query_fn", batched)
    mp.setattr(JaxEngine, "_run_device_range",
               lambda self, record, qs, k, membership, lo, M, L: _zeros(L, self.n_docs, membership))


def _add(total: dict, stats) -> dict:
    return {f: total[f] + getattr(stats, f) for f in FIELDS}


def memo_tpu_stats(store, record: str, k: int, *, cap: int | None = None,
                   chunk_positions: int | None = None, stratify: bool = False,
                   region: tuple[int, int] | None = None, windows=None,
                   membership: bool = False) -> dict:
    """memo_tpu's stats of the query of ``region`` or of the batch of
    ``windows`` of ``record`` at ``k``, as a dict."""
    launched: list = []
    with pytest.MonkeyPatch.context() as mp:
        _stubbed(mp, launched)
        eng = JaxEngine(store, backend="pallas", chunk_positions=chunk_positions,
                        max_intervals_per_chunk=cap, stratify=stratify)
        if region is not None:
            eng._query(record, *region, k, membership)
            return eng.last_stats.as_dict()
        windows = [(int(qs), int(qe)) for qs, qe in windows]
        engines = ([eng] if eng._children is None
                   else [child for lb, child in eng._children if lb < k - 1])
        total = dict.fromkeys(FIELDS, 0)
        for one in engines:
            launched.clear()
            one._query_batch(record, windows, k, membership)
            if launched:
                total = _add(total, one.last_stats)
                continue
            for qs, qe in windows:  # memo_tpu's per-window fallback, summed
                one._query(record, qs, qe, k, membership)
                total = _add(total, one.last_stats)
        return total | {"positions": sum(qe - qs for qs, qe in windows)}
