"""The generator's columns equal the program's own index builder
(``store_from_ms``) over the MS matrix of the same anchors, built as
``chip_smoke.synth_ms`` builds it."""

import numpy as np
import pytest

from memo_tpu_torch.index.builder import store_from_ms
from portbench.gen import synth_ms_overlaps as gen


def synth_ms_of(pos: np.ndarray, value: np.ndarray, length: int) -> np.ndarray:
    """synth_ms's transform of its anchors: far sentinels, anchors set, the
    suffix minimum of (value + position), less the position, capped at the
    record's end."""
    ms = np.full((length, pos.shape[0]), 1 << 28, np.int64)
    for c in range(pos.shape[0]):
        ms[pos[c], c] = value[c]
    idx = np.arange(length)[:, None]
    ms = np.minimum.accumulate((ms + idx)[::-1], axis=0)[::-1] - idx
    return np.minimum(ms, length - idx).astype(np.int32)


CASES = [  # (record_len, n_docs, gap, seed)
    (20_000, 7, 25, 2**31 + 5),
    (30_001, 12, 25, 7),
    (50_000, 5, 1100, 123),
    (9_000, 3, 3, 2**40 + 1),
]


@pytest.mark.parametrize("length,n_docs,gap,seed", CASES)
@pytest.mark.parametrize("chunk", [gen.CHUNK_ROWS, 4_096, 997])
def test_columns_equal_store_from_ms(length, n_docs, gap, seed, chunk):
    cfg = {"record": "chr1", "record_len": length, "n_docs": n_docs, "gap": gap,
           "match_min": 8, "match_max": 120}
    pos, value = gen.anchors(cfg, seed, "cpu")
    assert pos.shape == (n_docs - 1, length // gap)
    assert all(len(set(row.tolist())) == row.numel() for row in pos)  # distinct
    assert bool((pos[:, 1:] > pos[:, :-1]).all()) and int(value.min()) >= 8 and int(value.max()) < 120
    store = store_from_ms([synth_ms_of(pos.numpy(), value.numpy(), length)], ["chr1"], [length],
                          n_docs, "conservation")
    start, end, order = gen.columns_of_anchors(pos, value, length, chunk)
    assert np.array_equal(start.numpy(), store.start)
    assert np.array_equal(end.numpy(), store.end)
    assert np.array_equal(order.numpy(), store.order)


def test_generate_is_the_seeds():
    cfg = {"record": "chr1", "record_len": 20_000, "n_docs": 6, "gap": 25,
           "match_min": 8, "match_max": 120}
    a, b, c = (gen.generate(cfg, s, "cpu") for s in (5, 5, 6))
    assert np.array_equal(a.start, b.start) and np.array_equal(a.order, b.order)
    assert not (a.start.size == c.start.size and np.array_equal(a.start, c.start))
    assert a.start.dtype == np.int64 and a.end.dtype == np.int64 and a.order.dtype == np.int32
    assert bool(np.all(np.diff(a.start) >= 0)) and a.longest == int((a.end - a.start).max())
