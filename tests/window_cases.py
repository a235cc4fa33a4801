"""The stores and windows of the window-parameter tests
(``test_torch_window_params.py`` against memo_tpu on the CPU,
``test_torch_window_params_card.py`` on the card), built with the port's
own index builder and numpy only, so that the card's test imports no JAX."""

import numpy as np

from memo_tpu_torch.index.builder import store_from_ms

REC_LEN = 400
HUGE_K = (1 << 31) + 7  # probes past int32 and past every key stride
# One column past the 12,288 int32 counters of the window kernel's shared
# histogram (csrc/window_params.cu): its scan then counts in device memory.
WIDE_SCAN_C = 12_289


def lipschitz(ms: np.ndarray) -> np.ndarray:
    """Matching statistics drop by at most 1 a position: min_{q>=p}(ms[q]+q) - p."""
    idx = np.arange(ms.shape[0], dtype=np.int64)[:, None]
    return (np.minimum.accumulate((ms + idx)[::-1])[::-1] - idx).astype(np.int32)


def random_rows(rng, recs, n, span_hi, C, order_lo=0, order_hi=None):
    """Random rows of ``recs``, sorted by (record, start, end) as a store is."""
    rec = rng.choice(np.asarray(recs), n)
    start = rng.integers(0, REC_LEN, n)
    end = start + rng.integers(0, span_hi, n)
    order = rng.integers(order_lo, C if order_hi is None else order_hi, n)
    keep = np.lexsort((end, start, rec))
    return rec[keep], start[keep], end[keep], order[keep]


def case_arrays(case: str) -> dict:
    rng = np.random.default_rng(sum(map(ord, case)))
    names = ["chr0", "chr1", "chr2"]
    if case.startswith("ms_"):  # true matching statistics: the monotone (keys) path
        n_rec, C = {"ms_one": (1, 6), "ms_records": (3, 9), "ms_wide": (2, 33)}[case]
        ms = [lipschitz(rng.integers(0, 60, (REC_LEN, C - 1))) for _ in range(n_rec)]
        st = store_from_ms(ms, names[:n_rec], [REC_LEN] * n_rec, C, "conservation")
        return dict(record_names=names[:n_rec], record_lens=[REC_LEN] * n_rec, n_docs=C,
                    rec_id=st.rec_id, start=st.start, end=st.end, order=st.order)
    C = WIDE_SCAN_C if case == "non_monotone_wide" else 7
    if case == "non_monotone":
        rows = random_rows(rng, [0, 1, 2], 900, 150, C)
    elif case == "non_monotone_wide":  # the last 4 of 12,289 columns, many rows each
        rows = random_rows(rng, [0, 1, 2], 900, 150, C, order_lo=C - 4)
    elif case == "orders_out_of_range":  # -1 and >= C: the scan path, rows dropped
        rows = random_rows(rng, [0, 1, 2], 700, 40, C, order_lo=-1, order_hi=C + 2)
    elif case == "empty_record":  # chr1 holds no row
        rows = random_rows(rng, [0, 2], 600, 60, C)
    elif case == "ends_2x":  # ends up to twice a record's length
        rows = random_rows(rng, [0, 1, 2], 600, 2 * REC_LEN, C)
    elif case == "empty_store":
        rows = (np.zeros(0, np.int64),) * 4
    else:
        raise ValueError(case)
    rec, start, end, order = rows
    return dict(record_names=names, record_lens=[REC_LEN] * 3, n_docs=C, rec_id=rec, start=start,
                end=end, order=order)


CASES = ["ms_one", "ms_records", "ms_wide", "non_monotone", "non_monotone_wide",
         "orders_out_of_range", "empty_record", "ends_2x", "empty_store"]


# (L, starts): windows at 0, inside, at and past the record's end; one
# position, a batch of one length, the whole record.
WINDOWS = ((1, (0, 1, 199, REC_LEN - 1, REC_LEN, REC_LEN + 50)),
           (37, (0, 17, REC_LEN - 37, REC_LEN - 5, 2 * REC_LEN)),
           (REC_LEN, (0,)))
