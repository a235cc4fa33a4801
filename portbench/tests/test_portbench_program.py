"""The readers of the program's own spans and counters (``program.py`` and
``metrics/copy_back_ms.py``, ``queue_ms.py``, ``copy_back_x.py``,
``launched_x.py``, ``candidate_rows_x.py``): on a synthetic traced run they
give the arithmetic of their docstrings; on a program that records no span
and has no counters (the port before its tracing) they give nothing and do
not raise; and a traced rehearsal on the CPU reports each of a cell's."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from memo_tpu_torch.utils import profiling
from portbench import harness, program
from portbench import trace as tracing
from portbench.tests import tiny

NEW = ("copy_back_ms.query", "copy_back_ms.regions", "queue_ms.query", "copy_back_x.regions",
       "launched_x.regions", "candidate_rows_x.query")


def event(name, start, end, device="CPU", thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=f"DeviceType.{device}", thread=thread)


def synthetic_run(spans=True, rows=1_000, positions=500) -> harness.Run:
    """Two traced requests, [0, 100) and [100, 200) us, and what ran inside
    them; with ``spans``, the program's spans too."""
    events = [event(tracing.ANNOTATION, 0, 100), event(tracing.ANNOTATION, 100, 200),
              event("rows_apply_kernel", 30, 60, "CUDA"),
              event("Memcpy DtoH (Device -> Pageable)", 60, 88, "CUDA"),
              event("rows_apply_kernel", 140, 160, "CUDA")]
    if spans:
        events += [event("memo.query", 5, 95), event("memo.window_step", 10, 20),
                   event("memo.launch", 20, 30), event("memo.launch", 25, 28),
                   event("memo.copy_back", 40, 90), event("memo.copy_back", 150, 190),
                   event("memo.copy_back", 210, 220),  # after the window
                   event("memo.launch", 120, 140, thread=2)]  # no request on its thread
    run = harness.Run(None, None, "NVIDIA H100 80GB HBM3", None, 1.0, 1.0, [], 1.0,
                      tracing.Trace(events), 2)
    run.__dict__["traced_work"] = (rows, positions)
    return run


def read(name, run):
    return harness.plugin(tiny.REPO, "metrics", name).read(run)


def test_span_readers_give_their_arithmetic():
    run = synthetic_run()
    # copy-back: (40, 90) less the kernel (40, 60), (150, 190) less (150, 160); two requests
    assert read("copy_back_ms.query", run) == pytest.approx((30 + 30) / 2 / 1e3)
    assert read("copy_back_ms.regions", run) == read("copy_back_ms.query", run)
    # queue: the union of (10, 20), (20, 30) and (25, 28) inside it
    assert read("queue_ms.query", run) == pytest.approx(20 / 2 / 1e3)
    assert np.array_equal(program.spans(run.trace, "memo.copy_back"), [[40, 90], [150, 190]])


def test_counter_readers_give_their_ratios(monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {
        "memo.copy_back_bytes": 25 * 4 * 500, "memo.positions_launched": 24 * 500,
        "memo.candidate_rows": 3 * 1_000})
    run = synthetic_run()
    assert read("copy_back_x.regions", run) == 25
    assert read("launched_x.regions", run) == 24
    assert read("candidate_rows_x.query", run) == 3


def test_a_program_without_spans_or_counters_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "counters")
    run = synthetic_run(spans=False)
    assert [read(name, run) for name in NEW] == [None] * len(NEW)
    run.trace = None
    assert [read(name, run) for name in NEW] == [None] * len(NEW)


def test_a_counter_the_program_did_not_count_gives_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda: {})
    run = synthetic_run()
    assert read("copy_back_x.regions", run) is None and read("candidate_rows_x.query", run) is None


def test_the_entries_name_their_readers_and_cells():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        cells = ["mhc90.locus", "chr90.locus"] if name.endswith("query") else [
            "chr90.genes", "mhc90.genes"]
        assert m["workloads"] == cells
        assert m["source"] == ("program_span" if "_ms" in name else "program_counter")
        assert m["moves"] == ("query_mbps" if name.endswith("query") else "regions_windows_per_s")
    assert list(entries)[-len(NEW):] == list(NEW)  # appended, after the accepted ones


@pytest.mark.parametrize("cell", ["mhc90.locus", "chr90.genes"])
def test_a_traced_rehearsal_reports_each_of_its_cells(tmp_path, cell):
    root = tiny.copy(tmp_path)
    profiling.reset_counters()
    result = harness.run_cell(root, cell, 2**33 + 5, 0.5, True, "cpu", time.perf_counter())
    mine = [m["name"] for m in harness.load_cell(root, cell).per_layer if m["name"] in NEW]
    assert len(mine) == 3
    for name in mine:
        assert result["metrics"][name]["value"] > 0, name
    if cell == "chr90.genes":  # one launch a batch at its longest window, copied back whole
        m = result["metrics"]
        assert m["copy_back_x.regions"]["value"] == pytest.approx(m["launched_x.regions"]["value"])
