"""The reader of ``event_tiles_pct.*`` (``metrics/event_tiles_pct.py``): on a
synthetic traced run it gives 100 x ``memo.event_tiles`` / ``memo.apply_tiles``;
it gives nothing on an untraced run, where no tile ran, or where the program
has no such counters (the port before its event path); the two entries name
it with their cells; and a traced rehearsal on the CPU, whose launches run
the plain version, counts no tile and reports nothing for it."""

import json
import time

import pytest

from memo_tpu_torch.utils import profiling
from portbench import harness
from portbench.tests import tiny
from portbench.tests.test_portbench_program import read, synthetic_run

NAMES = ("event_tiles_pct.query", "event_tiles_pct.regions")


@pytest.mark.parametrize("name", NAMES)
def test_the_share_of_event_tiles(monkeypatch, name):
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"memo.event_tiles": 957, "memo.apply_tiles": 1_000})
    assert read(name, synthetic_run()) == pytest.approx(95.7)


@pytest.mark.parametrize("counts", [{"memo.event_tiles": 0, "memo.apply_tiles": 0},
                                    {"memo.event_tiles": 3}, {"memo.apply_tiles": 8}, {}])
def test_nothing_where_no_tile_ran_or_nothing_counted(monkeypatch, counts):
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert read("event_tiles_pct.query", synthetic_run()) is None


def test_a_dense_run_reads_zero(monkeypatch):
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"memo.event_tiles": 0, "memo.apply_tiles": 64})
    assert read("event_tiles_pct.regions", synthetic_run()) == 0


def test_nothing_untraced_or_without_counters(monkeypatch):
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"memo.event_tiles": 1, "memo.apply_tiles": 2})
    run = synthetic_run()
    run.trace = None
    assert read("event_tiles_pct.query", run) is None
    monkeypatch.delattr(profiling, "counters")
    assert read("event_tiles_pct.query", synthetic_run()) is None


def test_the_entries_name_the_reader_and_its_cells():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        m = entries[name]
        query = name.endswith("query")
        assert m["workloads"] == (["mhc90.locus", "chr90.locus"] if query
                                  else ["chr90.genes", "mhc90.genes"])
        assert m["moves"] == ("query_mbps" if query else "regions_windows_per_s")
        assert (m["unit"], m["better"], m["source"], m["layer"]) == (
            "%", "higher", "program_counter", "ops.fused_query")
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("cell", ["chr90.locus", "mhc90.genes"])
def test_a_cpu_rehearsal_counts_no_tile(tmp_path, cell):
    root = tiny.copy(tmp_path)
    profiling.reset_counters()
    result = harness.run_cell(root, cell, 2**32 + 9, 0.5, True, "cpu", time.perf_counter())
    assert result["correct"] is True
    assert not any(name.startswith("event_tiles_pct") for name in result["metrics"])
    counted = profiling.counters()
    assert "memo.event_tiles" not in counted and "memo.apply_tiles" not in counted
    assert counted.get("memo.positions_launched", 0) > 0  # the launches did count
