"""run.py's control flow on the CPU at a tiny size: every cell, untraced
and traced, gives a result line of the contract's keys with ``correct``
true, its end-to-end or per-layer metrics by name, and the numbers compared
last. The look for a CUDA device is skipped (``run_cell`` on "cpu"); the
device metrics read nothing there and are left out."""

import json
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny.cells())
def test_a_run_of_each_cell(root, cell, trace):
    result = harness.run_cell(root, cell, 2**31 + 17, 0.5, trace, "cpu", time.perf_counter())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"]["mismatched_positions"]["value"] == 0
    assert result["checks"]["windows_checked"]["value"] >= 2
    bench = json.loads((root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    mine = {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) <= mine
    if trace:
        assert "engine_init_s" in result["metrics"] and "breakdown" in result
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
        for m in result["metrics"].values():
            assert m["value"] > 0


def test_the_same_seed_asks_for_the_same_work(root):
    cell = harness.load_cell(root, "mhc90.locus")
    driver = harness.plugin(root, "drivers", cell.traffic["driver"])
    a, b, c = (driver.stream(cell.traffic, tiny.RECORD_LEN, s) for s in (3, 3, 4))
    first = [next(a) for _ in range(200)]
    assert first == [next(b) for _ in range(200)]
    other = [next(c) for _ in range(200)]
    assert first != other
    block = cell.traffic["block"]
    size = sorted(sorted(qe - qs for qs, qe in r.windows)[0] for r in first[:block])
    assert size == sorted(sorted(qe - qs for qs, qe in r.windows)[0] for r in other[:block])


def test_without_a_card_run_py_exits_without_a_result(root):
    """Here there is no CUDA device: run.py says so and prints no result."""
    got = subprocess.run([sys.executable, str(tiny.REPO / "portbench" / "run.py"), "--workload",
                          "mhc90.locus", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "CUDA" in got.stderr
