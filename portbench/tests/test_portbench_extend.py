"""A new configuration, traffic mix and metric need new files and entries
only: in a copy of the benchmark, a dummy set is added (a configuration
file, a traffic file of an existing driver, a metric reader, and their
entries in BENCHMARK.json), no file that was there changes, and a run of
the new cell reports the new metric beside the old ones."""

import hashlib
import json
import time

from portbench import harness
from portbench.tests import tiny


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def test_a_dummy_cell_needs_only_new_files(tmp_path):
    root = tiny.copy(tmp_path)
    before = digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())

    cfg = json.loads((root / "portbench/configs/hprc90-mhc.json").read_text())
    cfg.update(name="dummy-cfg", record="dummy", record_len=50_000, n_docs=5, gap=40)
    (root / "portbench/configs/dummy-cfg.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/dummy_mix.json").write_text(json.dumps(
        {"driver": "locus", "length_min": 100, "length_max": 5_000, "block": 4,
         "k_per_block": [[15, 2], [40, 2]], "sample": 3}))
    (root / "portbench/metrics/dummy_requests.py").write_text(
        "def read(run):\n    return len(run.done)\n")
    bench["configs"].append({"name": "dummy-cfg", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy-cfg.json", "reduced": [],
                             "why": "a dummy"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-cfg", "traffic": "dummy_mix",
                               "chips": 1, "why": "a dummy"})
    bench["end_to_end"].append({"name": "dummy_requests", "unit": "requests", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "query_mbps":
            m["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digests(root)
    assert {p: after[p] for p in before} == before  # nothing that was there changed
    assert len(after) == len(before) + 3
    result = harness.run_cell(root, "dummy.cell", 8, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"] is True
    assert set(result["metrics"]) == {"dummy_requests", "query_mbps", "setup_s"}
    assert result["metrics"]["dummy_requests"]["value"] == result["attempted"]


def test_metrics_of_one_quantity_share_a_reader(tmp_path):
    """A metric whose name has no file of its own is read by the file of
    its name up to the first dot: a new cell's share of the roofline needs
    an entry and no reader."""
    root = tiny.copy(tmp_path)
    shared = harness.plugin(root, "metrics", "kernels_roofline.query")
    assert shared.__file__.endswith("kernels_roofline.py")
    assert harness.plugin(root, "metrics", "kernels_roofline.another_cell").read is not None
    (root / "portbench/metrics/kernels_roofline.own.py").write_text("def read(run):\n    return 1\n")
    assert harness.plugin(root, "metrics", "kernels_roofline.own").__file__.endswith("own.py")
