"""The benchmark on the card, at small sizes (imports no JAX):

    python -m pytest -m cuda portbench/tests/test_portbench_card.py -q

The generator's columns made on the card equal the CPU's from the same
anchors, and a tiny copy of every cell runs there, untraced and traced,
with ``correct`` true and its device numbers read. Skips without a CUDA
device."""

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.gen import synth_ms_overlaps as gen
from portbench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gap", [25, 1100])
def test_card_columns_equal_the_cpus(card, gap):
    cfg = {"record": "chr1", "record_len": 3_000_000, "n_docs": 24, "gap": gap,
           "match_min": 8, "match_max": 120}
    pos, value = gen.anchors(cfg, 2**33 + 1, card)
    got = gen.columns_of_anchors(pos, value, cfg["record_len"], 1 << 20)
    want = gen.columns_of_anchors(pos.cpu(), value.cpu(), cfg["record_len"], 1 << 20)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny.cells())
def test_each_cell_runs_on_the_card(card, tmp_path, cell, trace):
    root = tiny.copy(tmp_path)
    result = harness.run_cell(root, cell, 2**32 + 3, 1.0, trace, "cuda", time.perf_counter())
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, m in result["metrics"].items():
            if "roofline" in name:
                assert 0 < m["value"] <= 100
        assert len(result["metrics"]) == len(harness.load_cell(root, cell).per_layer)
        assert result["breakdown"]["device_ops"]
    assert np.isfinite([m["value"] for m in result["metrics"].values()]).all()
