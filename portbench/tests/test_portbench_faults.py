"""A run with the timed path broken underneath comes out not correct: the
look for a chip is skipped (``run_cell`` on "cpu"), and the program's
``QueryEngine`` is wrapped so that its answers are wrong in each way a cell
can be: an answer altered where it is produced, half of a batch left out,
and a step that returns its state unchanged (the previous request's
answer). The exchange between chips has no cell to break: every cell is on
one chip."""

import time

import numpy as np
import pytest

from memo_tpu_torch.query.engine import QueryEngine
from portbench import harness
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("bench"))


def altered(real):
    """Each answer off by one at its middle position."""
    def call(self, *args):
        out = real(self, *args)
        for answer in out if isinstance(out, list) else [out]:
            if answer.size:
                answer[answer.size // 2] += 1
        return out
    return call


def half_left_out(real):
    def call(self, record, windows, k):
        windows = list(windows)
        half = len(windows) // 2
        out = real(self, record, windows[:half], k) if half else []
        return out + [np.full(qe - qs, self.n_docs, np.int32) for qs, qe in windows[half:]]
    return call


def unchanged(real):
    last = {}

    def call(self, *args):
        out = last.get("out")
        last["out"] = real(self, *args)
        return last["out"] if out is None else out
    return call


FAULTS = {
    "altered": {"conservation": altered, "conservation_batch": altered},
    "half_left_out": {"conservation_batch": half_left_out},
    "unchanged": {"conservation": unchanged, "conservation_batch": unchanged},
}


ENTRY = {"locus": "conservation", "regions": "conservation_batch"}  # each driver's call
CASES = [(cell, fault) for cell, driver in tiny.drivers().items() for fault in sorted(FAULTS)
         if ENTRY[driver] in FAULTS[fault]]  # a single window has no half to leave out


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    method = ENTRY[tiny.drivers()[cell]]
    monkeypatch.setattr(QueryEngine, method, FAULTS[fault][method](getattr(QueryEngine, method)))
    result = harness.run_cell(root, cell, 99, 0.5, False, "cpu", time.perf_counter())
    assert result["correct"] is False
    assert result["checks"]["mismatched_positions"]["value"] > 0


def test_the_control_is_not_correct(root):
    """The reference's control, in the program's place on the same sample,
    fails the comparison at the tiny size (on the card: ``readings.py``)."""
    for cell in tiny.cells():
        result = harness.run_cell(root, cell, 5, 0.5, False, "cpu", time.perf_counter(),
                                  control=True)
        assert result["correct"] is True
        assert result["control"]["mismatched_positions"]["value"] > 0, cell
