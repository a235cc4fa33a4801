"""The traffic mixes and the sample of answers: the gene mixes' lengths have
the median and mean their sources give, the locus mix asks for the whole
MHC on the MHC's record, every mix names its sources, and the sample the
harness keeps is uniform over the window's requests whatever their number,
with the plan drawn before the window."""

import json
import math

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny

TRAFFIC = tiny.REPO / "portbench" / "traffic"


def mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def driver(name):
    return harness.plugin(tiny.REPO, "drivers", name)


@pytest.mark.parametrize("name", ["genes_chr12", "genes_mhc"])
def test_gene_lengths_have_the_sources_median_and_mean(name):
    traffic = mix(name)
    batch = next(driver("regions").stream(traffic, 128_000_000, 2**31 + 5))
    lengths = np.array([qe - qs for qs, qe in batch.windows])
    assert len(lengths) == traffic["windows"] and batch.k == 31
    assert abs(np.median(lengths) / traffic["length_median"] - 1) < 0.01
    assert abs(lengths.mean() / traffic["length_mean"] - 1) < 0.02
    assert [qs for qs, _ in batch.windows] == sorted(qs for qs, _ in batch.windows)


def test_the_locus_mix_on_the_mhc_is_the_whole_record():
    cfg = json.loads((tiny.REPO / "portbench/configs/hprc90-mhc.json").read_text())
    stream = driver("locus").stream(mix("locus"), cfg["record_len"], 7)
    for _ in range(5):
        req = next(stream)
        assert req.windows == [(0, cfg["record_len"])] and req.k == 31


def test_every_mix_names_its_sources():
    for path in TRAFFIC.glob("*.json"):
        traffic = json.loads(path.read_text())
        assert traffic["why"] and traffic["sources"], path.name


@pytest.mark.parametrize("size,n", [(1, 7), (4, 4), (4, 50), (8, 3_000)])
def test_the_sample_is_uniform_over_the_requests(size, n):
    """Over many seeds each request is kept about size / n of the time, and
    the plan for a run is small: a look-up a request."""
    runs, kept = 600, np.zeros(n)
    for seed in range(runs):
        sampler = harness.Sampler(size, seed)
        assert len(sampler.plan) < 2 * size * (1 + math.log(harness.Sampler.HORIZON / size)) + 20
        for i in range(n):
            sampler.offer(i, [(0, 1)], 31, [i])
        slots = [item[0] for item in sampler.slots if item is not None]
        assert len(slots) == min(size, n) == len(set(slots))
        kept[slots] += 1
    bins = np.array_split(kept, min(n, 10))  # consecutive requests, so early and late ones alike
    share = np.array([b.sum() / len(b) for b in bins]) / runs
    want = min(size, n) / n
    sigma = max(math.sqrt(want * (1 - want) / (runs * len(b))) for b in bins)
    assert np.abs(share - want).max() < 4 * sigma + 1e-9


def test_the_sample_keeps_the_longest_request():
    sampler = harness.Sampler(2, 11)
    lengths = [5, 9, 3, 9, 12, 1, 7]
    for i, n in enumerate(lengths):
        sampler.offer(i, [(100, 100 + n)], 31, [np.zeros(n)])
    assert max(qe - qs for qs, qe, _, _ in sampler.items()) == 12
