"""memo_tpu_torch owns its host side: no module of the port and nothing in
chip_smoke.py imports memo_tpu, bench or JAX; the port's CLI runs every
subcommand in a fresh interpreter without loading any of them; and the
port's copies (index builder and store, compat I/O, output, plot, region
parsing, prefix counts, the smoke's store builders) give what memo_tpu and
bench.py give on the same inputs: equal index arrays, each package loading
the other's .npz, byte-identical query text and extract BED, the same view
PNG."""

import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import bench
import chip_smoke
from memo_tpu import cli as ref_cli
from memo_tpu.index.builder import store_from_ms as ref_store_from_ms
from memo_tpu.index.store import IntervalStore as RefStore
from memo_tpu.query.engine import parse_region as ref_parse_region
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.query.engine import parse_region

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "tests" / "data" / "example"
FORBIDDEN = ("memo_tpu", "bench", "jax", "jaxlib")
REGIONS = ["piv_1:0-40", "piv_1:10-70", "piv_1:69-70"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_sources() -> list[pathlib.Path]:
    return sorted((REPO / "memo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_nothing_of_memo_tpu_bench_or_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
    assert not [m for m in imported if _forbidden(m)], imported


# A fresh interpreter in which importing memo_tpu, bench or JAX raises runs
# every CLI subcommand of the port on the example data.
CHILD = textwrap.dedent(
    """
    import importlib.abc, json, sys

    FORBIDDEN = {forbidden!r}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
                raise ImportError(f"the port imported {{name}}")

    sys.meta_path.insert(0, Refuse())
    import memo_tpu_torch.cli as cli

    example, out = {example!r}, {out!r}
    steps = [
        ["index", "-g", f"{{example}}/genome_list.txt", "-o", out, "-p", "cons",
         "--ms-backend", "native", "--no-cache"],
        ["index", "-g", f"{{example}}/genome_list.txt", "-o", out, "-p", "memb", "-m",
         "--ms-backend", "native", "--no-cache"],
        ["query", "-b", f"{{out}}/cons.npz", "-k", "3", "-r", "piv_1:0-70", "-o",
         f"{{out}}/cons.txt", "--device", "cpu"],
        ["query", "-b", f"{{out}}/memb.npz", "-k", "3", "-r", "piv_1:0-40", "-m", "-o",
         f"{{out}}/memb.txt", "--device", "cpu"],
        ["query", "-b", f"{{out}}/cons.npz", "-k", "3", "--regions-file",
         f"{{out}}/regions.txt", "-o", f"{{out}}/batch", "--device", "cpu"],
        ["view", "-i", f"{{out}}/cons.txt", "-o", f"{{out}}/plot.png", "-n", "5", "-b", "10",
         "-d", "72"],
        ["extract", "-b", f"{{out}}/cons.npz", "-r", "piv_1:5-40", "-o", f"{{out}}/extract"],
    ]
    for argv in steps:
        assert cli.main(argv) == 0, argv
    import memo_tpu_torch.parallel.dryrun as dryrun
    assert dryrun.main(["--device", "cpu"]) == 0
    import memo_tpu_torch.entry as entry
    assert entry.main(["--device", "cpu"]) == 0
    loaded = sorted(m for m in sys.modules if any(m == f or m.startswith(f + ".") for f in FORBIDDEN))
    print("LOADED=" + json.dumps(loaded))
    """
)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's CLI run in a fresh interpreter; returns its output directory."""
    out = tmp_path_factory.mktemp("port")
    (out / "regions.txt").write_text("\n".join(REGIONS) + "\n")
    code = CHILD.format(forbidden=FORBIDDEN, example=str(EXAMPLE), out=str(out))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=out, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = json.loads(proc.stdout.split("LOADED=")[-1])
    return out, loaded


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """memo_tpu's CLI on the same inputs, in this process."""
    out = tmp_path_factory.mktemp("ref")
    regions = out / "regions.txt"
    regions.write_text("\n".join(REGIONS) + "\n")
    for prefix, extra in (("cons", []), ("memb", ["-m"])):
        assert ref_cli.main(["index", "-g", str(EXAMPLE / "genome_list.txt"), "-o", str(out),
                             "-p", prefix, "--ms-backend", "native", "--no-cache", *extra]) == 0
    assert ref_cli.main(["query", "-b", str(out / "cons.npz"), "-k", "3", "-r", "piv_1:0-70",
                         "-o", str(out / "cons.txt"), "--backend", "numpy"]) == 0
    assert ref_cli.main(["query", "-b", str(out / "memb.npz"), "-k", "3", "-r", "piv_1:0-40",
                         "-m", "-o", str(out / "memb.txt"), "--backend", "numpy"]) == 0
    assert ref_cli.main(["query", "-b", str(out / "cons.npz"), "-k", "3", "--regions-file",
                         str(regions), "-o", str(out / "batch"), "--backend", "numpy"]) == 0
    assert ref_cli.main(["view", "-i", str(out / "cons.txt"), "-o", str(out / "plot.png"), "-n",
                         "5", "-b", "10", "-d", "72"]) == 0
    assert ref_cli.main(["extract", "-b", str(out / "cons.npz"), "-r", "piv_1:5-40", "-o",
                         str(out / "extract")]) == 0
    return out


def test_port_cli_loads_nothing_of_memo_tpu_or_jax(port_run):
    out, loaded = port_run
    assert loaded == []
    assert list((REPO / "memo_tpu_torch" / "build" / "native").glob("libms-*.so"))


@pytest.mark.parametrize("name", ["cons.npz", "memb.npz"])
def test_index_arrays_equal_and_files_interchangeable(port_run, ref_run, name):
    port_npz, ref_npz = port_run[0] / name, ref_run / name
    with np.load(port_npz) as a, np.load(ref_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for path in (port_npz, ref_npz):
        mine, theirs = IntervalStore.load(path), RefStore.load(path)
        assert (mine.record_names, mine.n_docs, mine.kind) == (theirs.record_names, theirs.n_docs,
                                                               theirs.kind)
        for key in ("start", "end", "order", "rec_id", "rec_offsets", "max_interval_len"):
            np.testing.assert_array_equal(getattr(mine, key), getattr(theirs, key))


@pytest.mark.parametrize("name", ["cons.txt", "memb.txt", "extract/omem_olaps_piv_1_5_40.bed"]
                         + [f"batch.{r.replace(':', '_').replace('-', '_')}.txt" for r in REGIONS])
def test_outputs_byte_identical(port_run, ref_run, name):
    got = (port_run[0] / name).read_bytes()
    assert got == (ref_run / name).read_bytes() and got


def test_view_png_equal(port_run, ref_run):
    got = (port_run[0] / "plot.png").read_bytes()
    assert got == (ref_run / "plot.png").read_bytes() and len(got) > 1000


@pytest.mark.parametrize("region", ["chr1:0-10", "a:b:5-9", "piv_1:69-70", "x:3-"])
def test_parse_region_agrees(region):
    try:
        want = ref_parse_region(region)
    except ValueError:
        with pytest.raises(ValueError):
            parse_region(region)
        return
    assert parse_region(region) == want


def test_parse_region_rejects_what_memo_tpu_rejects():
    for bad in ("chr1", "", "12-40"):
        with pytest.raises(ValueError):
            ref_parse_region(bad)
        with pytest.raises(ValueError):
            parse_region(bad)


def _ms_store(cls_builder, rng):
    ms = rng.integers(0, 40, size=(900, 7)).astype(np.int32)
    idx = np.arange(900, dtype=np.int64)[:, None]
    ms = (np.minimum.accumulate((ms + idx)[::-1])[::-1] - idx).astype(np.int32)
    return cls_builder([ms, ms[:500]], ["chr0", "chr1"], [900, 500], 8, "conservation")


@pytest.mark.parametrize("path", ["monotone", "scan"])
def test_prefix_counts_agree(path):
    """QueryLayout.prefix_counts of the port and of memo_tpu on one store,
    down the monotone path (a true-MS store) and the scan fallback (the same
    store with orders out of range)."""
    from memo_tpu.index.builder import store_from_ms as ref_store_from_ms

    mine = _ms_store(store_from_ms, np.random.default_rng(5))
    theirs = _ms_store(ref_store_from_ms, np.random.default_rng(5))
    if path == "scan":
        for st in (mine, theirs):
            st.order[::17] = -1
            st.order[5::23] = st.n_docs + 2
    lay_m, lay_t = mine.query_layout(), theirs.query_layout()
    assert lay_m.monotone == lay_t.monotone == (path == "monotone")
    for r, qs, k in ((0, 0, 31), (0, 123, 3), (0, 850, 101), (1, 77, 1), (1, 499, 7)):
        got = lay_m.prefix_counts(mine, r, qs, k)
        np.testing.assert_array_equal(got, lay_t.prefix_counts(theirs, r, qs, k))
    np.testing.assert_array_equal(lay_m.end_sorted, lay_t.end_sorted)


SMALL = {"PIVOT_LEN": 1 << 13, "LARGE_PIVOT_LEN": 1 << 12, "LARGE_N_DOCS": 12}


def test_smoke_builders_match_bench(monkeypatch):
    """chip_smoke.py's copies of bench.py's store builders give the same
    stores for one seed (at a cut pivot length; the widths are bench's)."""
    for name, value in SMALL.items():
        monkeypatch.setattr(bench, name, value)
        monkeypatch.setattr(chip_smoke, name, value)
    for build in ("build_store", "build_large_store"):
        mine = getattr(chip_smoke, build)(np.random.default_rng(7))
        theirs = getattr(bench, build)(np.random.default_rng(7))
        assert isinstance(mine, IntervalStore) and mine.num_intervals > 0
        for key in ("start", "end", "order", "rec_id"):
            np.testing.assert_array_equal(getattr(mine, key), getattr(theirs, key), err_msg=build)
    for args in ((1 << 12, 9, 31, 25), (1 << 11, 20, 31, 30)):
        np.testing.assert_array_equal(chip_smoke.synth_ms(np.random.default_rng(3), *args),
                                      bench.synth_ms(np.random.default_rng(3), *args))


@pytest.mark.parametrize("length,n_docs,gap,chunk", [
    (300_000, 90, 1100, 1 << 16),  # the chromosome's width and gap, 5 chunks
    (40_000, 16, 25, 4096),  # dense anchors
    (100_001, 5, 300, 30_000),  # a ragged last chunk
])
def test_chromosome_builder_streams_synth_ms(length, n_docs, gap, chunk):
    """chip_smoke.build_chromosome_store, which never holds the MS matrix,
    gives memo_tpu's store_from_ms of synth_ms's matrix for one seed."""
    mine = chip_smoke.build_chromosome_store(np.random.default_rng(5), length=length,
                                             n_docs=n_docs, gap=gap, device="cpu", chunk=chunk)
    ms = chip_smoke.synth_ms(np.random.default_rng(5), length, n_docs - 1, 31, gap=gap)
    want = ref_store_from_ms([ms], ["chr1"], [length], n_docs, "conservation")
    assert isinstance(mine, IntervalStore) and mine.num_intervals > 0
    for key in ("start", "end", "order", "rec_id", "rec_offsets", "max_interval_len"):
        got, exp = getattr(mine, key), getattr(want, key)
        assert got.dtype == exp.dtype, key
        np.testing.assert_array_equal(got, exp, err_msg=key)


def test_chromosome_gap_gives_scale_r05_density():
    """At 1 Mbp the store's intervals a position, scaled to 128 Mbp, land
    within 10% of SCALE_r05.json's 432,249,312."""
    length = 1_000_000
    store = chip_smoke.build_chromosome_store(np.random.default_rng(chip_smoke.SEED),
                                              length=length, device="cpu")
    scaled = store.num_intervals * chip_smoke.CHROM_LEN / length
    assert abs(scaled - chip_smoke.CHROM_INTERVALS) <= chip_smoke.CHROM_INTERVALS / 10
    wins = chip_smoke.chromosome_windows()
    assert len(wins) == 8 and wins[0] == (0, 1 << 21) and wins[-1][1] == chip_smoke.CHROM_LEN


def test_smoke_reference_loops_match_bench():
    rng = np.random.default_rng(11)
    ms = rng.integers(0, 40, size=(3000, 15)).astype(np.int32)
    idx = np.arange(3000, dtype=np.int64)[:, None]
    ms = (np.minimum.accumulate((ms + idx)[::-1])[::-1] - idx).astype(np.int32)
    for kind in ("conservation", "membership"):
        st = store_from_ms([ms], ["chr1"], [3000], 16, kind)
        for qs, qe, k in ((0, 3000, 31), (123, 456, 7)):
            if kind == "conservation":
                np.testing.assert_array_equal(chip_smoke.reference_query_np(st, qs, qe, k),
                                              bench.reference_query_np(st, qs, qe, k))
            else:
                np.testing.assert_array_equal(chip_smoke.reference_membership_np(st, qs, qe, k),
                                              bench.reference_membership_np(st, qs, qe, k))
