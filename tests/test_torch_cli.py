"""python -m memo_tpu_torch: queries on the CPU write the same bytes as
memo_tpu's numpy backend, index/view/extract are memo_tpu's own commands,
and the port never imports JAX."""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from memo_tpu import cli as ref_cli
from memo_tpu_torch import cli

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "tests" / "data" / "example"


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    out = tmp_path_factory.mktemp("idx")
    for prefix, extra in (("cons", []), ("memb", ["-m"])):
        rc = ref_cli.main(
            ["index", "-g", str(EXAMPLE / "genome_list.txt"), "-o", str(out), "-p", prefix,
             "--ms-backend", "python", "--no-cache", *extra]
        )
        assert rc == 0
    return out


@pytest.mark.parametrize("backend", ["auto", "fused", "torch", "numpy"])
@pytest.mark.parametrize(
    "index,flags", [("cons", ["-k", "3", "-r", "piv_1:0-70"]),
                    ("cons", ["-k", "31", "-r", "piv_1:5-60"]),
                    ("memb", ["-k", "3", "-r", "piv_1:0-40", "-m"])]
)
def test_query_bytes_match_memo_tpu(indexes, tmp_path, backend, index, flags):
    npz = str(indexes / f"{index}.npz")
    want, got = tmp_path / "want.txt", tmp_path / "got.txt"
    assert ref_cli.main(["query", "-b", npz, "-o", str(want), "--backend", "numpy", *flags]) == 0
    rc = cli.main(["query", "-b", npz, "-o", str(got), "--backend", backend, "--device", "cpu",
                   "--stats", *flags])
    assert rc == 0
    assert got.read_bytes() == want.read_bytes() and want.stat().st_size > 0


def test_query_kind_mismatch_refused(indexes, tmp_path):
    args = ["query", "-b", str(indexes / "cons.npz"), "-k", "3", "-r", "piv_1:0-40",
            "-o", str(tmp_path / "m.txt"), "-m", "--device", "cpu"]
    with pytest.raises(SystemExit, match="mismatch"):
        cli.main(args)


REGIONS = ["piv_1:0-40", "piv_1:10-70", "piv_1:69-70", "piv_1:33-34"]


def _regions_bytes(prefix, regions):
    return [pathlib.Path(f"{prefix}.{r.replace(':', '_').replace('-', '_')}.txt").read_bytes()
            for r in regions]


@pytest.mark.parametrize("strategy", ["auto", "position", "interval", "resident", "batched"])
@pytest.mark.parametrize("index,flags", [("cons", ["-k", "3"]), ("cons", ["-k", "31"]),
                                         ("memb", ["-k", "3", "-m"])])
def test_regions_file_bytes_match_memo_tpu(indexes, tmp_path, strategy, index, flags):
    regions = tmp_path / "regions.txt"
    regions.write_text("\n".join(REGIONS) + "\n")
    npz = str(indexes / f"{index}.npz")
    want, got = tmp_path / "want", tmp_path / "got"
    assert ref_cli.main(["query", "-b", npz, "--regions-file", str(regions), "-o", str(want),
                         "--strategy", strategy, *flags]) == 0
    assert cli.main(["query", "-b", npz, "--regions-file", str(regions), "-o", str(got),
                     "--strategy", strategy, "--device", "cpu", *flags]) == 0
    assert _regions_bytes(got, REGIONS) == _regions_bytes(want, REGIONS)


def test_regions_file_batched_v2_and_mesh_one_by_one(indexes, tmp_path, monkeypatch):
    regions = tmp_path / "regions.txt"
    regions.write_text("\n".join(REGIONS) + "\n")
    npz = str(indexes / "cons.npz")
    want, got = tmp_path / "want", tmp_path / "got"
    assert ref_cli.main(["query", "-b", npz, "--regions-file", str(regions), "-o", str(want),
                         "--backend", "numpy", "--strategy", "batched"]) == 0
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", "v2")
    assert cli.main(["query", "-b", npz, "--regions-file", str(regions), "-o", str(got),
                     "--strategy", "batched", "--mesh", "1,1", "--device", "cpu"]) == 0
    assert _regions_bytes(got, REGIONS) == _regions_bytes(want, REGIONS)


def test_regions_file_not_yet_ported(indexes, tmp_path):
    """Without a process group --regions-file runs on one device; other
    --mesh layouts exit and say to launch one process per device."""
    regions = tmp_path / "regions.txt"
    regions.write_text("piv_1:0-40\n")
    for mesh in ("2,1", "1,2"):
        with pytest.raises(SystemExit, match="--mesh .*no process group exists.*torchrun"):
            cli.main(["query", "-b", str(indexes / "cons.npz"), "--regions-file", str(regions),
                      "-o", str(tmp_path / "b"), "--device", "cpu", "--mesh", mesh])


def test_pick_batch_strategy_matches_memo_tpu(indexes):
    """The JAX rules on the same inputs; its "single TPU" rule reads "the
    query device is CUDA" (the JAX side runs on 8 CPU devices here)."""
    from memo_tpu.index.store import IntervalStore
    from memo_tpu.query.engine import parse_region

    store = IntervalStore.load(indexes / "cons.npz")
    for regions in (["piv_1:0-70"], ["piv_1:0-2"], ["piv_1:0-2", "piv_1:9-11"],
                    [f"piv_1:{i}-{i + 1}" for i in range(8)]):
        parsed = [parse_region(r) for r in regions]
        want = ref_cli.pick_batch_strategy(store, parsed)
        assert cli.pick_batch_strategy(store, parsed, "cpu") == want
        assert cli.pick_batch_strategy(store, parsed, "cuda") == (
            "batched" if want == "position" else want
        )


def test_pick_batch_strategy_multi_rank_keeps_position(indexes):
    """batched is a one-device strategy: a layout of several ranks keeps
    position for scattered windows, as memo_tpu's multi-device meshes do."""
    from memo_tpu.index.store import IntervalStore
    from memo_tpu.query.engine import parse_region

    store = IntervalStore.load(indexes / "cons.npz")
    parsed = [parse_region(r) for r in ("piv_1:0-2", "piv_1:9-11")]
    assert cli.pick_batch_strategy(store, parsed, "cuda", n_ranks=1) == "batched"
    for n_ranks in (2, 4):
        assert cli.pick_batch_strategy(store, parsed, "cuda", n_ranks=n_ranks) == "position"


def test_regions_file_auto_logs_its_choice(indexes, tmp_path, caplog):
    import logging

    regions = tmp_path / "regions.txt"
    regions.write_text("piv_1:0-40\n")
    logger = logging.getLogger(cli.log.name)
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=cli.log.name):
            assert cli.main(["query", "-b", str(indexes / "cons.npz"), "--regions-file",
                             str(regions), "-o", str(tmp_path / "a"), "--device", "cpu"]) == 0
    finally:
        logger.removeHandler(caplog.handler)
    assert "--strategy auto resolved to 'resident'" in caplog.text


def test_query_device_cuda_without_gpu_raises(indexes, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["query", "-b", str(indexes / "cons.npz"), "-r", "piv_1:0-40",
                  "-o", str(tmp_path / "c.txt")])


def test_query_profile_writes_torch_trace(indexes, tmp_path):
    trace = tmp_path / "trace"
    rc = cli.main(["query", "-b", str(indexes / "cons.npz"), "-k", "3", "-r", "piv_1:0-40",
                   "-o", str(tmp_path / "c.txt"), "--device", "cpu", "--profile", str(trace)])
    assert rc == 0
    assert (trace / "trace.json").stat().st_size > 0


def test_view_and_extract_are_memo_tpu_commands(indexes, tmp_path):
    cons = tmp_path / "cons.txt"
    assert cli.main(["query", "-b", str(indexes / "cons.npz"), "-k", "3", "-r", "piv_1:0-70",
                     "-o", str(cons), "--device", "cpu"]) == 0
    png = tmp_path / "out.png"
    assert cli.main(["view", "-i", str(cons), "-o", str(png), "-n", "5", "-b", "4", "-d", "72"]) == 0
    assert png.stat().st_size > 1000
    for main, sub in ((cli.main, "port"), (ref_cli.main, "ref")):
        assert main(["extract", "-b", str(indexes / "cons.npz"), "-r", "piv_1:5-40",
                     "-o", str(tmp_path / sub)]) == 0
    name = "omem_olaps_piv_1_5_40.bed"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_index_through_port_cli_matches(indexes, tmp_path):
    rc = cli.main(["index", "-g", str(EXAMPLE / "genome_list.txt"), "-o", str(tmp_path),
                   "-p", "p", "--ms-backend", "python", "--no-cache"])
    assert rc == 0
    from memo_tpu.index.store import IntervalStore

    a, b = IntervalStore.load(tmp_path / "p.npz"), IntervalStore.load(indexes / "cons.npz")
    assert (a.start == b.start).all() and (a.end == b.end).all() and (a.order == b.order).all()


def test_port_never_imports_jax(indexes, tmp_path):
    """In a fresh interpreter where importing JAX fails, the port imports and
    runs a query end to end, and JAX stays out of sys.modules."""
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None  # any "import jax" now raises ImportError
        import memo_tpu_torch, memo_tpu_torch.cli, memo_tpu_torch.query.engine
        rc = memo_tpu_torch.cli.main(["query", "-b", {str(indexes / "cons.npz")!r}, "-k", "3",
                                      "-r", "piv_1:0-70", "-o", {str(tmp_path / "c.txt")!r},
                                      "--device", "cpu"])
        assert rc == 0
        assert sys.modules["jax"] is None
        assert not [m for m in sys.modules if m.startswith("jax.") or m.startswith("jaxlib")]
        print("NOJAX-OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX-OK" in proc.stdout
