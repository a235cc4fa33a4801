"""memo_tpu_torch.parallel across processes, on the CPU: gloo worlds of 2 and
4 ranks (``init_method=file://``, no TCP port) run every (dp, sp) layout of
their size with ShardedQuery (position, interval) and ResidentShardedQuery
(record=, records=), conservation and membership, at k = 1, 3, 31, on
tests/dist_common.py's fixture store. Every rank's outputs must equal the
numpy oracle and memo_tpu.parallel on the same (dp, sp) virtual CPU mesh,
exactly. Also: each resident rank holds only its own slab's rows, the
dry run passes at world 4, and ``query --mesh 2,2`` under a 4-rank torchrun
writes the bytes ``python -m memo_tpu query --mesh 2,2`` writes.

The workers are this file run as a script: they import torch and the port
only (JAX is blocked in them), and every rank loads the same host stores
from .npz files written here.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
KS = (1, 3, 31)
K_MAX = 32
LAYOUTS = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2), (4, 1)]}
CASES = [(world, layout) for world, layouts in LAYOUTS.items() for layout in layouts]
STRATEGIES = ("position", "interval", "resident_record", "resident_records")
MODES = ("conservation", "membership")
EXTRA_WINDOWS = [("chr1", 3, 517), ("chr1", 1023, 1024), ("chr1", 700, 701)]
MULTI_LENS = {"rA": 300, "rB": 173, "rC": 256}  # 3 records: dp=2 and dp=4 leave a slot empty
WORKER_TIMEOUT_S = 180


def _record_windows(length):
    return [(0, length), (5, length - 3), (length - 1, length)]


# ----------------------------------------------------------------- the worker
def _placed_rows(rq) -> int:
    """The rows a resident rank's engines placed, by their layouts' record
    offsets (counted on the device from the placed rows' records)."""
    return sum(int(c._layout.rec_offsets[-1]) for c in rq._placed())


def _worker(rank: int, world: int, data: pathlib.Path) -> None:
    """One rank: every layout of its world, every strategy, mode and k; saves
    its outputs and resident row counts under ``data``."""
    sys.modules["jax"] = None  # any import of JAX now fails
    from memo_tpu_torch.index.store import IntervalStore
    from memo_tpu_torch.parallel import (ResidentShardedQuery, ShardedQuery, initialize,
                                         make_mesh)
    from memo_tpu_torch.parallel.distributed import shutdown
    from memo_tpu_torch.parallel.dryrun import dryrun_multichip

    initialize(f"file://{data}/init_{world}", world, rank, device="cpu")
    import torch.distributed as dist

    checks = {"again": initialize(f"file://{data}/unused", world, rank, device="cpu"),
              "backend": dist.get_backend()}
    try:
        make_mesh(device_type="cuda")
    except ValueError as err:
        checks["cuda_on_gloo"] = str(err)
    store = IntervalStore.load(data / "store.npz")
    multi = IntervalStore.load(data / "multi.npz")
    windows = [tuple(w) for w in json.loads((data / "windows.json").read_text())]
    outs, rows = {}, {"checks": checks}
    for dp, sp in LAYOUTS[world]:
        mesh = make_mesh(dp, sp, device_type="cpu")
        lay = f"{dp}x{sp}"
        for strategy in ("position", "interval"):
            sq = ShardedQuery(store, mesh, strategy=strategy)
            for mode in MODES:
                for k in KS:
                    for i, out in enumerate(getattr(sq, mode)(windows, k)):
                        outs[f"{lay}/{strategy}/{mode}/{k}/{i}"] = out
        rq = ResidentShardedQuery(store, mesh, record="chr1", k_max=K_MAX)
        rq2 = ResidentShardedQuery(multi, mesh, records=list(MULTI_LENS), k_max=K_MAX)
        for mode in MODES:
            for k in KS:
                wins = [(qs, qe) for _, qs, qe in windows]
                for i, out in enumerate(getattr(rq, f"{mode}_windows")(wins, k)):
                    outs[f"{lay}/resident_record/{mode}/{k}/{i}"] = out
                for name, length in MULTI_LENS.items():
                    for i, out in enumerate(getattr(rq2, f"{mode}_windows")(
                            _record_windows(length), k, record=name)):
                        outs[f"{lay}/resident_records/{mode}/{k}/{name}/{i}"] = out
        rows[lay] = {"record": [rq.local_rows, _placed_rows(rq), rq.rows_per_shard],
                     "records": [rq2.local_rows, _placed_rows(rq2), rq2.rows_per_shard],
                     "dispatches": [rq.dispatch_count, rq2.dispatch_count]}
    if world == 4:
        rows["dryrun"] = dryrun_multichip(make_mesh(2, 2, device_type="cpu"))
    np.savez(data / f"out_{world}_{rank}.npz", **outs)
    (data / f"rows_{world}_{rank}.json").write_text(json.dumps(rows))
    shutdown()


# --------------------------------------------------------------- the fixtures
@pytest.fixture(scope="module")
def stores():
    from memo_tpu.index.builder import store_from_ms
    from tests.dist_common import build_fixture_store

    store, windows, _ = build_fixture_store()
    rng = np.random.default_rng(99)
    ms = [rng.integers(0, 25, size=(n, 4)).astype(np.int32) for n in MULTI_LENS.values()]
    multi = store_from_ms(ms, list(MULTI_LENS), list(MULTI_LENS.values()), 5, "conservation")
    return store, multi, windows + EXTRA_WINDOWS


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _wait(procs, what: str) -> list[str]:
    """Every process's output; kills them all if one outlives the timeout."""
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{what} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def worlds(stores, tmp_path_factory):
    """{world: [rank 0's (outputs, rows), ...]} from gloo worlds of 2 and 4
    ranks, run side by side."""
    store, multi, windows = stores
    data = tmp_path_factory.mktemp("dist")
    store.save(data / "store.npz")
    multi.save(data / "multi.npz")
    (data / "windows.json").write_text(json.dumps(windows))
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(world), str(data)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for world in LAYOUTS for rank in range(world)]
    _wait(procs, "gloo worker")
    result = {}
    for world in LAYOUTS:
        result[world] = []
        for rank in range(world):
            with np.load(data / f"out_{world}_{rank}.npz") as z:
                outs = {key: z[key] for key in z.files}
            rows = json.loads((data / f"rows_{world}_{rank}.json").read_text())
            result[world].append((outs, rows))
    return result


def _oracles(stores):
    from memo_tpu.query.engine import QueryEngine

    store, multi, _ = stores
    return QueryEngine(store, backend="numpy"), QueryEngine(multi, backend="numpy")


def _expected(stores, strategy, mode, k, jax_mesh=None):
    """{key suffix: output} from memo_tpu: the numpy oracle, or with
    ``jax_mesh`` memo_tpu.parallel on that virtual mesh."""
    from memo_tpu.parallel import ResidentShardedQuery, ShardedQuery

    store, multi, windows = stores
    want = {}
    if strategy in ("position", "interval"):
        if jax_mesh is None:
            oracle = _oracles(stores)[0]
            outs = [getattr(oracle, mode)(*w, k) for w in windows]
        else:
            outs = getattr(ShardedQuery(store, jax_mesh, strategy=strategy), mode)(windows, k)
        return {f"{i}": np.asarray(o) for i, o in enumerate(outs)}
    if strategy == "resident_record":
        if jax_mesh is None:
            outs = [getattr(_oracles(stores)[0], mode)(*w, k) for w in windows]
        else:
            rq = ResidentShardedQuery(store, jax_mesh, record="chr1", k_max=K_MAX)
            outs = getattr(rq, f"{mode}_windows")([(qs, qe) for _, qs, qe in windows], k)
        return {f"{i}": np.asarray(o) for i, o in enumerate(outs)}
    if jax_mesh is None:
        oracle = _oracles(stores)[1]
    else:
        rq = ResidentShardedQuery(multi, jax_mesh, records=list(MULTI_LENS), k_max=K_MAX)
    for name, length in MULTI_LENS.items():
        for i, (qs, qe) in enumerate(_record_windows(length)):
            if jax_mesh is None:
                want[f"{name}/{i}"] = getattr(oracle, mode)(name, qs, qe, k)
            else:
                want[f"{name}/{i}"] = np.asarray(
                    getattr(rq, mode)(qs, qe, k, record=name))
    return want


# ------------------------------------------------------------------ the tests
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("world,layout", CASES, ids=[f"w{w}-{d}x{s}" for w, (d, s) in CASES])
def test_every_rank_matches_numpy_and_memo_tpu_mesh(worlds, stores, world, layout, strategy,
                                                    mode):
    """Exact on every rank at every k against the numpy oracle, and at one k
    (rotating over the layouts) against memo_tpu.parallel on the same
    (dp, sp) virtual mesh: one JAX program per (layout, strategy, mode)."""
    import jax
    from memo_tpu.parallel import make_mesh

    dp, sp = layout
    lay = f"{dp}x{sp}"
    k_jax = KS[CASES.index((world, layout)) % len(KS)]
    jax_mesh = make_mesh(dp=dp, sp=sp, devices=jax.devices()[: dp * sp])
    for k in KS:
        want = _expected(stores, strategy, mode, k)
        jax_want = _expected(stores, strategy, mode, k, jax_mesh) if k == k_jax else None
        for rank, (outs, _) in enumerate(worlds[world]):
            for suffix, w in want.items():
                got = outs[f"{lay}/{strategy}/{mode}/{k}/{suffix}"]
                where = f"rank {rank} {lay} {strategy} {mode} k={k} {suffix}"
                assert got.dtype == (np.int8 if mode == "membership" else np.int32), where
                np.testing.assert_array_equal(got, w, err_msg=where)
                if jax_want is not None:
                    np.testing.assert_array_equal(got, jax_want[suffix], err_msg=where + " (jax)")


@pytest.mark.parametrize("world,layout", CASES, ids=[f"w{w}-{d}x{s}" for w, (d, s) in CASES])
def test_each_resident_rank_holds_only_its_slab(worlds, stores, world, layout):
    """Rank (d, s) places slab s of the records in dp slot d (less the rows
    too long to mark): its live row count is that, its engine holds exactly
    those rows, not the whole placement's, M is memo_tpu's padded width
    (the widest slab of any record, rounded up to 8), and one dispatch
    served each (k, mode)."""
    store, multi, _ = stores
    dp, sp = layout
    names = list(MULTI_LENS)
    n_batch = -(-len(names) // dp)

    def slab_rows(st, name, s, B):
        r = st.record_index(name)
        lo, hi = st.window_bounds(name, s * B, min((s + 1) * B, int(st.record_lens[r])), K_MAX)
        hi = min(hi, int(st.rec_offsets[r + 1]))
        return int(((st.end[lo:hi] - st.start[lo:hi]) < K_MAX - 1).sum())

    B1 = -(-int(store.record_lens[0]) // sp)
    Bm = -(-max(MULTI_LENS.values()) // sp)
    M1 = -(-max(slab_rows(store, "chr1", s, B1) for s in range(sp)) // 8) * 8
    Mm = -(-max(slab_rows(multi, name, s, Bm) for name in names for s in range(sp)) // 8) * 8
    for rank, (_, rows) in enumerate(worlds[world]):
        d, s = divmod(rank, sp)
        local, placed, M = rows[f"{dp}x{sp}"]["record"]
        assert local == slab_rows(store, "chr1", s, B1) and placed == local and M == M1
        local, placed, M = rows[f"{dp}x{sp}"]["records"]
        mine = [names[i] for i in range(d, n_batch * dp, dp) if i < len(names)]
        assert local == sum(slab_rows(multi, name, s, Bm) for name in mine)
        assert placed == local and M == Mm
        assert rows[f"{dp}x{sp}"]["dispatches"] == [len(MODES) * len(KS)] * 2


def test_group_is_gloo_for_cpu_and_serves_no_cuda_mesh(worlds):
    """initialize is idempotent, a CPU group is gloo, and a CUDA mesh on it
    raises instead of running on the CPU."""
    for world in LAYOUTS:
        for _, rows in worlds[world]:
            checks = rows["checks"]
            assert checks["again"] is False and checks["backend"] == "gloo"
            assert "backend 'gloo' does not serve device 'cuda'" in checks["cuda_on_gloo"]


def test_dryrun_at_world_four(worlds):
    for _, rows in worlds[4]:
        assert rows["dryrun"].startswith("dryrun_multichip OK: mesh={'dp': 2, 'sp': 2} device=cpu")


def test_cli_mesh_2x2_under_torchrun_matches_memo_tpu(stores, tmp_path):
    """``query --regions-file --mesh 2,2 --strategy interval`` under a 4-rank
    gloo torchrun writes the bytes memo_tpu writes on a 2x2 virtual mesh;
    only rank 0 writes."""
    store, _, _ = stores
    npz, regions = tmp_path / "store.npz", tmp_path / "regions.txt"
    store.save(npz)
    names = ["chr1:0-256", "chr1:3-517", "chr1:1023-1024", "chr1:700-701"]
    regions.write_text("\n".join(names) + "\n")
    args = ["query", "-b", str(npz), "-k", "3", "--regions-file", str(regions), "--mesh", "2,2",
            "--strategy", "interval"]
    port = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "memo_tpu_torch", *args, "-o", str(tmp_path / "got"), "--device", "cpu"],
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = subprocess.Popen(
        [sys.executable, "-m", "memo_tpu", *args, "-o", str(tmp_path / "want")],
        env=dict(_env(), JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _wait([port, ref], "query --mesh 2,2")
    for name in names:
        suffix = name.replace(":", "_").replace("-", "_") + ".txt"
        want = (tmp_path / f"want.{suffix}").read_bytes()
        assert want and (tmp_path / f"got.{suffix}").read_bytes() == want, name
    assert len(list(tmp_path.glob("got.*"))) == len(names)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
