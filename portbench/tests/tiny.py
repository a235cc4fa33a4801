"""A tiny copy of the benchmark for CPU rehearsals: ``BENCHMARK.json`` and
``portbench/`` copied under a temporary root, with every configuration cut
to a small record of few genomes at the dense recipe's divergence (so that
a few windows hold marks) and every traffic mix to short windows and small
samples, so a run takes a second or two on the CPU."""

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
RECORD_LEN = 200_000
N_DOCS = 10


def copy(root: pathlib.Path) -> pathlib.Path:
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(record_len=RECORD_LEN, n_docs=N_DOCS, gap=min(cfg["gap"], 25))
        path.write_text(json.dumps(cfg))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        if "windows" in traffic:
            traffic.update(windows=40, sample=3, length_median=2_000, length_mean=4_000)
        else:
            traffic.update(length_min=min(traffic["length_min"], 2_000),
                           length_max=min(traffic["length_max"], 60_000))
        path.write_text(json.dumps(traffic))
    return root


def cells() -> list[str]:
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def drivers() -> dict[str, str]:
    """Each cell's traffic driver."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return {w["name"]: json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json")
                                  .read_text())["driver"] for w in bench["workloads"]}
