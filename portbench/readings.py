"""The readings the limits of ``correct`` are set from; not part of a run.

    python3 portbench/readings.py --workload <name> --seeds 11,12,13 --seconds 5

For each seed, in one process: a run of the cell (inputs, engine, warm-up, a
short window at the cell's load, the sample held to the reference), then
the reference's control put in the program's place on the same sample. One
JSON line a seed: the program's numbers and the control's. Needs the
cell's CUDA devices, as a run does.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import forbidden_modules, load_cell, log, run_cell  # noqa: E402


def main(argv: list[str]) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < load_cell(ROOT, args.workload).chips:
        log("needs the cell's CUDA devices")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run_cell(ROOT, args.workload, seed, args.seconds, False, "cuda",
                          time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "program": result["checks"], "control": result["control"],
                          "attempted": result["attempted"]}), flush=True)
    if forbidden_modules():
        log(f"modules no run may load were loaded: {forbidden_modules()}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
