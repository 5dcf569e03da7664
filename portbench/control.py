"""Readings that set a cell's limits: for each seed, the numbers that
decide ``correct`` for the program (``sound``), for the control (the
plain reference computed in TF32 in the program's place) and, for a
training cell, for the fault of a step that leaves half of its batch out
(on the first ``--control-seeds`` seeds), the step after a window of
``--seconds`` (the benchmark's ``run_seconds`` unless given) included. All
seeds run in one process, at the cell's own size, on the card.

    python3 portbench/control.py --workload seesaw.train --seeds 11 12 13 --out readings.json
"""

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control and the faults on the first N seeds only")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import run
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _, cfg, mix, _ = run.cell_files(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    gen = importlib.import_module(f"harness.{mix['generator']}")
    out = []
    seconds = bench["run_seconds"] if args.seconds is None else args.seconds
    n_ctl = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        r = dict(seed=seed, **gen.readings(cfg, mix, seed, torch.device("cuda", 0),
                                           control=i < n_ctl, seconds=seconds))
        print(json.dumps(r), flush=True)
        out.append(r)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
