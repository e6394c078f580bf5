#!/usr/bin/env python3
"""The readings that set each check's limits (PERF.md): one process runs a
cell on several seeds, and for each prints the numbers the check compares
for the program (the lower readings) and for the control, the plain
reference run one precision below the configuration (the upper
readings), with the verdict that the run's own rule gives the control
(control_correct). It exits 5 where any seed's control comes out
correct: a comparison that does not fail its control proves nothing.
The benchmark's own runs never run the control.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 20 [--out control.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)
sys.path.insert(0, BENCH)

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = harness.CellSpec.load(ROOT, args.workload)
    harness.pin_caches(ROOT, spec)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(spec, seed=seed, seconds=args.seconds, trace=0,
                             device="cuda", process_start=time.time(),
                             control=True)
        line = json.dumps({"workload": spec.name, "seed": seed,
                           "correct": r["correct"],
                           "control_correct": r["control_correct"],
                           "frames": r["attempted"],
                           "metrics": r["metrics"],
                           "compared": r["compared"]})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if r["control_correct"]:
            passed.append(seed)
    found = harness.forbidden_modules()
    if found:
        print("control: JAX modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    if passed:
        print("control: the control came out correct on seeds "
              + ", ".join(map(str, passed)), file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
