#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA AV1 encoder (svt_av1_psy_tpu_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json on the card of this machine: builds the
encoder (or finds its build in the checkout), warms it up, feeds it frames
for --seconds, checks what the timed path produced against the plain
reference (benchmark/reference/), and prints one JSON line as the last
line of its standard output. --trace 0 reports the cell's end-to-end
metrics, --trace 1 its per-layer metrics (SVT_TRACE spans, the harness's
own spans, torch.profiler over the window). Exits non-zero, printing no
result, without a CUDA device, when a cell asks for more cards than there
are, and when JAX or the JAX package was loaded. See benchmark/README.md.
"""

from __future__ import annotations

import os
import sys
import time

# the time this interpreter started, for setup_s: from /proc where there
# is one (it counts the interpreter's own start), else now


def _process_start() -> float:
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = float(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - (uptime - started)
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# the program is the checkout's svt_av1_psy_tpu_torch; the harness's own
# modules sit beside this file
sys.path.insert(0, ROOT)
sys.path.insert(0, BENCH)

import harness  # noqa: E402


def main(argv=None) -> int:
    args = harness.parse_args(argv)
    try:
        spec = harness.CellSpec.load(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    harness.pin_caches(ROOT, spec)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "False); this benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < spec.chips:
        print(f"benchmark: cell {spec.name} needs {spec.chips} CUDA "
              f"devices, this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(spec, seed=args.seed, seconds=args.seconds,
                              trace=args.trace, device="cuda",
                              process_start=PROCESS_START)
    found = harness.forbidden_modules()
    if found:
        print("benchmark: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
