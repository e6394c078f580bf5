#!/usr/bin/env python3
"""Measure K1 (kernels/hme.py hme_search_kernel) on one GPU.

Run by path from the root of a checkout, on a machine with a CUDA card:

  python3 svt_av1_psy_tpu_torch/kernels/k1_bench.py
      builds the kernel of this checkout, prints what ptxas -v said
      (registers, spills, shared memory) and a count of the SASS
      opcodes that matter (cuobjdump -sass), holds the kernel
      against the plain hme_search, and times it;
  ... --tree DIR
      the same for the package in another checkout (an older commit
      unpacked with git archive), whose wrapper may still take int32
      planes and run PyTorch ops around its kernel;
  ... --compare DIR
      this checkout against the one in DIR on the same card, in turns
      (DIR, this, this, DIR), one process each;
  ... --tile ROWS COLS
      this checkout's kernel with another tile of blocks per CTA.

Every run prints one JSON line: per 1088x1920 pair, for uint8, 10-bit
int16 and int32 planes, the function's time by CUDA events over
back-to-back calls on one pair (the planes stay in L2) and with the pairs
rotated through more than the 50 MB of L2, the device time of the CUDA
kernel alone and the number of device kernels one call launches (both
from torch.profiler), beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

H, W = 1088, 1920
N_ROTATE = 16          # uint8 pairs of 4.2 MB: 67 MB, past the 50 MB L2
SASS_OPS = ("VABSDIFF4", "VABSDIFF", "IDP", "VIMNMX", "IMNMX", "IADD3",
            "LOP3", "SHF", "LDS", "LDG", "ATOMS", "PRMT", "STL", "LDL")


def pairs(np, bd: int, n: int):
    """n (src, ref) numpy pairs: noise, and the same shifted plus noise."""
    rng = np.random.default_rng(3)
    dt = np.uint8 if bd == 8 else np.uint16
    out = []
    for _ in range(n):
        src = rng.integers(0, 1 << bd, (H, W)).astype(dt)
        noise = rng.integers(-6, 7, src.shape) << (bd - 8)
        ref = np.clip(np.roll(src, (6, -10), (0, 1)).astype(np.int32) + noise,
                      0, (1 << bd) - 1).astype(dt)
        out.append((src, ref))
    return out


def events_ms(torch, fn, calls: int, reps: int = 7) -> float:
    """Median over reps of the device time per call of `calls`
    back-to-back fn(i), by CUDA events."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def profiled(torch, fn, calls: int):
    """(device ms of the hme_sad_scan kernel per call, device kernels and
    copies per call) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [r for r in prof.key_averages() if r.device_type == cuda]
    k1 = [r for r in rows if "hme_sad_scan" in r.key]
    k1_ms = sum(r.self_device_time_total for r in k1) / 1e3 / calls
    return k1_ms, sum(r.count for r in rows) / calls


def sass_counts(lib: pathlib.Path) -> dict:
    """Per kernel of the library, how often each opcode of SASS_OPS
    occurs (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-300:]}
    out, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.search(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)",
                      line)
        if m and name:
            out[name]["total"] += 1
            op = m.group(1)
            if op in SASS_OPS:
                out[name][op] += 1
    return {k: dict(v) for k, v in out.items()}


def measure(tree: pathlib.Path, tile) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from svt_av1_psy_tpu_torch.kernels import build, hme
    from svt_av1_psy_tpu_torch.ops import torch_backend as tb
    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: needs a CUDA device")
    if tile:
        hme.TILE_ROWS, hme.TILE_COLS = tile
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lib = build.build("hme_sad_scan")
    log = (build.BUILD / "hme_sad_scan.log").read_text()
    print(log.strip(), file=sys.stderr)

    def up(arr, dtype=None):
        if arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        t = torch.from_numpy(arr).to(dev)
        return t if dtype is None else t.to(dtype)

    res = {"tree": str(tree), "tile": tile, "card": card,
           "ptxas": re.findall(r"Used (\d+) registers", log),
           "spills": re.findall(r"(\d+) bytes spill stores", log),
           "sass": sass_counts(lib)}
    # right before fast: both depths against the plain version
    err = 0
    for bd in (8, 10):
        for src, ref in pairs(np, bd, 1):
            s, r = up(src), up(ref)
            mv, sad = hme.hme_search_kernel(s, r)
            pmv, psad = tb.hme_search(s, r)
            torch.cuda.synchronize()
            err = max(err, int((mv.int() - pmv.int()).abs().max()),
                      int((sad - psad).abs().max()))
    res["max_abs_err"] = err
    for name, bd, dtype in (("uint8", 8, None), ("int16", 10, None),
                            ("int32", 8, torch.int32)):
        dev_pairs = [(up(s, dtype), up(r, dtype))
                     for s, r in pairs(np, bd, N_ROTATE)]

        def same(i):
            return hme.hme_search_kernel(*dev_pairs[0])

        def rotated(i):
            return hme.hme_search_kernel(*dev_pairs[i % N_ROTATE])

        k1_ms, n_kernels = profiled(torch, same, 20)
        cold_ms, _ = profiled(torch, rotated, 2 * N_ROTATE)
        res[name] = {"function_ms": events_ms(torch, same, 50),
                     "function_cold_l2_ms": events_ms(torch, rotated,
                                                      2 * N_ROTATE),
                     "kernel_ms": k1_ms, "kernel_cold_l2_ms": cold_ms,
                     "device_kernels_per_call": n_kernels}
        del dev_pairs
        torch.cuda.empty_cache()
    return res


def main() -> None:
    here = pathlib.Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=pathlib.Path, default=here)
    ap.add_argument("--compare", type=pathlib.Path)
    ap.add_argument("--tile", type=int, nargs=2)
    args = ap.parse_args()
    if args.compare is None:
        print(json.dumps(measure(args.tree.resolve(), args.tile)),
              flush=True)
        return
    for tree in (args.compare, here, here, args.compare):
        proc = subprocess.run([sys.executable, __file__, "--tree",
                               str(tree.resolve())], text=True,
                              stdout=subprocess.PIPE)
        if proc.returncode != 0:
            raise SystemExit(f"k1_bench: the run on {tree} failed")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
