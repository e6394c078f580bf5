#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svt_av1_psy_tpu_torch) on one GPU.

Drives the port's main path once through its public API: a 1080p 8-bit
low-delay IPPP encode at preset 10, CRF 30, on "cuda", with the P-frame
motion search on the K1 route (SVT_HME_PALLAS=1). Before that it builds
every CUDA kernel of the path from the sources in this checkout and holds
each against its plain PyTorch version at the shapes the path gives it.

Phases (each ends in torch.cuda.synchronize(); any failure exits non-zero
and prints no result):
  1. the card's name and power limit (nvidia-smi);
  2. build K1 (csrc/hme_sad_scan.cu) with nvcc, timed;
  3. K1 against the plain hme_search on 1088x1920 planes (random,
     shifted + noise, flat where every offset ties): byte-equal, with
     both times (CUDA events, median of several runs);
  4. the encode on "cuda": K1 must launch once per P frame; fps and the
     SVT_TRACE stage times;
  5. the first frames again on "cpu": the payload bytes must be equal.

Run from the root of a checkout:  python3 chip_smoke.py
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
W, H = 1920, 1080
PAD_H, PAD_W = 1088, 1920        # the plane the device search runs on
N_FRAMES = 8
N_CPU_FRAMES = 3
MIN_PSNR_DB = 30.0               # recon sanity floor at CRF 30


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of fn() in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def hme_pair(np, kind: str, seed: int = 3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (PAD_H, PAD_W)).astype(np.uint8)
    if kind == "flat":
        return np.full_like(src, 77), np.full_like(src, 77)
    if kind == "random":
        return src, rng.integers(0, 256, src.shape).astype(np.uint8)
    ref = np.roll(src, (6, -10), (0, 1))
    ref = np.clip(ref.astype(np.int16) + rng.integers(-6, 7, ref.shape),
                  0, 255).astype(np.uint8)
    return src, ref


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not (ROOT / "svt_av1_psy_tpu_torch").is_dir():
        fail("svt_av1_psy_tpu_torch/ is missing: run from a checkout")
    os.environ["SVT_HME_PALLAS"] = "1"
    # per-frame stage times (svt_av1_psy_tpu/utils/trace.py writes one
    # JSON line per frame as each frame closes)
    trace_dir = tempfile.TemporaryDirectory()
    trace_path = pathlib.Path(trace_dir.name) / "trace.jsonl"
    os.environ["SVT_TRACE"] = str(trace_path)
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
    import numpy as np
    from make_test_clip import make_frame

    from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, \
        PredStructure
    from svt_av1_psy_tpu_torch.kernels import build
    from svt_av1_psy_tpu_torch.kernels.hme import hme_search_kernel
    from svt_av1_psy_tpu_torch.ops import torch_backend as tb

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    phase("card")
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)")

    phase("build K1 from csrc/hme_sad_scan.cu")
    shutil.rmtree(build.BUILD, ignore_errors=True)
    t0 = time.perf_counter()
    lib = build.build("hme_sad_scan")
    build_s = time.perf_counter() - t0
    print(f"built {lib.relative_to(ROOT)} in {build_s:.2f} s")
    print((build.BUILD / "hme_sad_scan.log").read_text().strip())

    phase("K1 vs plain hme_search at 1088x1920")
    k1_err = 0
    for pair in ("random", "shifted", "flat"):
        src, ref = hme_pair(np, pair)
        s, r = tb.plane_tensor(src, dev), tb.plane_tensor(ref, dev)
        mv_k, sad_k = hme_search_kernel(s, r)
        mv_p, sad_p = tb.hme_search(s, r)
        torch.cuda.synchronize()
        if mv_k.dtype != mv_p.dtype or sad_k.dtype != sad_p.dtype:
            fail(f"K1 dtypes {mv_k.dtype}, {sad_k.dtype} differ from plain")
        err = max(int((mv_k.int() - mv_p.int()).abs().max()),
                  int((sad_k - sad_p).abs().max()))
        print(f"{pair:8s} max_abs_err {err} (mv {tuple(mv_k.shape)}, "
              f"sad {tuple(sad_k.shape)})")
        k1_err = max(k1_err, err)
    if k1_err != 0:
        fail(f"K1 disagrees with the plain hme_search: max_abs_err {k1_err}")
    # time on the shifted pair, in turns: plain, K1, K1, plain
    s, r = (tb.plane_tensor(x, dev) for x in hme_pair(np, "shifted"))
    runs = {"plain": [], "k1": []}
    fns = {"plain": (tb.hme_search, 5), "k1": (hme_search_kernel, 50)}
    for name in ("plain", "k1", "k1", "plain"):
        fn, reps = fns[name]
        runs[name].append(cuda_ms(torch, lambda: fn(s, r), reps))
    k1_ms = statistics.median(runs["k1"])
    plain_ms = statistics.median(runs["plain"])
    decide_ms = cuda_ms(torch, lambda: tb.intra_decide_packed(s, 700), 5)
    torch.cuda.synchronize()
    print(f"K1 hme_search_kernel {k1_ms:.4f} ms, plain hme_search "
          f"{plain_ms:.4f} ms per 1088x1920 frame (includes the PyTorch "
          f"decimation + pad); plain intra_decide_packed {decide_ms:.4f} ms "
          f"[{card}]")

    phase(f"encode {N_FRAMES} frames 1080p LD preset 10 CRF 30 on cuda")
    rng = np.random.default_rng(7)
    frames = [make_frame(W, H, t, 8, 0.02, rng) for t in range(N_FRAMES)]
    cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_B)
    enc = Encoder(cfg, W, H, device="cuda")
    hme_search_kernel.launches = 0
    outs, frame_s = [], []
    t0 = time.perf_counter()
    for f in frames:
        tf = time.perf_counter()
        outs.append(enc.encode(*f))
        frame_s.append(time.perf_counter() - tf)
    enc.close()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = hme_search_kernel.launches
    n_p = N_FRAMES - 1
    if launches != n_p:
        fail(f"K1 launched {launches} times for {n_p} P frames")
    fps = N_FRAMES / total_s
    steady = (N_FRAMES - 1) / sum(frame_s[1:])
    print(f"{N_FRAMES} frames in {total_s:.3f} s: {fps:.3f} fps; frames "
          f"2..{N_FRAMES} {steady:.3f} fps; K1 launches {launches} "
          f"[{card}]")
    print("frame ms: " + ", ".join(f"{1e3 * t:.1f}" for t in frame_s))
    print("bytes: " + ", ".join(str(len(o.payload)) for o in outs))
    stages = {}
    for line in trace_path.read_text().splitlines():
        for name, ms in json.loads(line).items():
            if name != "frame":
                stages.setdefault(name, []).append(ms)
    for name, ms in sorted(stages.items()):
        print(f"  {name:<20} total {sum(ms):>10.2f} ms  x{len(ms):<3} "
              f"mean {statistics.mean(ms):.3f} ms")
    for i, (f, o) in enumerate(zip(frames, outs)):
        rec = o.recon_y
        if rec.shape != (H, W) or rec.dtype.kind != "u" or not o.payload:
            fail(f"frame {i}: recon {rec.shape} {rec.dtype}, "
                 f"{len(o.payload)} payload bytes")
        mse = float(np.mean((rec.astype(np.float64) - f[0]) ** 2))
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
        if not psnr >= MIN_PSNR_DB:
            fail(f"frame {i}: luma PSNR {psnr:.2f} dB < {MIN_PSNR_DB}")
    print("recon shapes and luma PSNR >= "
          f"{MIN_PSNR_DB} dB: ok")

    phase(f"first {N_CPU_FRAMES} frames on cpu: same payload bytes")
    enc = Encoder(cfg, W, H, device="cpu")
    cpu = [enc.encode(*f).payload for f in frames[:N_CPU_FRAMES]]
    enc.close()
    for i, (a, b) in enumerate(zip(cpu, outs)):
        if a != b.payload:
            fail(f"frame {i}: cpu payload ({len(a)} B) differs from cuda "
                 f"({len(b.payload)} B)")
    print(f"frames 0..{N_CPU_FRAMES - 1}: byte-equal")
    torch.cuda.synchronize()

    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "hme_sad_scan", "route": "cuda",
        "source": "svt_av1_psy_tpu_torch/csrc/hme_sad_scan.cu",
        "replaces": "svt_av1_psy_tpu/ops/jax_backend.py:689",
        "launches": launches, "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
