#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svt_av1_psy_tpu_torch) on one GPU.

Drives the port's paths once each through its public API, on "cuda", at
1080p 8-bit, CRF 30:
  - low delay (IPPP) at preset 10 with the P-frame motion search on the
    K1 route (SVT_HME_PALLAS=1);
  - low delay at preset 10 on the default route (the two-level
    hme_search2);
  - random access at preset 10: one key plus one 32-frame mini-GoP
    (5-level pyramid) with temporal filtering and TPL on, its device
    search one GoP program (gop_search_tf) per mini-GoP;
  - the north star (bench.py bench_northstar): 64 frames of random access
    at preset 6, where loop restoration is on and runs its search program
    (DeviceLrSearch) on every coded frame;
  - the full-RD route (IntraEncoder, its mode costs in block_mode_costs):
    a screen-content key at preset 10 and a preset-3 encode.
Before that it builds every CUDA kernel from the sources in this checkout
and holds each against its plain PyTorch version at the shapes the path
gives it. K1 is the only hand-written kernel; the other device programs
are plain PyTorch.

Phases (each ends in torch.cuda.synchronize(); any failure exits non-zero
and prints no result):
  1. the card's name and power limit (nvidia-smi);
  2. build K1 (csrc/hme_sad_scan.cu) with nvcc, timed;
  3. K1 against the plain hme_search on 1088x1920 planes (random,
     shifted + noise, flat where every offset ties): byte-equal, with
     both times (CUDA events, median of several runs);
  4. the LD encode on the K1 route: K1 must launch once per P frame; fps
     and the SVT_TRACE stage times;
  5. its first frames again on "cpu": the payload bytes must be equal;
  6. the plain programs of the default route and of random access at
     1088x1920 (hme_search2, hme_sad_tree, tf_filter_device with T = 5,
     and one gop_search_tf for a 32-frame mini-GoP: 33 frames, 96
     edges), timed with CUDA events, the GoP program's parts timed
     alone, and its device busy share (torch.profiler);
  7. the LD encode on the default route, and the same frames on "cpu":
     equal payload bytes;
  8. the RA encode: all 33 frames shown in display order above the PSNR
     floor; fps and the SVT_TRACE stage times;
  9. RA at 352x288 (3 levels, 17 frames) on "cuda" and "cpu": equal
     payload bytes with TF off; with TF on, the count of temporally
     filtered pixels that differ between the devices, and the largest
     difference;
 10. block_mode_costs on a 1088x1920 plane at sizes 64/32/16/8: cuda
     equal to cpu, timed;
 11. the LR search program on a 1080p recon/source pair from phase 4:
     its dispatch under torch.cuda.set_sync_debug_mode("error") (a host
     sync fails the run), taps within 1 of the cpu run's, the counts of
     differing taps, SSEs and decisions, its time (CUDA events) and the
     kernels one program launches;
 12. the north star: all 64 frames shown in display order above the PSNR
     floor; fps, the LR programs it launched and the SVT_TRACE stage
     totals;
 13. preset-6 RA at 352x288 (3 levels, 17 frames) on "cuda" and "cpu":
     equal payload bytes, or LR tap or decision differences that explain
     the difference; the cuda stream decoded by the repo's own decoder
     (svt_av1_psy_tpu/decoder) equals its recon;
 14. a screen-content key (preset 10, --scm 2 flags it) and a preset-3
     encode at 176x144: cuda payload bytes equal cpu's.

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
N_DEFAULT_FRAMES = 4             # LD on the default route
RA_LEVELS, RA_FRAMES = 5, 33     # one key + one 32-frame mini-GoP
CMP_W, CMP_H, CMP_LEVELS, CMP_FRAMES = 352, 288, 3, 17
NS_FRAMES = 64                   # the north star (bench.py bench_northstar)
SC_W, SC_H = 176, 144            # the full-RD route's host walk is Python
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


def psnr_check(np, frame_y, rec_y, what: str) -> float:
    if rec_y.shape != frame_y.shape or rec_y.dtype.kind != "u":
        fail(f"{what}: recon {rec_y.shape} {rec_y.dtype}")
    mse = float(np.mean((rec_y.astype(np.float64) - frame_y) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    if not psnr >= MIN_PSNR_DB:
        fail(f"{what}: luma PSNR {psnr:.2f} dB < {MIN_PSNR_DB}")
    return psnr


def trace_stages(json, trace_path, first_line: int) -> dict:
    """{stage: [ms per frame]} of the SVT_TRACE lines from first_line on."""
    stages = {}
    lines = trace_path.read_text().splitlines() if trace_path.exists() \
        else []
    for line in lines[first_line:]:
        for name, ms in json.loads(line).items():
            if name != "frame":
                stages.setdefault(name, []).append(ms)
    return stages


def trace_lines(trace_path) -> int:
    return len(trace_path.read_text().splitlines()) \
        if trace_path.exists() else 0


def print_stages(stages: dict) -> None:
    for name, ms in sorted(stages.items()):
        print(f"  {name:<20} total {sum(ms):>10.2f} ms  x{len(ms):<3} "
              f"mean {statistics.mean(ms):.3f} ms")


def gop_program_args(np, torch, tb, ys, us, vs, levels, dev):
    """The arguments RaDriver._dispatch_gop gives gop_search_tf for the
    mini-GoP after a key at display 0: the stack
    (base, then the plan in encode order), the edges padded to 3M with
    (0, 0), the ARF's window (the 4 frames before it) and the depth-1 mid
    anchor's (+-2, the base's slot masked out)."""
    from svt_av1_psy_tpu_torch.models.ra import RaDriver
    M = 1 << levels
    plan = RaDriver._tpl_plan(None, 0, M)
    ds = [0] + [p[0] for p in plan]
    idx = {d: i for i, d in enumerate(ds)}
    stack = np.stack([ys[d] for d in ds])
    edges = np.zeros((3 * M, 2), np.int32)
    n = 0
    for d, lo, hi, *_ in plan:
        for r in ([lo] if hi == lo else [lo, hi]) + ([] if 0 in (lo, hi)
                                                     else [0]):
            edges[n] = (idx[d], idx[r])
            n += 1

    def window(ds_, center):
        order = list(ds_) + [center]
        return (tb.plane_tensor(np.stack([us[d] for d in order]), dev),
                tb.plane_tensor(np.stack([vs[d] for d in order]), dev),
                np.array([idx[d] for d in order], np.int32),
                torch.ones(len(order)))

    mid = plan[1][0]
    arf = window(range(M - 4, M), M)
    mid_w = window((mid - 2, mid - 1, mid + 1, mid + 2), mid)
    return tb.plane_tensor(stack, dev), edges, n, arf, mid_w


def text_frame(np, w: int, h: int, t: int):
    """Text-like screen content (a title bar and short dark strokes on a
    light page, the bottom quarter scrolling with t): the --scm 2
    detector flags it."""
    y = np.full((h, w), 235, np.uint8)
    y[: h // 8, :] = 64
    r = np.random.default_rng(5)
    for _ in range(40):
        gx = int(r.integers(4, w - 12))
        gy = int(r.integers(h // 8 + 4, h - 8))
        y[gy:gy + 2, gx:gx + int(r.integers(2, 9))] = 16
    sh = h // 4
    y[h - sh:, :] = np.roll(y[h - sh:, :], -(2 * t) % sh, axis=0)
    uv = np.full((h // 2, w // 2), 128, np.uint8)
    return y, uv, uv.copy()


def lr_taps(np, buf, grids) -> list:
    """The six taps (vt + ht) of each plane in a packed LR program
    result."""
    out, off = [], 0
    for urows, ucols, _, _ in grids:
        out.append(np.asarray(buf)[off:off + 6])
        off += 6 + 2 * urows * ucols
    return out


class LrLog:
    """Records the packed result and the decision of every LR search
    that the encoders of one device finish, in order (a spy on the
    port's DeviceLrSearch.finish; the encode runs unchanged)."""

    def __init__(self, np, cls):
        self.cls = cls
        self.orig = cls.finish
        self.runs = {}
        self.name = None
        log = self

        def finish(inner, token, rdmult):
            dec = log.orig(inner, token, rdmult)
            log.runs.setdefault(log.name, []).append(
                (np.asarray(token).copy(), inner.grids, dec))
            return dec

        cls.finish = finish

    def close(self) -> None:
        self.cls.finish = self.orig


def lr_diffs(np, a: list, b: list):
    """(searches compared, taps that differ, largest tap difference,
    decisions that differ) between two LrLog runs."""
    n_taps = max_diff = n_dec = 0
    for (ba, grids, da), (bb, _, db) in zip(a, b):
        for ta, tb_ in zip(lr_taps(np, ba, grids), lr_taps(np, bb, grids)):
            n_taps += int((ta != tb_).sum())
            max_diff = max(max_diff, int(np.abs(ta - tb_).max()))
        same = (da is None) == (db is None) and (da is None or (
            da.lr_type == db.lr_type and da.units == db.units))
        n_dec += not same
    return min(len(a), len(b)), n_taps, max_diff, n_dec


def decisions_summary(dec) -> str:
    if dec is None:
        return "none"
    return "lr_type %s, Wiener units %s" % (
        dec.lr_type, [sum(u.get("type", 0) for u in p.values())
                      for p in dec.units])


def mode_costs_phase(np, torch, tb, plane, dev, card) -> None:
    """block_mode_costs at the four sizes of IntraEncoder._decide: cuda
    equal to cpu, and timed per size and for the four together."""
    cpu = torch.device("cpu")
    p_cuda, p_cpu = tb.plane_tensor(plane, dev), tb.plane_tensor(plane, cpu)
    times = {}
    for s in (64, 32, 16, 8):
        got = tb.block_mode_costs(p_cuda, s)
        want = tb.block_mode_costs(p_cpu, s)
        for g, w in zip(got, want):
            if not torch.equal(g.cpu(), w):
                fail(f"block_mode_costs at size {s}: cuda differs from cpu")
        times[s] = cuda_ms(torch, lambda: tb.block_mode_costs(p_cuda, s), 10)
    all4 = cuda_ms(torch, lambda: [tb.block_mode_costs(p_cuda, s)
                                   for s in (64, 32, 16, 8)], 10)
    torch.cuda.synchronize()
    print("cuda == cpu at sizes 64/32/16/8: ok")
    print("block_mode_costs " + ", ".join(
        f"{s}: {ms:.4f} ms" for s, ms in times.items()) +
        f"; all four {all4:.4f} ms per {plane.shape[0]}x{plane.shape[1]} "
        f"plane [{card}]")


def lr_phase(np, torch, src, rec, base_q, dev, card) -> None:
    """The LR search program on one 1080p recon/source pair: cuda against
    cpu, the cuda dispatch under sync debug mode "error", timed."""
    from torch.profiler import ProfilerActivity, profile

    from svt_av1_psy_tpu.ops.quant import ac_q
    from svt_av1_psy_tpu_torch.models.lr_search import (DeviceLrSearch,
                                                        _upload)
    dims = [(W, H)] + [((W + 1) // 2, (H + 1) // 2)] * 2
    lr = {d: DeviceLrSearch(dims, 8, device=d) for d in (dev, "cpu")}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok = lr[dev].dispatch(src, rec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = lr["cpu"].dispatch(src, rec)
    got_buf, want_buf = np.asarray(tok), np.asarray(want)
    grids = lr["cpu"].grids
    n_diff = max_diff = 0
    off = 0
    for plane, (ta, tw) in enumerate(zip(lr_taps(np, got_buf, grids),
                                         lr_taps(np, want_buf, grids))):
        urows, ucols, _, _ = grids[plane]
        n = urows * ucols
        d = int(np.abs(ta - tw).max())
        n_diff += int((ta != tw).sum())
        max_diff = max(max_diff, d)
        sse = [(got_buf[off + 6 + k * n:off + 6 + (k + 1) * n],
                want_buf[off + 6 + k * n:off + 6 + (k + 1) * n])
               for k in (0, 1)]
        rel = [float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1)))
               for g, w in sse]
        print(f"plane {plane}: taps cuda {ta.astype(int).tolist()} cpu "
              f"{tw.astype(int).tolist()}; {n} units, SSE max relative "
              f"difference {rel[0]:.3g} (none) {rel[1]:.3g} (Wiener)")
        off += 6 + 2 * n
    if max_diff > 1:
        fail(f"LR taps differ by {max_diff} between cuda and cpu")
    qstep = ac_q(base_q, 8) / 8.0
    rdmult = 0.12 * qstep * qstep
    dec_cuda = lr[dev].finish(tok, rdmult)
    dec_cpu = lr["cpu"].finish(want, rdmult)
    print(f"taps differing cuda vs cpu: {n_diff} of 18 (largest "
          f"difference {max_diff}); decision cuda: "
          f"{decisions_summary(dec_cuda)}; cpu: {decisions_summary(dec_cpu)}")
    args = [_upload(np.asarray(p)[:ph, :pw], torch.device(dev))
            for planes in (rec, src) for p, (pw, ph) in zip(planes, dims)]
    ms = cuda_ms(torch, lambda: lr[dev]._fn(*args), 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lr[dev]._fn(*args)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [r for r in prof.key_averages() if r.device_type == cuda]
    n_kernels = sum(r.count for r in rows)
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    # the host's share of the loop_restoration stage: launching the
    # search, and applying a decision to the recon (numpy, normative)
    from svt_av1_psy_tpu.ops.restoration import apply_lr_frame
    t0 = time.perf_counter()
    tok = lr[dev].dispatch(src, rec)
    launch_ms = 1e3 * (time.perf_counter() - t0)
    np.asarray(tok)
    apply_ms = 0.0
    if dec_cpu is not None:
        planes = [np.array(p, np.uint16) for p in rec]
        pre = [p.copy() for p in planes]
        t0 = time.perf_counter()
        apply_lr_frame(planes, pre, dims, dec_cpu.lr_type,
                       dec_cpu.unit_size, dec_cpu.units, bd=8)
        apply_ms = 1e3 * (time.perf_counter() - t0)
    print(f"LR program {ms:.4f} ms per 1080p frame (device busy "
          f"{busy_ms:.4f} ms of it under the profiler), {n_kernels} "
          f"kernels and copies per program; dispatch made no host sync; "
          f"host: dispatch {launch_ms:.3f} ms, apply_lr_frame "
          f"{apply_ms:.3f} ms [{card}]")


def encode_ra(enc, frames) -> list:
    try:
        return [p for f in frames for p in enc.send_picture(*f)] + \
            enc.flush()
    finally:
        enc.close()


def north_star_phase(np, torch, json, Encoder, EncoderConfig, make_frame,
                     lr_cls, trace_path, card) -> None:
    """bench.py bench_northstar through the port on cuda: 64 frames of
    1080p preset 6 CRF 30 RA, 5 levels, TF 1, TPL on, LR on."""
    rng = np.random.default_rng(7)
    frames = [make_frame(W, H, t, 8, 0.02, rng) for t in range(NS_FRAMES)]
    cfg = EncoderConfig(enc_mode=6, qp=30, intra_period_length=-1,
                        hierarchical_levels=5, tf_strength=1,
                        enable_tpl_la=1)
    first = trace_lines(trace_path)
    enc = Encoder(cfg, W, H, device="cuda")
    if not enc._enc.enable_lr:
        fail("preset 6 did not turn loop restoration on")
    log = LrLog(np, lr_cls)
    log.name = "north star"
    try:
        t0 = time.perf_counter()
        pkts = encode_ra(enc, frames)
        torch.cuda.synchronize()
        ns_s = time.perf_counter() - t0
    finally:
        log.close()
    shown = [p for p in pkts if p.display_idx >= 0]
    if [p.display_idx for p in shown] != list(range(NS_FRAMES)):
        fail(f"north star shown order {[p.display_idx for p in shown]}")
    psnrs = [psnr_check(np, frames[p.display_idx][0], p.recon[0],
                        f"north star display {p.display_idx}")
             for p in shown]
    searches = log.runs.get("north star", [])
    n_wiener = sum(d is not None for _, _, d in searches)
    if not n_wiener:
        fail("the north star signalled no loop restoration")
    print(f"{NS_FRAMES} frames in {ns_s:.3f} s: {NS_FRAMES / ns_s:.3f} fps; "
          f"{len(pkts)} TUs, {sum(len(p.payload) for p in pkts)} bytes; "
          f"luma PSNR {min(psnrs):.2f}..{max(psnrs):.2f} dB; LR programs "
          f"finished {len(searches)}, {n_wiener} of them signalled Wiener "
          f"[{card}]")
    print_stages(trace_stages(json, trace_path, first))


def preset6_cmp_phase(np, torch, Encoder, EncoderConfig, make_frame,
                      lr_cls) -> None:
    """Preset-6 RA at 352x288 on cuda and cpu; the cuda stream through
    the repo's own decoder."""
    from svt_av1_psy_tpu.decoder.driver import Decoder
    rng = np.random.default_rng(11)
    small = [make_frame(CMP_W, CMP_H, t, 8, 0.02, rng)
             for t in range(CMP_FRAMES)]
    cfg = EncoderConfig(enc_mode=6, qp=30, intra_period_length=-1,
                        hierarchical_levels=CMP_LEVELS, tf_strength=1)
    log = LrLog(np, lr_cls)
    pkts = {}
    try:
        for name in ("cuda", "cpu"):
            log.name = name
            pkts[name] = encode_ra(Encoder(cfg, CMP_W, CMP_H, device=name),
                                   small)
    finally:
        log.close()
    torch.cuda.synchronize()
    n, n_taps, max_diff, n_dec = lr_diffs(np, log.runs.get("cuda", []),
                                          log.runs.get("cpu", []))
    same = [p.payload for p in pkts["cuda"]] == \
        [p.payload for p in pkts["cpu"]]
    print(f"payload bytes {'equal' if same else 'differ'}; LR searches "
          f"{n}: {n_taps} taps differ (largest {max_diff}), {n_dec} "
          "decisions differ")
    if max_diff > 1:
        fail(f"LR taps differ by {max_diff} between cuda and cpu")
    if not same and not (n_taps or n_dec):
        fail("preset-6 RA: cuda payload differs from cpu with equal LR "
             "searches")
    dec = Decoder()
    for p in pkts["cuda"]:
        dec.decode_temporal_unit(p.payload)
    shown = [p for p in pkts["cuda"] if p.display_idx >= 0]
    if len(dec.frames) != CMP_FRAMES or len(shown) != CMP_FRAMES:
        fail(f"own decoder gave {len(dec.frames)} frames, "
             f"{len(shown)} shown")
    for d, p in zip(dec.frames, shown):
        for plane, rec in zip((d.y, d.u, d.v), p.recon):
            if not np.array_equal(plane, rec):
                fail(f"own decoder differs from the recon at display "
                     f"{p.display_idx}")
    print(f"cuda stream: {CMP_FRAMES} frames decoded by the repo's decoder, "
          "equal to the recon")


def full_rd_phase(np, torch, Encoder, EncoderConfig, PredStructure,
                  make_frame) -> None:
    """The full-RD route on cuda and cpu at 176x144: a screen-content key
    (preset 10, --scm 2) and a preset-3 encode; equal payload bytes."""
    from svt_av1_psy_tpu_torch.models.fast_intra import FastIntraEncoder
    from svt_av1_psy_tpu_torch.models.intra_encoder import IntraEncoder
    ld = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                       pred_structure=PredStructure.LOW_DELAY_B)
    rng = np.random.default_rng(7)
    cases = {
        "screen-content key, preset 10":
            (ld, [text_frame(np, SC_W, SC_H, t) for t in range(2)]),
        "preset 3": (ld.replace(enc_mode=3),
                     [make_frame(SC_W, SC_H, t, 8, 0.02, rng)
                      for t in range(2)]),
    }
    sc_keys = []
    orig = FastIntraEncoder._encode_key_sc

    def spy(self, *args):
        sc_keys.append(self.frame_index)
        return orig(self, *args)

    FastIntraEncoder._encode_key_sc = spy
    try:
        for what, (cfg, frames) in cases.items():
            out = {}
            for name in ("cuda", "cpu"):
                enc = Encoder(cfg, SC_W, SC_H, device=name)
                if cfg.enc_mode < 4 and type(enc._enc) is not IntraEncoder:
                    fail(f"{what}: routed to {type(enc._enc).__name__}")
                t0 = time.perf_counter()
                out[name] = [enc.encode(*f).payload for f in frames]
                enc.close()
                torch.cuda.synchronize()
                print(f"{what} on {name}: {len(frames)} frames in "
                      f"{time.perf_counter() - t0:.3f} s, "
                      f"{[len(b) for b in out[name]]} bytes")
            if out["cuda"] != out["cpu"]:
                fail(f"{what}: cuda payload differs from cpu")
    finally:
        FastIntraEncoder._encode_key_sc = orig
    if sc_keys != [0, 0]:
        fail(f"the text key took the screen-content route {sc_keys}")
    print("cuda == cpu bytes on both; the text key went through "
          "_encode_key_sc on both devices")


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
    from svt_av1_psy_tpu_torch.utils.device import HostCopy

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
    print_stages(trace_stages(json, trace_path, 0))
    for i, (f, o) in enumerate(zip(frames, outs)):
        if not o.payload:
            fail(f"frame {i}: empty payload")
        psnr_check(np, f[0], o.recon_y, f"frame {i}")
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
    k1_launches = launches

    # the remaining paths run without a route switch: hme_search2
    del os.environ["SVT_HME_PALLAS"]
    ra_frames = [make_frame(W, H, t, 8, 0.02, rng) for t in range(RA_FRAMES)]

    phase("plain programs at 1088x1920 on cuda")
    from svt_av1_psy_tpu.models.intra_encoder import _pad_to
    from svt_av1_psy_tpu_torch.ops.torch_backend import EDGE_CHUNK
    ys = [_pad_to(f[0], PAD_H, PAD_W) for f in ra_frames]
    us = [_pad_to(f[1], PAD_H // 2, PAD_W // 2) for f in ra_frames]
    vs = [_pad_to(f[2], PAD_H // 2, PAD_W // 2) for f in ra_frames]
    stack, edges, n_edges, arf_w, mid_w = gop_program_args(
        np, torch, tb, ys, us, vs, RA_LEVELS, dev)
    src, ref = stack[1], stack[0]                 # the ARF against the key
    mv2, _ = tb.hme_search2(src, ref)
    win_y = stack[torch.as_tensor(arf_w[2], dtype=torch.long, device=dev)]
    bias = 700

    def gop_program():
        return tb.gop_search_tf(stack, edges, bias, arf_w[0], arf_w[1],
                                arf_w[2], arf_w[3], 1.0, 8, 8, mid_w[0],
                                mid_w[1], mid_w[2], mid_w[3])

    # the parts of gop_program, each looped as the program loops it
    e = torch.as_tensor(edges, dtype=torch.long, device=dev)
    chunks = [(stack[c[:, 0]], stack[c[:, 1]]) for c in e.split(EDGE_CHUNK)]
    mvs = [tb.hme_search2(a, b)[0] for a, b in chunks]
    parts = {
        "decide x33": lambda: [tb.intra_decide_packed(f, bias)
                               for f in stack],
        "hme_search2 x96": lambda: [tb.hme_search2(a, b) for a, b in chunks],
        "hme_sad_tree x96": lambda: [tb.hme_sad_tree(a, b, m)
                                     for (a, b), m in zip(chunks, mvs)],
        "tf_filter_device x2": lambda: [tb.tf_filter_device(
            win_y, arf_w[0], arf_w[1], arf_w[3], 1.0) for _ in (0, 1)],
    }
    prog_ms = {
        "hme_search2": cuda_ms(torch, lambda: tb.hme_search2(src, ref), 5),
        "hme_sad_tree": cuda_ms(torch,
                                lambda: tb.hme_sad_tree(src, ref, mv2), 5),
        "tf_filter_device T=5": cuda_ms(torch, lambda: tb.tf_filter_device(
            win_y, arf_w[0], arf_w[1], arf_w[3], 1.0), 3),
        "gop_search_tf M=32": cuda_ms(torch, gop_program, 3),
    }
    for name, fn in parts.items():
        prog_ms[f"  part: {name}"] = cuda_ms(torch, fn, 2)
    # the global candidates' share of hme_search2: one chunk of 8 edges
    a, b = chunks[0]
    for k in ("4", "0"):
        os.environ["SVT_HME_GLOBK"] = k
        prog_ms[f"hme_search2 x8 edges, K_GLOB {k}"] = cuda_ms(
            torch, lambda: tb.hme_search2(a, b), 3)
    del os.environ["SVT_HME_GLOBK"]
    for name, ms in prog_ms.items():
        print(f"{name:<32} {ms:10.3f} ms [{card}]")
    print(f"GoP program: {len(stack)} frames, {len(edges)} edges "
          f"({n_edges} of the plan, the rest padding)")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        HostCopy(gop_program()).numpy()
        gop_wall_ms = 1e3 * (time.perf_counter() - t0)
    # device rows only: the aten rows carry their kernels' time as well
    cuda = torch.autograd.DeviceType.CUDA
    rows = [r for r in prof.key_averages() if r.device_type == cuda]
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    n_kernels = sum(r.count for r in rows)
    print(f"GoP program under torch.profiler: {n_kernels} kernels and "
          f"copies, device busy {busy_ms:.3f} ms of {gop_wall_ms:.3f} ms "
          f"wall, share {busy_ms / gop_wall_ms:.4f} [{card}]")
    print("largest device rows (self device ms, calls):")
    for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:8]:
        print(f"  {r.self_device_time_total / 1e3:10.3f} ms x{r.count:<6} "
              f"{r.key[:90]}")
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time for the GoP program")
    del stack, win_y, src, ref, mv2, e, chunks, mvs, parts, a, b
    torch.cuda.empty_cache()

    phase(f"encode {N_DEFAULT_FRAMES} frames 1080p LD on the default route "
          "(hme_search2) on cuda and on cpu")
    hme_search_kernel.launches = 0
    ld = {}
    for name in ("cuda", "cpu"):
        enc = Encoder(cfg, W, H, device=name)
        t0 = time.perf_counter()
        ld[name] = [enc.encode(*f) for f in frames[:N_DEFAULT_FRAMES]]
        enc.close()
        torch.cuda.synchronize()
        print(f"{name}: {N_DEFAULT_FRAMES} frames in "
              f"{time.perf_counter() - t0:.3f} s")
    if hme_search_kernel.launches:
        fail("K1 launched on the default route")
    for i, (a, b) in enumerate(zip(ld["cpu"], ld["cuda"])):
        if a.payload != b.payload:
            fail(f"default route frame {i}: cpu payload ({len(a.payload)} "
                 f"B) differs from cuda ({len(b.payload)} B)")
        psnr_check(np, frames[i][0], b.recon_y, f"default route frame {i}")
    print(f"frames 0..{N_DEFAULT_FRAMES - 1}: byte-equal, PSNR >= "
          f"{MIN_PSNR_DB} dB")

    phase(f"encode {RA_FRAMES} frames 1080p RA preset 10 CRF 30, "
          f"{RA_LEVELS} levels, TF 1, TPL on, on cuda")
    ra_cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                           hierarchical_levels=RA_LEVELS, enable_tf=1,
                           tf_strength=1, enable_tpl_la=1)
    first = trace_lines(trace_path)
    enc = Encoder(ra_cfg, W, H, device="cuda")
    pkts = []
    t0 = time.perf_counter()
    for f in ra_frames:
        pkts += enc.send_picture(*f)
    pkts += enc.flush()
    enc.close()
    torch.cuda.synchronize()
    ra_s = time.perf_counter() - t0
    shown = [p for p in pkts if p.display_idx >= 0]
    if [p.display_idx for p in shown] != list(range(RA_FRAMES)):
        fail(f"RA shown order {[p.display_idx for p in shown]}")
    psnrs = [psnr_check(np, ra_frames[p.display_idx][0], p.recon[0],
                        f"RA display {p.display_idx}") for p in shown]
    print(f"{RA_FRAMES} frames in {ra_s:.3f} s: {RA_FRAMES / ra_s:.3f} fps; "
          f"{len(pkts)} TUs, {sum(len(p.payload) for p in pkts)} bytes; "
          f"luma PSNR {min(psnrs):.2f}..{max(psnrs):.2f} dB [{card}]")
    print_stages(trace_stages(json, trace_path, first))

    phase(f"RA {CMP_W}x{CMP_H}, {CMP_LEVELS} levels, {CMP_FRAMES} frames: "
          "cuda vs cpu")
    small = [make_frame(CMP_W, CMP_H, t, 8, 0.02, rng)
             for t in range(CMP_FRAMES)]
    for tf in (0, 1):
        c = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                          hierarchical_levels=CMP_LEVELS, enable_tf=tf,
                          tf_strength=1)
        streams = {}
        for name in ("cuda", "cpu"):
            enc = Encoder(c, CMP_W, CMP_H, device=name)
            streams[name] = [p.payload for f in small
                             for p in enc.send_picture(*f)]
            streams[name] += [p.payload for p in enc.flush()]
            enc.close()
        same = streams["cuda"] == streams["cpu"]
        print(f"TF {'on' if tf else 'off'}: payload bytes "
              f"{'equal' if same else 'differ'}")
        if not tf and not same:
            fail("RA with TF off: cuda payload differs from cpu")
    # the TF planes themselves: the ARF window of that clip, both devices
    ph, pw = -(-CMP_H // 64) * 64, -(-CMP_W // 64) * 64    # as the encoder
    sm = [[_pad_to(f[k], ph >> (k > 0), pw >> (k > 0)) for f in small[4:9]]
          for k in range(3)]
    cpu_dev = torch.device("cpu")
    tf_out = {d: tb.tf_filter_device(*(tb.plane_tensor(np.stack(p), d)
                                       for p in sm), torch.ones(5), 1.0)
              for d in (dev, cpu_dev)}
    tf_diff = tf_max = 0
    for a, b in zip(tf_out[dev], tf_out[cpu_dev]):
        d = (a.cpu() - b).abs()
        tf_diff += int((d > 0).sum())
        tf_max = max(tf_max, int(d.max()))
    n_px = sum(t.numel() for t in tf_out[cpu_dev])
    print(f"tf_filter_device cuda vs cpu ({CMP_W}x{CMP_H}, T = 5): "
          f"{tf_diff} of {n_px} pixels differ, largest difference {tf_max}")
    torch.cuda.synchronize()

    from svt_av1_psy_tpu_torch.models.lr_search import DeviceLrSearch

    phase("block_mode_costs at 1088x1920: cuda vs cpu")
    mode_costs_phase(np, torch, tb, ys[0], dev, card)

    phase("LR search program at 1080p: cuda vs cpu")
    lr_phase(np, torch, frames[1], (outs[1].recon_y, outs[1].recon_u,
                                    outs[1].recon_v), 120, dev, card)

    phase(f"north star: encode {NS_FRAMES} frames 1080p RA preset 6 CRF 30, "
          "5 levels, TF 1, TPL on, LR on, on cuda")
    north_star_phase(np, torch, json, Encoder, EncoderConfig, make_frame,
                     DeviceLrSearch, trace_path, card)

    phase(f"RA preset 6 {CMP_W}x{CMP_H}, {CMP_LEVELS} levels, {CMP_FRAMES} "
          "frames: cuda vs cpu, own decoder")
    preset6_cmp_phase(np, torch, Encoder, EncoderConfig, make_frame,
                      DeviceLrSearch)

    phase(f"full-RD route at {SC_W}x{SC_H}: cuda vs cpu")
    full_rd_phase(np, torch, Encoder, EncoderConfig, PredStructure,
                  make_frame)

    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "hme_sad_scan", "route": "cuda",
        "source": "svt_av1_psy_tpu_torch/csrc/hme_sad_scan.cu",
        "replaces": "svt_av1_psy_tpu/ops/jax_backend.py:689",
        "launches": k1_launches, "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
