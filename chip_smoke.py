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
    a screen-content key at preset 10 and a preset-3 encode;
  - the command-line encoder (python -m svt_av1_psy_tpu_torch, run here in
    this process through app.cli.main): low delay at preset 10 on the K1
    route, where the key frame's temporal filter and the TPL lookahead
    search through hme_mv_sad, and the default random access at preset 8;
  - the C API (native/capi.h) through the port's shim, libsvtav1_torch.so:
    low delay at preset 10 on the K1 route from this process (ctypes) and
    from a C program of its own;
  - multi-device on the one card, as lists of devices with a stream each:
    the sharded decide, random access with its mini-GoPs on device groups
    (the width-sharded GoP program for a group of two), and the twin of
    __graft_entry__.py's entry and dryrun_multichip.
Before that it builds every CUDA kernel from the sources in this checkout
and holds each against its plain PyTorch version at the shapes the path
gives it. K1 is the only hand-written kernel; the other device programs
are plain PyTorch.

Phases (each ends in torch.cuda.synchronize(); any failure exits non-zero
and prints no result):
  1. the card's name and power limit (nvidia-smi);
  2. build K1 (csrc/hme_sad_scan.cu) with nvcc, timed;
  3. K1 against the plain hme_search on uint8 and 10-bit (int16) planes,
     at 1088x1920 with search range 12 and at 144x176 with ranges 0, 4,
     12 and 15 (random, shifted + noise, flat where every offset ties):
     byte-equal; int32 planes give the same; one call on uint8 or int16
     planes is one CUDA kernel and no PyTorch op but two aten::empty
     (torch.profiler); both times on an 8-bit 1088x1920 pair (CUDA
     events over back-to-back calls, in turns plain, K1, K1, plain), K1
     on a 10-bit pair, the kernel's device time alone (torch.profiler)
     at both depths and with the pairs rotated through more than the 50
     MB of L2, and its bound (the card's least time for the same work:
     its operations at the int8 peak, its bytes, in the pixels' own
     width, at the memory rate);
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
     (the port's decoder/) equals its recon;
 14. a screen-content key (preset 10, --scm 2 flags it) and a preset-3
     encode at 176x144: cuda payload bytes equal cpu's;
 15. the CLI on an 8-frame 1080p y4m, --keyint 0 --preset 10 --crf 30 on
     the K1 route: K1's launches counted (one per P frame, two for the
     key frame's TF, one per TPL lookahead frame), fps and the SVT_TRACE
     stages; its first 3 frames (-n 3) on cuda and cpu: equal IVF bytes;
 16. the CLI's default random access (preset 8, TF and TPL; --crf 30) on
     a 33-frame 1080p y4m, timed; at 352x288, 17 frames, on cpu and cuda:
     equal IVF bytes with --enable-tf 0, and with TF on when the cuda run
     codes the cpu run's filtered planes (the filter is float32: the
     pixels that differ between the devices are counted); the own decoder
     decodes the stream;
 17. after the last timed phase, the CLI LD stream of phase 15 through
     dav1d where libdav1d.so.6 loads (all 8 frames), else through the
     repo's own decoder (the first 3), above the PSNR floor;
 18. (after 5) the C API in-process: the port's shim built and loaded
     through ctypes, 8 frames of phase 4's frames at the shim's config
     (8-bit, LD, preset 10, CRF 30, device=cuda) through svt_tpu_enc_*:
     payload bytes equal to an API run of that config, K1 once per P
     frame, fps;
 19. (after 18) the C API standalone: a C program linked against the
     shim encodes the first 3 frames on cuda in a process of its own
     (Python, torch and CUDA start inside the library): its packets equal
     18's first 3;
 20. (after 9) make_sharded_decide(["cuda"] * n) on a 1088x1920 plane, n
     = 2 and 4: maps equal to the unsharded decide's, the shards'
     dispatch under sync debug mode "error", both timed (CUDA events);
 21. 1080p RA preset 10 CRF 30, 3 levels, TF off, 17 frames, without
     device groups, on two groups of ["cuda"] and on one group of
     ["cuda", "cuda"]: equal payload bytes, every GoP on a group, fps;
 22. graft_entry.entry's step, and dryrun_multichip(n) on ["cuda"] * n
     for n = 2, 4: both streams decode to their recon.
At the end no module of jax or of the JAX package (svt_av1_psy_tpu) may
have been loaded; the run's total time is printed.

Run from the root of a checkout:  python3 chip_smoke.py
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import itertools
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
GOP_LEVELS, GOP_FRAMES = 3, 17   # GoP groups: a key + two 8-frame mini-GoPs
OWN_DECODE_FRAMES = 3            # phase 17 on the own decoder (~35 s/frame)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(torch, fn, reps: int, calls: int = 1) -> float:
    """Median device time of one fn() in ms, by CUDA events around `calls`
    back-to-back calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def hme_pair(np, kind: str, dims=(PAD_H, PAD_W), bd: int = 8, seed: int = 3):
    """(src, ref) planes: uint8 at bit depth 8, uint16 above."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bd == 8 else np.uint16
    src = rng.integers(0, 1 << bd, dims).astype(dt)
    if kind == "flat":
        flat = np.full_like(src, 77 << (bd - 8))
        return flat, flat.copy()
    if kind == "random":
        return src, rng.integers(0, 1 << bd, dims).astype(dt)
    ref = np.roll(src, (6, -10), (0, 1))
    noise = rng.integers(-6, 7, ref.shape) << (bd - 8)
    ref = np.clip(ref.astype(np.int32) + noise, 0, (1 << bd) - 1).astype(dt)
    return src, ref


INT8_OPS_PER_S = 1.979e15       # H100 SXM, int8 dense peak (data sheet)
HBM_BYTES_PER_S = 3.35e12


def k1_bound(h: int, w: int, bit_depth: int, search_range: int):
    """The least time the card could take for hme_search_kernel's work on
    one (h, w) pair: the larger of its operations over the card's fastest
    rate for 8-bit integers and its bytes over the memory rate. Returns
    (ms, "operations" or "bytes", operations, bytes, ms by operations, ms
    by bytes). Operations: per 16x16 block and offset, 64 absolute
    differences added into a sum (2 each, as a multiply-add counts 2) and
    one compare, plus the rounded 2x2 decimation of both planes (5 per
    half-res pixel), at 1,979 TOP/s. Bytes: both pixel planes read once
    in the width of their pixels (1 byte at bit depth 8, 2 above,
    whatever type a caller hands over), mv (int16 x 2) and sad (int32)
    written once, at 3.35 TB/s."""
    blocks = (h // 16) * (w // 16)
    side = 2 * search_range + 1
    ops = blocks * side * side * (64 * 2 + 1) + 2 * (h // 2) * (w // 2) * 5
    nbytes = 2 * h * w * (1 if bit_depth == 8 else 2) + blocks * (2 * 2 + 4)
    t_ops = 1e3 * ops / INT8_OPS_PER_S
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes", ops, nbytes, \
        t_ops, t_bytes


def k1_checks(np, torch, tb, hme_search_kernel, dev) -> int:
    """K1 against the plain hme_search: both sizes, both depths, every
    search range, three kinds of pair, and int32 planes. Returns the
    largest absolute difference (0 when the kernel is right)."""
    worst = 0
    cases = [((PAD_H, PAD_W), 12)] + [((144, 176), r) for r in (0, 4, 12, 15)]
    for dims, r in cases:
        for bd in (8, 10):
            errs = []
            for pair in ("random", "shifted", "flat"):
                s, f = (tb.pixel_tensor(x, dev)
                        for x in hme_pair(np, pair, dims, bd))
                mv_k, sad_k = hme_search_kernel(s, f, r)
                mv_p, sad_p = tb.hme_search(s, f, r)
                torch.cuda.synchronize()
                if mv_k.dtype != mv_p.dtype or sad_k.dtype != sad_p.dtype \
                        or mv_k.shape != mv_p.shape:
                    fail(f"K1 gives {mv_k.dtype} {tuple(mv_k.shape)}, "
                         f"{sad_k.dtype}; plain {mv_p.dtype} "
                         f"{tuple(mv_p.shape)}, {sad_p.dtype}")
                errs.append(max(int((mv_k.int() - mv_p.int()).abs().max()),
                                int((sad_k - sad_p).abs().max())))
            print(f"{dims[0]}x{dims[1]} {bd}-bit R {r:2d}: max_abs_err "
                  f"random/shifted/flat {errs}")
            worst = max(worst, *errs)
    s, f = (tb.pixel_tensor(x, dev) for x in hme_pair(np, "shifted", bd=10))
    want = hme_search_kernel(s, f)
    for a, b in ((s.int(), f.int()), (s.int(), f)):
        got = hme_search_kernel(a, b)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail("K1 on int32 planes differs from K1 on int16 planes")
    print("int32 planes (narrowed to int16 by the wrapper): equal")
    return worst


def k1_profile(torch, fn, calls: int):
    """`calls` calls of fn() under torch.profiler: (device kernels and
    copies by name, PyTorch ops by name, device ms per call)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    device = {r.key: r.count for r in rows if r.device_type == cuda}
    ops = {r.key: r.count for r in rows
           if r.device_type != cuda and r.key.startswith("aten::")}
    ms = sum(r.self_device_time_total for r in rows
             if r.device_type == cuda) / 1e3 / calls
    return device, ops, ms


def k1_one_launch(torch, hme_search_kernel, s, f, what: str) -> None:
    """One call of the wrapper must be one device kernel, K1's, and no
    PyTorch op but the two aten::empty."""
    device, ops, _ = k1_profile(torch, lambda: hme_search_kernel(s, f), 1)
    print(f"one call on {what} planes: device kernels {device}; PyTorch "
          f"ops {ops}")
    if sum(device.values()) != 1 or \
            not all("hme_sad_scan" in k for k in device):
        fail(f"one K1 call on {what} planes launched {device}")
    if set(ops) - {"aten::empty"} or sum(ops.values()) != 2:
        fail(f"one K1 call on {what} planes ran the PyTorch ops {ops}")


def write_y4m(path, frames) -> None:
    from svt_av1_psy_tpu_torch.io.y4m import Y4mWriter
    h, w = frames[0][0].shape
    with Y4mWriter(str(path), w, h, 30, 1, 8) as wr:
        for f in frames:
            wr.write_frame(*f)


def run_cli(torch, argv: list) -> float:
    """The port's CLI in this process (so that K1's launch count and the
    SVT_TRACE stages are this process's); its wall time in s."""
    from svt_av1_psy_tpu_torch.app.cli import main as cli_main
    t0 = time.perf_counter()
    rc = cli_main(argv + ["--progress", "0"])
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"the CLI exited {rc}: {' '.join(argv)}")
    return time.perf_counter() - t0


def decode_check(np, data: bytes, frames, what: str) -> list:
    """The repo's own decoder (the port's copy) on an IVF stream: one
    shown frame per source frame, each above the PSNR floor."""
    from svt_av1_psy_tpu_torch.decoder.driver import decode_ivf
    dec = decode_ivf(data)
    if len(dec) != len(frames):
        fail(f"{what}: the decoder gave {len(dec)} frames for "
             f"{len(frames)}")
    return [psnr_check(np, f[0], d.y, f"{what} frame {i}")
            for i, (f, d) in enumerate(zip(frames, dec))]


def cli_ld_phase(np, json, torch, frames, tmp, trace_path, card,
                 problems: list):
    """This slice's main path: the port's CLI on a 1080p y4m, low delay
    (--keyint 0 --preset 10 --crf 30) on the K1 route, where the key
    frame's temporal filter and tpl_sb_offsets run their searches through
    hme_mv_sad. Returns K1's launches in that run and the stream, which
    the repo's own decoder reads after the last timed phase."""
    from svt_av1_psy_tpu_torch.kernels.hme import hme_search_kernel
    n = len(frames)
    clip = tmp / "ld.y4m"
    write_y4m(clip, frames)
    ld = ["--keyint", "0", "--preset", "10", "--crf", "30"]
    # one launch per P frame, one per lookahead frame of the key frame's
    # TF window (2), one per lookahead frame of tpl_sb_offsets (up to 3)
    tpl = [min(3, n - 1 - i) for i in range(n)]
    want = (n - 1) + 2 + sum(tpl)
    # the CLI's host TF and TPL run outside the SVT_TRACE stages: time
    # each call (the CLI looks both up at each call)
    import svt_av1_psy_tpu_torch.models.temporal_filter as tf_mod
    import svt_av1_psy_tpu_torch.models.tpl as tpl_mod
    host = {}

    def timed(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                host.setdefault(f"{name} (CLI)", []).append(
                    1e3 * (time.perf_counter() - t0))
        setattr(mod, name, wrapper)
        return fn

    originals = [(tf_mod, "temporal_filter",
                  timed(tf_mod, "temporal_filter")),
                 (tpl_mod, "tpl_sb_offsets",
                  timed(tpl_mod, "tpl_sb_offsets"))]
    os.environ["SVT_HME_PALLAS"] = "1"
    try:
        first = trace_lines(trace_path)
        out = tmp / "ld_cuda.ivf"
        hme_search_kernel.launches = 0
        secs = run_cli(torch, ["-i", str(clip), "-b", str(out),
                               "--device", "cuda"] + ld)
        launches = hme_search_kernel.launches
        stages = trace_stages(json, trace_path, first)
        stages.update({k: list(v) for k, v in host.items()})
        short = {}
        for dev in ("cuda", "cpu"):
            path = tmp / f"ld{N_CPU_FRAMES}_{dev}.ivf"
            run_cli(torch, ["-i", str(clip), "-b", str(path), "-n",
                            str(N_CPU_FRAMES), "--device", dev] + ld)
            short[dev] = path.read_bytes()
    finally:
        del os.environ["SVT_HME_PALLAS"]
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    data = out.read_bytes()
    print(f"{n} frames in {secs:.3f} s: {n / secs:.3f} fps, {len(data)} "
          f"bytes; K1 launches {launches} (want {want}: {n - 1} P frames, "
          f"2 TF, TPL {tpl}) [{card}]")
    print_stages(stages)
    if launches != want:
        problems.append(f"CLI LD: K1 launched {launches} times, want {want}")
    same = short["cuda"] == short["cpu"]
    print(f"first {N_CPU_FRAMES} frames (-n {N_CPU_FRAMES}) cuda vs cpu: "
          f"IVF bytes {'equal' if same else 'differ'}")
    if not same:
        problems.append("CLI LD: cuda bytes differ from cpu's")
    return launches, data


def cli_ra_phase(np, json, torch, make_frame, tmp, trace_path, card,
                 problems: list) -> None:
    """The CLI's default random access (preset 8, TF and TPL on; --crf
    30) at 1080p, timed; then at 352x288 on cpu and on cuda, with TF off
    and on, where the cuda run is given the cpu run's temporally filtered
    planes (TfReplay): the IVF bytes must be equal; the own decoder must
    decode the TF-on stream."""
    from svt_av1_psy_tpu_torch.bitstream.ivf import read_ivf
    from svt_av1_psy_tpu_torch.kernels.hme import hme_search_kernel
    rng = np.random.default_rng(7)
    clip = tmp / "ra.y4m"
    write_y4m(clip, [make_frame(W, H, t, 8, 0.02, rng)
                     for t in range(RA_FRAMES)])
    out = tmp / "ra_cuda.ivf"
    first = trace_lines(trace_path)
    hme_search_kernel.launches = 0
    secs = run_cli(torch, ["-i", str(clip), "-b", str(out), "--crf", "30",
                           "--device", "cuda"])
    _, tus = read_ivf(str(out))
    print(f"{RA_FRAMES} frames in {secs:.3f} s: {RA_FRAMES / secs:.3f} fps; "
          f"{len(tus)} TUs, {sum(len(p) for _, p in tus)} bytes; K1 "
          f"launches {hme_search_kernel.launches} [{card}]")
    print_stages(trace_stages(json, trace_path, first))
    if len(tus) < RA_FRAMES:
        problems.append(f"CLI RA: {len(tus)} TUs for {RA_FRAMES} frames")
    small = [make_frame(CMP_W, CMP_H, t, 8, 0.02, rng)
             for t in range(CMP_FRAMES)]
    clip = tmp / "ra_small.y4m"
    write_y4m(clip, small)
    data = {}
    replay = TfReplay(np, torch)
    try:
        for tf in ("0", "1"):
            for dev in ("cpu", "cuda"):
                path = tmp / f"ra_small_tf{tf}_{dev}.ivf"
                s = run_cli(torch, ["-i", str(clip), "-b", str(path),
                                    "--crf", "30", "--enable-tf", tf,
                                    "--device", dev])
                data[tf, dev] = path.read_bytes()
                print(f"{CMP_W}x{CMP_H}, {CMP_FRAMES} frames, --enable-tf "
                      f"{tf} on {dev}: {s:.3f} s, {len(data[tf, dev])} "
                      "bytes")
    finally:
        replay.close()
    n, n_px, n_diff, max_diff = replay.diffs(np)
    print(f"--enable-tf 1: {n} temporal filters; {n_diff} of {n_px} "
          f"filtered pixels differ between cuda and cpu (largest difference "
          f"{max_diff}); the cuda run coded the cpu run's filtered planes")
    if not n:
        problems.append("CLI RA 352x288 --enable-tf 1 ran no temporal "
                        "filter")
    for tf in ("0", "1"):
        same = data[tf, "cuda"] == data[tf, "cpu"]
        print(f"--enable-tf {tf}: IVF bytes {'equal' if same else 'differ'}")
        if not same:
            problems.append(f"CLI RA 352x288 --enable-tf {tf}: cuda bytes "
                            "differ from cpu's")
    psnrs = decode_check(np, data["1", "cuda"], small, "CLI RA 352x288")
    print(f"own decoder: {len(psnrs)} frames, luma PSNR "
          f"{min(psnrs):.2f}..{max(psnrs):.2f} dB")


class TfReplay:
    """A spy on the port's tf_filter_device, which the GoP program and the
    key frame's filter call. It records the planes of every temporal
    filter of a cpu run. In a cuda run it runs the filter on the card,
    records those planes, and hands the encoder the cpu run's planes of
    the same call instead: the filter is float32 (another exp and sum
    order on the card, so a few pixels round apart), and with equal
    planes everything after it must give equal bytes."""

    def __init__(self, np, torch):
        import svt_av1_psy_tpu_torch.models.ra as ra_mod
        import svt_av1_psy_tpu_torch.ops.torch_backend as tb_mod
        self.mods = (tb_mod, ra_mod)
        self.orig = tb_mod.tf_filter_device
        self.cpu, self.cuda = [], []
        log = self

        def spy(*args, **kwargs):
            out = log.orig(*args, **kwargs)
            planes = [np.asarray(o.cpu()) for o in out]
            if out[0].device.type == "cpu":
                log.cpu.append(planes)
                return out
            log.cuda.append(planes)
            if len(log.cuda) > len(log.cpu):
                fail("the cuda run filtered more frames than the cpu run")
            return tuple(torch.from_numpy(p).to(o.device)
                         for p, o in zip(log.cpu[len(log.cuda) - 1], out))

        for mod in self.mods:
            mod.tf_filter_device = spy

    def close(self) -> None:
        for mod in self.mods:
            mod.tf_filter_device = self.orig

    def diffs(self, np):
        """(filters compared, filtered pixels, pixels that differ, largest
        difference) between the cuda and the cpu run."""
        n_px = n_diff = max_diff = 0
        if len(self.cuda) != len(self.cpu):
            fail(f"cuda ran {len(self.cuda)} temporal filters, cpu "
                 f"{len(self.cpu)}")
        for pa, pb in zip(self.cuda, self.cpu):
            for x, y in zip(pa, pb):
                d = np.abs(x.astype(np.int64) - y)
                n_px += d.size
                n_diff += int((d > 0).sum())
                max_diff = max(max_diff, int(d.max()))
        return len(self.cuda), n_px, n_diff, max_diff


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

    from svt_av1_psy_tpu_torch.models.lr_search import (DeviceLrSearch,
                                                        _upload)
    from svt_av1_psy_tpu_torch.ops.quant import ac_q
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
    from svt_av1_psy_tpu_torch.ops.restoration import apply_lr_frame
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
    from svt_av1_psy_tpu_torch.decoder.driver import Decoder
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


# --- the C API, sharded decide, GoP groups, the multi-device twin ----------

# the shim's config for the C API phases: the LD cell of phase 4 as a C
# caller states it (native/capi.h SvtTpuConfig)
CAPI_CFG = dict(width=W, height=H, bit_depth=8, enc_mode=10, crf=30.0,
                intra_period=-1, frame_rate=60, tile_columns=-1,
                hierarchical_levels=0, pred_structure=1)
CAPI_STANDALONE_FRAMES = 3

_CAPI_DEMO = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "capi.h"
/* demo frames.yuv packets.bin n: encodes n 1080p 8-bit 4:2:0 frames on
   cuda, LD preset 10 CRF 30, and writes each packet as an int64 size and
   its bytes */
static int drain(SvtTpuEncoder *h, FILE *out) {
    const uint8_t *data; size_t size; int64_t pts;
    while (svt_tpu_enc_get_packet(h, &data, &size, &pts) == SVT_TPU_OK) {
        int64_t n = (int64_t)size;
        if (fwrite(&n, 8, 1, out) != 1 || fwrite(data, 1, size, out) != size)
            return 1;
    }
    return 0;
}
int main(int argc, char **argv) {
    if (argc != 4) return 9;
    SvtTpuEncoder *h; SvtTpuConfig cfg;
    if (svt_tpu_enc_init_handle(&h, &cfg)) return 1;
    cfg.width = 1920; cfg.height = 1080; cfg.bit_depth = 8;
    cfg.enc_mode = 10; cfg.crf = 30; cfg.intra_period = -1;
    cfg.frame_rate = 60; cfg.tile_columns = -1;
    cfg.hierarchical_levels = 0; cfg.pred_structure = 1;
    if (svt_tpu_enc_set_parameter(h, &cfg)) return 2;
    if (svt_tpu_enc_parse_parameter(h, "device=cuda")) return 3;
    if (svt_tpu_enc_init(h)) return 4;
    size_t ny = 1920 * 1080, nc = 960 * 540;
    unsigned char *y = malloc(ny), *u = malloc(nc), *v = malloc(nc);
    FILE *in = fopen(argv[1], "rb"), *out = fopen(argv[2], "wb");
    if (!in || !out) return 5;
    for (int i = 0; i < atoi(argv[3]); i++) {
        if (fread(y, 1, ny, in) != ny || fread(u, 1, nc, in) != nc ||
            fread(v, 1, nc, in) != nc) return 6;
        if (svt_tpu_enc_send_picture(h, y, 1920, u, v, 960)) return 7;
        if (drain(h, out)) return 8;
    }
    if (svt_tpu_enc_send_picture(h, NULL, 0, NULL, NULL, 0)) return 7;
    if (drain(h, out)) return 8;
    svt_tpu_enc_deinit(h);
    fclose(out);
    printf("ok\n");
    return 0;
}
"""


def capi_session(ctypes, lib, params):
    """An initialized handle of the shim at CAPI_CFG with the staged
    parameter strings; returns (handle, send(y, u, v) or send(None) to
    flush -> [payload, ...])."""
    class Cfg(ctypes.Structure):
        _fields_ = [(k, ctypes.c_double if k == "crf" else ctypes.c_int32)
                    for k in ("width", "height", "bit_depth", "enc_mode",
                              "crf", "intra_period", "frame_rate",
                              "tile_columns", "hierarchical_levels",
                              "pred_structure")]
    vp = ctypes.c_void_p
    lib.svt_tpu_enc_init_handle.argtypes = [ctypes.POINTER(vp),
                                            ctypes.POINTER(Cfg)]
    lib.svt_tpu_enc_set_parameter.argtypes = [vp, ctypes.POINTER(Cfg)]
    lib.svt_tpu_enc_parse_parameter.argtypes = [vp, ctypes.c_char_p]
    lib.svt_tpu_enc_init.argtypes = [vp]
    lib.svt_tpu_enc_send_picture.argtypes = [vp, vp, ctypes.c_int32, vp, vp,
                                             ctypes.c_int32]
    lib.svt_tpu_enc_get_packet.argtypes = [
        vp, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int64)]
    lib.svt_tpu_enc_deinit.argtypes = [vp]
    h, cfg = vp(), Cfg()
    if lib.svt_tpu_enc_init_handle(ctypes.byref(h), ctypes.byref(cfg)):
        fail("svt_tpu_enc_init_handle failed")
    for k, v in CAPI_CFG.items():
        setattr(cfg, k, v)
    if lib.svt_tpu_enc_set_parameter(h, ctypes.byref(cfg)):
        fail("svt_tpu_enc_set_parameter refused the config")
    for p in params:
        if lib.svt_tpu_enc_parse_parameter(h, p.encode()):
            fail(f"svt_tpu_enc_parse_parameter refused {p}")
    if lib.svt_tpu_enc_init(h):
        fail("svt_tpu_enc_init failed")
    data = ctypes.POINTER(ctypes.c_uint8)()
    size, pts = ctypes.c_size_t(), ctypes.c_int64()

    def send(y, u=None, v=None):
        if y is None:
            rc = lib.svt_tpu_enc_send_picture(h, None, 0, None, None, 0)
        else:
            rc = lib.svt_tpu_enc_send_picture(h, y.ctypes.data, y.shape[1],
                                              u.ctypes.data, v.ctypes.data,
                                              u.shape[1])
        if rc:
            fail(f"svt_tpu_enc_send_picture returned {rc}")
        out = []
        while lib.svt_tpu_enc_get_packet(h, ctypes.byref(data),
                                         ctypes.byref(size),
                                         ctypes.byref(pts)) == 0:
            out.append(ctypes.string_at(data, size.value))
        return out
    return h, send


def capi_phase(np, torch, frames, hme_search_kernel, card):
    """The port's shim built from native/capi_backend.c and loaded through
    ctypes: 8 frames of the LD K1 cell through svt_tpu_enc_* on cuda. The
    payload bytes must equal an API run of the shim's config
    (capi_bridge.make_encoder: the shim's 8-bit config is not phase 4's,
    whose Encoder keeps the default encoder_bit_depth); K1 must launch
    once per P frame. Returns (K1 launches, payloads)."""
    import ctypes

    from svt_av1_psy_tpu_torch import capi_bridge, capi_build
    t0 = time.perf_counter()
    so = capi_build.build(force=True)
    print(f"built {so.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s "
          "(native/capi_backend.c, its module literals pointed at the "
          "port's bridge)")
    lib = ctypes.CDLL(str(so))
    args = [CAPI_CFG[k] for k in ("width", "height", "bit_depth", "enc_mode",
                                  "crf", "intra_period", "frame_rate",
                                  "tile_columns", "hierarchical_levels",
                                  "pred_structure")]
    api = capi_bridge.make_encoder(*args, extra_params=["device=cuda"])
    try:
        want = [p.payload for f in frames for p in api.send_picture(*f)]
        want += [p.payload for p in api.flush()]
    finally:
        api.close()
    torch.cuda.synchronize()
    planes = [[np.ascontiguousarray(p) for p in f] for f in frames]
    hme_search_kernel.launches = 0
    t0 = time.perf_counter()
    h, send = capi_session(ctypes, lib, ["device=cuda"])
    got = [p for f in planes for p in send(*f)] + send(None)
    lib.svt_tpu_enc_deinit(h)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = hme_search_kernel.launches
    n_p = len(frames) - 1
    print(f"C API (in-process, ctypes): {len(frames)} frames in {secs:.3f} s:"
          f" {len(frames) / secs:.3f} fps, {len(got)} packets, "
          f"{sum(map(len, got))} bytes; K1 launches {launches} [{card}]")
    if launches != n_p:
        fail(f"C API: K1 launched {launches} times for {n_p} P frames")
    if got != want:
        fail(f"C API: payloads ({[len(p) for p in got]} B) differ from the "
             f"API run of the same config ({[len(p) for p in want]} B)")
    print("payload bytes equal to the API run of the same config")
    return launches, got


def capi_standalone_phase(np, frames, tmp, payloads, card) -> None:
    """A C program linked against the port's shim, run as a process of
    its own: Python starts inside the library (sys.executable is the C
    program), imports torch, initializes CUDA and runs K1 on the first
    frames; its packets must equal the in-process run's."""
    from svt_av1_psy_tpu_torch import capi_build
    n = CAPI_STANDALONE_FRAMES
    demo = tmp / "capi_demo.c"
    demo.write_text(_CAPI_DEMO)
    exe = tmp / "capi_demo"
    subprocess.run(["cc", "-O1", str(demo), "-o", str(exe),
                    f"-I{ROOT / 'native'}", f"-L{capi_build.BUILD}",
                    "-lsvtav1_torch", f"-Wl,-rpath,{capi_build.BUILD}"],
                   check=True, timeout=120)
    raw = tmp / "capi_frames.yuv"
    with open(raw, "wb") as f:
        for fr in frames[:n]:
            for p in fr:
                f.write(np.ascontiguousarray(p).tobytes())
    out = tmp / "capi_packets.bin"
    # the embedded interpreter starts from the C program, not from this
    # interpreter's environment: hand it this sys.path; no SVT_TRACE (its
    # frames would join this process's trace)
    env = {k: v for k, v in os.environ.items() if k != "SVT_TRACE"}
    env.update(SVT_HME_PALLAS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in sys.path if p]))
    t0 = time.perf_counter()
    r = subprocess.run([str(exe), str(raw), str(out), str(n)], env=env,
                       capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"the C program exited {r.returncode}: {r.stdout[-2000:]}"
             f"{r.stderr[-4000:]}")
    buf, got = out.read_bytes(), []
    while buf:
        size = int.from_bytes(buf[:8], "little")
        got.append(buf[8:8 + size])
        buf = buf[8 + size:]
    print(f"C program: {n} frames in {secs:.3f} s (process start, torch "
          f"import, CUDA init and the encode), {len(got)} packets [{card}]")
    if got != payloads[:n]:
        fail(f"C program: packets {[len(p) for p in got]} B differ from the "
             f"in-process run's first {n} ({[len(p) for p in payloads[:n]]})")
    print(f"packets equal to the in-process run's first {n}")


def streams_ms(torch, fn, streams, reps: int) -> float:
    """Median ms by CUDA events of fn(), whose work runs on `streams` (and
    the current stream): they start after the start event, and the end
    event waits for all of them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        cur = torch.cuda.current_stream()
        start.record()
        for s in streams:
            s.wait_stream(cur)
        fn()
        for s in streams:
            cur.wait_stream(s)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sharded_decide_phase(np, torch, plane, card) -> None:
    """make_sharded_decide(["cuda"] * n) on a 1088x1920 plane, n = 2, 4:
    the maps equal the unsharded decide's; the shards' dispatch makes no
    host sync (sync debug mode "error"); both timed."""
    from svt_av1_psy_tpu_torch.models.fast_intra import FastIntraEncoder
    from svt_av1_psy_tpu_torch.ops import torch_backend as tb
    from svt_av1_psy_tpu_torch.ops.quant import ac_q
    from svt_av1_psy_tpu_torch.utils.device import DeviceGroup
    enc = FastIntraEncoder(W, H, qindex=120, device="cuda")
    bias = int(8 * ac_q(enc.qindex, enc.bd))
    want = enc._decide(plane)
    one_ms = streams_ms(torch, lambda: enc._decide_dispatch(plane), [], 5)
    print(f"unsharded decide (upload, program, host copy): {one_ms:.3f} ms "
          f"[{card}]")
    for n in (2, 4):
        group = DeviceGroup(["cuda"] * n)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            stitch = tb.intra_decide_sharded(plane, bias, enc.bd,
                                             enc.min_block, group)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for got in (enc._decide_finish(stitch),
                    enc.make_sharded_decide(["cuda"] * n)(plane)):
            for a, b in zip(got, want):
                for k in b:
                    if not np.array_equal(a[k], b[k]):
                        fail(f"sharded decide over {n}: the {k} map differs")
        ms = streams_ms(torch, lambda: tb.intra_decide_sharded(
            plane, bias, enc.bd, enc.min_block, group), group.streams, 5)
        shards = [(s.x1 - s.x0) // 64 for s in tb.column_shards(PAD_W, n)]
        print(f"{n} shards {shards} superblocks: maps equal to the unsharded"
              f" decide's; dispatch made no host sync; {ms:.3f} ms [{card}]")
    enc.close()


def gop_groups_phase(np, torch, Encoder, EncoderConfig, make_frame,
                     card) -> None:
    """1080p RA preset 10 CRF 30, 3 levels, TF off, 17 frames (a key and
    two 8-frame mini-GoPs): without groups, on two groups of ["cuda"] and
    on one group of ["cuda", "cuda"] (the width-sharded GoP program). The
    payload bytes must equal the ungrouped run's, every GoP on a group."""
    rng = np.random.default_rng(13)
    frames = [make_frame(W, H, t, 8, 0.02, rng) for t in range(GOP_FRAMES)]
    cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                        hierarchical_levels=GOP_LEVELS, enable_tf=0)
    runs = {}
    for name, groups in (("ungrouped", None),
                         ("two groups of [cuda]", [["cuda"], ["cuda"]]),
                         ("one group of [cuda, cuda]", [["cuda", "cuda"]])):
        enc = Encoder(cfg, W, H, device="cuda")
        if groups is not None:
            enc._ra.gop_meshes = groups
        t0 = time.perf_counter()
        pkts = encode_ra(enc, frames)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        seq = getattr(enc._ra, "_gop_seq", 0)
        runs[name] = [p.payload for p in pkts]
        print(f"{name}: {GOP_FRAMES} frames in {secs:.3f} s: "
              f"{GOP_FRAMES / secs:.3f} fps, {len(pkts)} TUs, "
              f"{sum(map(len, runs[name]))} bytes, GoPs on groups {seq} "
              f"[{card}]")
        if groups is not None:
            if seq < 2:
                fail(f"{name}: {seq} GoPs went to the groups")
            if runs[name] != runs["ungrouped"]:
                fail(f"{name}: payload bytes differ from the ungrouped run")
    print("payload bytes equal to the ungrouped run's")


def multidevice_twin_phase(torch, card) -> None:
    """graft_entry's entry() step, then dryrun_multichip(n) for n = 2, 4
    on ["cuda"] * n: both of its streams decode to their recon."""
    from svt_av1_psy_tpu_torch.graft_entry import dryrun_multichip, entry
    step, args = entry("cuda")
    maps = step(*args)
    torch.cuda.synchronize()
    print(f"entry(): intra_decide on {tuple(args[0].shape)} gives "
          f"{[tuple(m.shape) for m in maps]}")
    for n in (2, 4):
        t0 = time.perf_counter()
        res = dryrun_multichip(n)
        torch.cuda.synchronize()
        print(f"dryrun_multichip({n}) on ['cuda'] * {n}: intra "
              f"{len(res['intra'])} bytes, RA {len(res['ra'])} TUs over "
              f"{res['gop_seq']} grouped GoPs, decoded by {res['decoder']} "
              f"equal to the recon, {time.perf_counter() - t0:.2f} s [{card}]")


def main() -> None:
    run_t0 = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not (ROOT / "svt_av1_psy_tpu_torch").is_dir():
        fail("svt_av1_psy_tpu_torch/ is missing: run from a checkout")
    os.environ["SVT_HME_PALLAS"] = "1"
    # per-frame stage times (the port's utils/trace.py writes one JSON
    # line per frame as each frame closes)
    trace_dir = tempfile.TemporaryDirectory()
    trace_path = pathlib.Path(trace_dir.name) / "trace.jsonl"
    os.environ["SVT_TRACE"] = str(trace_path)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, \
        PredStructure
    from svt_av1_psy_tpu_torch.kernels import build
    from svt_av1_psy_tpu_torch.kernels.hme import hme_search_kernel
    from svt_av1_psy_tpu_torch.ops import torch_backend as tb
    from svt_av1_psy_tpu_torch.utils.device import HostCopy
    from svt_av1_psy_tpu_torch.utils.test_clip import make_frame

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

    phase("K1 vs plain hme_search: 1088x1920 and 144x176, 8 and 10 bit")
    k1_err = k1_checks(np, torch, tb, hme_search_kernel, dev)
    if k1_err != 0:
        fail(f"K1 disagrees with the plain hme_search: max_abs_err {k1_err}")
    s, r = (tb.pixel_tensor(x, dev) for x in hme_pair(np, "shifted"))
    s10, r10 = (tb.pixel_tensor(x, dev)
                for x in hme_pair(np, "shifted", bd=10))
    k1_one_launch(torch, hme_search_kernel, s, r, "uint8")
    k1_one_launch(torch, hme_search_kernel, s10, r10, "int16")
    # time on the shifted pair, in turns: plain, K1, K1, plain; K1 as 50
    # back-to-back calls per reading (one call is shorter than the host
    # takes to make it, so this is the function's time as a caller sees it)
    runs = {"plain": [], "k1": []}
    fns = {"plain": (tb.hme_search, 5, 1), "k1": (hme_search_kernel, 7, 50)}
    for name in ("plain", "k1", "k1", "plain"):
        fn, reps, calls = fns[name]
        runs[name].append(cuda_ms(torch, lambda: fn(s, r), reps, calls))
    k1_ms = statistics.median(runs["k1"])
    plain_ms = statistics.median(runs["plain"])
    k1_10_ms = cuda_ms(torch, lambda: hme_search_kernel(s10, r10), 7, 50)
    # the kernel's own device time (torch.profiler). The caller uploads
    # new planes every frame, so also with the pair rotated through 16
    # shifted copies (67 MB, more than the 50 MB of L2)
    kernel_ms = k1_profile(torch, lambda: hme_search_kernel(s, r), 20)[2]
    kernel_10_ms = k1_profile(torch,
                              lambda: hme_search_kernel(s10, r10), 20)[2]
    rotated = [(torch.roll(s, i, 0), torch.roll(r, i, 0)) for i in range(16)]
    turn = itertools.count()
    cold_ms = k1_profile(
        torch, lambda: hme_search_kernel(*rotated[next(turn) % 16]), 32)[2]
    del rotated
    s32 = s.to(torch.int32)
    decide_ms = cuda_ms(torch, lambda: tb.intra_decide_packed(s32, 700), 5)
    bound_ms, bound_by, k1_ops, k1_bytes, ops_ms, bytes_ms = k1_bound(
        PAD_H, PAD_W, 8, 12)
    print(f"K1 hme_search_kernel {k1_ms:.4f} ms per 8-bit 1088x1920 pair "
          f"(turns {runs['k1']}), {k1_10_ms:.4f} ms per 10-bit pair; the "
          f"CUDA kernel alone (torch.profiler) {kernel_ms:.4f} ms 8-bit, "
          f"{cold_ms:.4f} ms with the pairs rotated through 67 MB, "
          f"{kernel_10_ms:.4f} ms 10-bit; plain hme_search {plain_ms:.4f} "
          f"ms; plain intra_decide_packed {decide_ms:.4f} ms [{card}]")
    print(f"K1 bound: {k1_ops:.4g} operations at 1,979 TOP/s -> "
          f"{ops_ms:.5f} ms; {k1_bytes:.4g} bytes (uint8 planes in) at "
          f"3.35 TB/s -> {bytes_ms:.5f} ms; bound {bound_ms:.5f} ms, set by "
          f"{bound_by}; share {bound_ms / k1_ms:.4f} of the function's "
          f"time, {bound_ms / kernel_ms:.4f} of the kernel's alone; the "
          f"10-bit bound {k1_bound(PAD_H, PAD_W, 10, 12)[0]:.5f} ms; no "
          f"single PyTorch call computes it [{card}]")
    del s, r, s10, r10, s32

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

    cli_dir = tempfile.TemporaryDirectory()
    tmp = pathlib.Path(cli_dir.name)
    problems = []
    phase(f"C API in-process: {N_FRAMES} frames 1080p LD preset 10 CRF 30 "
          "through the port's shim on cuda, K1 route")
    capi_launches, capi_payloads = capi_phase(np, torch, frames,
                                              hme_search_kernel, card)

    phase(f"C API standalone: a C program encodes the first "
          f"{CAPI_STANDALONE_FRAMES} frames on cuda")
    capi_standalone_phase(np, frames, tmp, capi_payloads, card)

    # the remaining paths run without a route switch: hme_search2
    del os.environ["SVT_HME_PALLAS"]

    phase(f"CLI: {N_FRAMES} frames 1080p LD preset 10 CRF 30 on cuda, "
          "K1 route, key-frame TF and TPL lookahead")
    cli_launches, cli_ld_stream = cli_ld_phase(
        np, json, torch, frames, tmp, trace_path, card, problems)
    ra_frames = [make_frame(W, H, t, 8, 0.02, rng) for t in range(RA_FRAMES)]

    phase("plain programs at 1088x1920 on cuda")
    from svt_av1_psy_tpu_torch.models.intra_encoder import _pad_to
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

    phase("sharded decide: make_sharded_decide(['cuda'] * n) on a "
          "1088x1920 plane, n = 2, 4")
    sharded_decide_phase(np, torch, ys[0], card)

    phase(f"GoP groups: {GOP_FRAMES} frames 1080p RA preset 10 CRF 30, "
          f"{GOP_LEVELS} levels, TF off, on device groups")
    gop_groups_phase(np, torch, Encoder, EncoderConfig, make_frame, card)

    phase("the multi-device twin: graft_entry.entry and dryrun_multichip "
          "(2, 4) on the one card")
    multidevice_twin_phase(torch, card)

    from svt_av1_psy_tpu_torch.models.lr_search import DeviceLrSearch

    phase("block_mode_costs at 1088x1920: cuda vs cpu")
    mode_costs_phase(np, torch, tb, ys[0], dev, card)

    phase("LR search program at 1080p: cuda vs cpu")
    lr_phase(np, torch, frames[1], (outs[1].recon_y, outs[1].recon_u,
                                    outs[1].recon_v), 120, dev, card)

    phase(f"north star: encode {NS_FRAMES} frames 1080p RA preset 6 CRF 30, "
          "5 levels, TF 1, TPL on, LR on, on cuda")
    hme_search_kernel.launches = 0
    north_star_phase(np, torch, json, Encoder, EncoderConfig, make_frame,
                     DeviceLrSearch, trace_path, card)
    ns_launches = hme_search_kernel.launches

    phase(f"RA preset 6 {CMP_W}x{CMP_H}, {CMP_LEVELS} levels, {CMP_FRAMES} "
          "frames: cuda vs cpu, own decoder")
    preset6_cmp_phase(np, torch, Encoder, EncoderConfig, make_frame,
                      DeviceLrSearch)

    phase(f"full-RD route at {SC_W}x{SC_H}: cuda vs cpu")
    full_rd_phase(np, torch, Encoder, EncoderConfig, PredStructure,
                  make_frame)

    phase(f"CLI: {RA_FRAMES} frames 1080p, the default random access "
          "(preset 8, TF, TPL), CRF 30, on cuda")
    cli_ra_phase(np, json, torch, make_frame, tmp, trace_path, card,
                 problems)

    # after the last timed phase: dav1d where libdav1d.so.6 loads, else
    # the repo's own decoder, which is Python (about half a minute per
    # 1080p frame on one core) and reads the first frames only
    from svt_av1_psy_tpu_torch.bitstream.ivf import read_ivf
    from svt_av1_psy_tpu_torch.graft_entry import conformance_decoder
    decoder, decode = conformance_decoder()
    tus = [p for _, p in read_ivf(cli_ld_stream)[1]]
    if decoder == "own":
        tus = tus[:OWN_DECODE_FRAMES]
    phase(f"CLI: the LD stream's first {len(tus)} frames through "
          f"{decoder}")
    t0 = time.perf_counter()
    dec = decode(tus)
    if len(dec) != len(tus):
        fail(f"CLI LD: the decoder gave {len(dec)} frames for {len(tus)}")
    psnrs = [psnr_check(np, f[0], d.y, f"CLI LD frame {i}")
             for i, (f, d) in enumerate(zip(frames, dec))]
    print(f"decoder: {decoder}; {len(psnrs)} frames decoded in "
          f"{time.perf_counter() - t0:.1f} s, luma PSNR "
          f"{min(psnrs):.2f}..{max(psnrs):.2f} dB >= {MIN_PSNR_DB}")
    cli_dir.cleanup()
    # a disagreement of the CLI phases fails the run after all of them
    # have printed their numbers
    if problems:
        fail("; ".join(problems))

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "svt_av1_psy_tpu"))
    if loaded:
        fail(f"modules of the JAX stack were loaded: {loaded}")
    print(f"K1 launches per path: LD K1 route {k1_launches}, C API "
          f"{capi_launches}, CLI LD {cli_launches}, north star {ns_launches}")
    print(f"smoke run: {time.perf_counter() - run_t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "hme_sad_scan", "route": "cuda",
        "source": "svt_av1_psy_tpu_torch/csrc/hme_sad_scan.cu",
        "replaces": "svt_av1_psy_tpu/ops/jax_backend.py:689",
        "launches": capi_launches, "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "ms_10bit": k1_10_ms, "profiler_kernel_ms": kernel_ms,
        "profiler_kernel_cold_l2_ms": cold_ms,
        "profiler_kernel_ms_10bit": kernel_10_ms,
        "launches_per_path": {"ld_k1_route": k1_launches,
                              "capi": capi_launches,
                              "cli_ld": cli_launches,
                              "north_star": ns_launches}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
