"""The port's twins of the driver entry points in __graft_entry__.py.

- ``entry(device)``: the production encoder's device stage, the dense
  intra decision over every block size of a 448 x 832 frame (mode search
  and split tree), as a step function and its arguments, for a
  compile-and-run check on a device.
- ``dryrun_multichip(n, devices)``: a real multi-device encode. A frame of
  n tile columns has its decision stage sharded over n devices
  (FastIntraEncoder.make_sharded_decide), and a random-access encode sends
  successive mini-GoPs round robin to device groups (RaDriver.gop_meshes:
  2 groups of n/2 when n >= 4, else 1 group of n), each width-sharded over
  its group. Both streams must decode to the encoder's recon bit-exactly.

Where the reference takes a jax mesh of n devices, these take a list of
torch devices, ``["cuda"] * n`` by default: on one card that is n entries
of one device, each with a CUDA stream of its own. The reference skips
its decode check when the dav1d wrapper does not import; the twin always
decodes, through decoder/dav1d.py where libdav1d.so.6 loads and through
the repo's own decoder where it does not, and reports which.

    python -m svt_av1_psy_tpu_torch.graft_entry [n] [device | d0,d1,...]

runs dryrun_multichip(n) on ``[device] * n`` (default 2 and cuda), or on
a comma-separated list of n devices (``cuda:0,cuda:1,cuda:2,cuda:3`` on a
4-GPU host), and prints a digest of both streams: runs on different
device lists must print the same one.
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np
import torch

from svt_av1_psy_tpu_torch.ops.torch_backend import intra_decide
from svt_av1_psy_tpu_torch.utils.device import resolve_device


def entry(device="cuda"):
    """(step, args): step(*args) runs intra_decide on a random 448 x 832
    uint8 plane (seed 0) with split bias 400 at bit depth 8 and minimum
    block 8 on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 255, (448, 832),
                                      dtype=np.uint8)).to(dev)

    def step(plane, bias):
        return intra_decide(plane, bias, 8, 8)

    return step, (y, 400)


def conformance_decoder():
    """(name, decode): decode(payloads) gives the shown frames (planes .y,
    .u, .v) of a list of temporal units, through dav1d where
    libdav1d.so.6 loads, else through the repo's own decoder."""
    from svt_av1_psy_tpu_torch.decoder import dav1d
    try:
        dav1d._load()
    except OSError:
        from svt_av1_psy_tpu_torch.decoder.driver import Decoder

        def own(payloads):
            dec = Decoder()
            for p in payloads:
                dec.decode_temporal_unit(p)
            return dec.frames
        return "own", own
    return "dav1d", lambda payloads: dav1d.decode_obus(b"".join(payloads))


def _same_planes(frame, recon) -> bool:
    return all(np.array_equal(a, b)
               for a, b in zip((frame.y, frame.u, frame.v), recon))


def _expect(ok: bool, what) -> None:
    """The dry run's checks (they hold under python -O too)."""
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The two halves of __graft_entry__.dryrun_multichip on a device list
    (default ``["cuda"] * n_devices``). Raises AssertionError when a
    stream does not decode to its recon. Returns the intra frame's
    payload ("intra"), the random-access packets in decode order ("ra"),
    the number of GoPs the groups ran ("gop_seq") and the decoder that
    checked them ("decoder")."""
    from svt_av1_psy_tpu_torch.models.fast_intra import FastIntraEncoder
    from svt_av1_psy_tpu_torch.models.ra import RaDriver

    devices = list(devices or ["cuda"] * n_devices)
    if len(devices) != n_devices:
        raise ValueError(f"{n_devices} devices wanted, got {devices}")
    dev0 = resolve_device(devices[0])
    name, decode = conformance_decoder()

    # a small frame, wide enough for one tile column per device
    W, H = 64 * n_devices, 128
    rng = np.random.default_rng(1)
    y = rng.integers(0, 255, (H, W), dtype=np.uint8)
    u = rng.integers(0, 255, (H // 2, W // 2), dtype=np.uint8)
    v = rng.integers(0, 255, (H // 2, W // 2), dtype=np.uint8)
    enc = FastIntraEncoder(W, H, qindex=100, n_tiles=n_devices, device=dev0)
    try:
        _expect(enc.n_tiles == n_devices, (enc.n_tiles, n_devices))
        enc.make_sharded_decide(devices)
        out = enc.encode_frame(y, u, v)
    finally:
        enc.close()
    _expect(len(out.payload) > 0, "empty payload")
    dec = decode([out.payload])
    _expect(len(dec) == 1 and _same_planes(
        dec[0], (out.recon_y, out.recon_u, out.recon_v)),
        "multi-device recon mismatch")

    # GoP-parallel random access over disjoint device groups
    n_groups = 2 if n_devices >= 4 else 1
    gsz = n_devices // n_groups
    groups = [devices[g * gsz:(g + 1) * gsz] for g in range(n_groups)]
    W2, H2 = 64 * gsz, 128
    rng2 = np.random.default_rng(7)
    frames = [(rng2.integers(0, 255, (H2, W2), dtype=np.uint8),
               rng2.integers(0, 255, (H2 // 2, W2 // 2), dtype=np.uint8),
               rng2.integers(0, 255, (H2 // 2, W2 // 2), dtype=np.uint8))
              for _ in range(9)]
    enc2 = FastIntraEncoder(W2, H2, qindex=100, n_tiles=1, device=dev0)
    drv = RaDriver(enc2, gop_levels=2, keyint=0)
    drv.gop_meshes = groups
    packets = []
    try:
        for f in frames:
            packets.extend(drv.push(*f))
        packets.extend(drv.flush())
    finally:
        drv.close()
    gop_seq = getattr(drv, "_gop_seq", 0)
    _expect(gop_seq >= 2, "expected >= 2 GoPs on the device groups")
    shown = [p for p in packets if p.display_idx >= 0]
    _expect(len(shown) == len(frames), (len(shown), len(frames)))
    dec = decode([p.payload for p in packets])
    _expect(len(dec) == len(frames), (len(dec), len(frames)))
    by_disp = {p.display_idx: p.recon for p in shown}
    for i, df in enumerate(dec):
        _expect(_same_planes(df, by_disp[i]), f"GoP-parallel mismatch {i}")
    return {"intra": out.payload, "ra": [p.payload for p in packets],
            "gop_seq": gop_seq, "decoder": name}


def main(argv) -> None:
    n = int(argv[0]) if argv else 2
    devs = argv[1].split(",") if len(argv) > 1 else ["cuda"]
    devs = devs * n if len(devs) == 1 else devs
    t0 = time.perf_counter()
    res = dryrun_multichip(n, devs)
    digest = hashlib.sha256(b"".join([res["intra"]] + res["ra"])).hexdigest()
    print(f"dryrun_multichip({n}) on {devs}: intra {len(res['intra'])} "
          f"bytes, RA {len(res['ra'])} TUs over {res['gop_seq']} GoPs, "
          f"decoded by {res['decoder']}: equal to the recon; streams "
          f"sha256 {digest[:16]}; {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
