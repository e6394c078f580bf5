"""Check of the stream and the reconstruction (every entry point): what
the host walks, the in-loop filters and the entropy coder produced, judged
by a conformant decoder once the window has closed.

Every temporal unit that the encoder hands out, from the key frame on, is
kept (decoding needs the whole chain). For a sample (`every`) of the
frames shown inside the window the encoder's reconstruction is kept too.
After the window the reference decoder (reference/aom.py, libaom) decodes
the stream up to the last frame the window showed:

- stream_recon_mismatch: the decoded pixels of the sampled frames that
  differ from the encoder's reconstruction (a frame the decoder did not
  give counts all its pixels). The encoder states that its reconstruction
  is what every decoder shows, so the limit is 0.

It also hands the luma PSNR of the decoded window frames against their
source, averaged over the frames, to the end-to-end metric psnr_y_db.
The control puts the decoder's own frames at 7 bits in the place of the
reconstruction.
"""

from __future__ import annotations

import math
import sys

import numpy as np


def install(ctx, cfg: dict) -> None:
    import svt_av1_psy_tpu_torch.api as api
    every = int(cfg.get("every", 4))
    st = ctx.state["stream"] = {"packets": [], "window": [], "recon": {},
                                "encoded": 0}
    depth = [0]

    def record(payload, display, recon):
        st["packets"].append(bytes(payload))
        if display < 0 or not ctx.in_window or ctx.window_over():
            return
        st["window"].append(display)
        if ctx.take("stream", every):
            # resolved after the window: a deferred in-loop filter of
            # this frame is joined then, not inside the timed loop
            st["recon"][display] = recon

    def batch(pkts):
        for p in pkts:
            record(p.payload, p.display_idx, p.recon)
        return pkts

    send_picture, flush, encode = (api.Encoder.send_picture,
                                   api.Encoder.flush, api.Encoder.encode)

    def send_wrapped(self, *a, **k):
        depth[0] += 1
        try:
            pkts = send_picture(self, *a, **k)
        finally:
            depth[0] -= 1
        return batch(pkts)

    def flush_wrapped(self, *a, **k):
        return batch(flush(self, *a, **k))

    def encode_wrapped(self, *a, **k):
        f = encode(self, *a, **k)
        if not depth[0]:          # the command calls encode() itself
            record(f.payload, st["encoded"], f)
            st["encoded"] += 1
        return f

    ctx.patch(api.Encoder, "send_picture", send_wrapped)
    ctx.patch(api.Encoder, "flush", flush_wrapped)
    ctx.patch(api.Encoder, "encode", encode_wrapped)


def _planes(recon) -> tuple:
    if hasattr(recon, "recon_y"):
        return (recon.recon_y, recon.recon_u, recon.recon_v)
    return tuple(recon[i] for i in range(3))


def _psnr(a: np.ndarray, b: np.ndarray, bd: int) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    peak = float((1 << bd) - 1)
    return 10.0 * math.log10(peak * peak / max(mse, 1e-10))


def _decode(ctx, st: dict) -> dict:
    """Decode once per run: the sampled frames' decoded planes, the window
    frames' PSNR, and what went wrong (None when nothing did)."""
    import harness
    aom = harness.load_module("reference", "aom")
    if aom.find_library() is None:
        return {"frames": {}, "psnr": [], "error": "libaom did not load"}
    want = set(st["recon"])
    window = set(st["window"])
    last = max(want | window) if (want or window) else -1
    frames, psnr, error = {}, [], None
    bd = int(ctx.config["bit_depth"])
    try:
        for d, planes in enumerate(aom.decode(st["packets"])):
            if d in want:
                frames[d] = planes
            if d in window:
                psnr.append(_psnr(planes[0], ctx.source.frame(d)[0], bd))
            if d >= last:
                break
    except RuntimeError as e:
        error = str(e)
    return {"frames": frames, "psnr": psnr, "error": error}


def readings(ctx, cfg: dict, control: bool = False) -> dict:
    st = ctx.state.get("stream")
    if not st or not st["recon"]:
        return {"stream_recon_mismatch": None}
    if "decoded" not in st:
        st["decoded"] = _decode(ctx, st)
        dec = st["decoded"]
        if dec["error"]:
            print(f"benchmark: stream check: {dec['error']}",
                  file=sys.stderr)
        if dec["psnr"] and not dec["error"]:
            ctx.values["psnr_y_db"] = sum(dec["psnr"]) / len(dec["psnr"])
    dec = st["decoded"]
    if dec["error"] == "libaom did not load":
        return {"stream_recon_mismatch": None}
    mism = 0
    for d, recon in st["recon"].items():
        got = dec["frames"].get(d)
        want = _planes(recon)
        if got is None:
            mism += sum(int(np.asarray(p).size) for p in want)
            continue
        if control:
            want = tuple(g & ~np.asarray(1, g.dtype) for g in got)
        for w, g in zip(want, got):
            w = np.asarray(w)
            if w.shape != g.shape:
                mism += int(w.size)
            else:
                mism += int((w.astype(np.int64) != g).sum())
    return {"stream_recon_mismatch": mism}
