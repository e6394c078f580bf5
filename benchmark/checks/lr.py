"""Check of the loop-restoration search (presets <= 7): a sample (`every`)
of the window's per-frame search programs (svt_av1_psy_tpu_torch.models.
lr_search DeviceLrSearch), recomputed by the plain reference on the same
six planes (recon y, u, v; source y, u, v) once the window has closed, in
float64 where the program computes in float32.

lr_tap_max_abs: the largest |difference| of a Wiener tap (the taps are
rounded float32 solves). lr_sse_max_rel: the largest relative difference
of a unit's SSE (without and with the filter), over the planes whose taps
agree. The control runs the reference in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch


def install(ctx, cfg: dict) -> None:
    import svt_av1_psy_tpu_torch.models.lr_search as lr
    every = int(cfg.get("every", 8))
    build = lr.DeviceLrSearch._build

    def wrapped_build(self):
        program = build(self)

        def capture(*planes6):
            out = program(*planes6)
            if ctx.take("lr", every):
                ctx.keep("lr", {"planes": planes6, "out": out,
                                "dims": list(self.dims), "bd": self.bd,
                                "unit_size": tuple(self.unit_size)})
            return out

        return capture

    ctx.patch(lr.DeviceLrSearch, "_build", wrapped_build)


def _split(buf: np.ndarray, s: dict, P) -> list:
    """Per plane (taps (6), sse (2n)) of one packed result."""
    out, off = [], 0
    for plane in range(3):
        pw, ph = s["dims"][plane]
        urows, ucols, _, _ = P.lr_unit_grid(pw, ph, s["unit_size"][plane],
                                            8 >> (1 if plane else 0))
        n = urows * ucols
        out.append((buf[off:off + 6], buf[off + 6:off + 6 + 2 * n]))
        off += 6 + 2 * n
    return out


def readings(ctx, cfg: dict, control: bool = False) -> dict:
    import harness
    P = harness.reference()
    samples = ctx.samples.get("lr", [])
    if not samples:
        return {"lr_tap_max_abs": None, "lr_sse_max_rel": None}
    tap, rel = 0.0, 0.0
    with torch.no_grad():
        for s in samples:
            ref = P.lr_search(s["planes"], s["dims"], s["bd"],
                              s["unit_size"], torch.float64).cpu().numpy()
            if control:
                got = P.lr_search(s["planes"], s["dims"], s["bd"],
                                  s["unit_size"], torch.bfloat16)
            else:
                got = s["out"]
            got = got.double().cpu().numpy()
            for (rt, rs), (gt, gs) in zip(_split(ref, s, P),
                                          _split(got, s, P)):
                d = float(np.abs(rt - gt).max())
                tap = max(tap, d)
                if d == 0:
                    rel = max(rel, float((np.abs(rs - gs) /
                                          np.maximum(np.abs(rs), 1.0))
                                         .max()))
    return {"lr_tap_max_abs": tap, "lr_sse_max_rel": rel}
