"""Check of the intra decide on the low-delay route (intra_decide_packed,
launched for every frame by FastIntraEncoder): a sample (`every`) of the
window's calls, recomputed by the plain decide on the same padded plane
once the window has closed.

decide_mismatch: bytes of the packed decide (split flags and the top
modes at every block size) that differ. The control runs the plain
decide on 7-bit pixels.
"""

from __future__ import annotations

import numpy as np
import torch


def install(ctx, cfg: dict) -> None:
    import svt_av1_psy_tpu_torch.models.fast_intra as fi
    import svt_av1_psy_tpu_torch.ops.torch_backend as tb
    every = int(cfg.get("every", 4))
    fn = fi.intra_decide_packed

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if ctx.take("decide", every):
            import harness
            # the arguments by the names of the program's own signature
            ctx.keep("decide", {"args": harness.bind(tb.intra_decide_packed,
                                                     args, kwargs),
                                "out": out})
        return out

    ctx.patch(fi, "intra_decide_packed", wrapped)


def readings(ctx, cfg: dict, control: bool = False) -> dict:
    import harness
    P = harness.reference()
    samples = ctx.samples.get("decide", [])
    if not samples:
        return {"decide_mismatch": None}
    worst = 0
    with torch.no_grad():
        for s in samples:
            a = s["args"]
            plane = a["plane"].to(torch.int32)
            want = P.intra_decide_packed(plane, a["split_bias"], a["bd"],
                                         a["min_block"])
            got = P.intra_decide_packed(plane & ~1, a["split_bias"],
                                        a["bd"], a["min_block"]) \
                if control else s["out"]
            worst = max(worst, int((want.cpu().numpy() !=
                                    got.cpu().numpy()).sum()))
    return {"decide_mismatch": worst}
