"""Check of the lookahead's per-superblock q offsets (tpl_sb_offsets in
svt_av1_psy_tpu_torch.models.tpl, called by the command for every frame):
a sample (`every`) of the window's calls, recomputed by the plain
reference (its own full search on the card, its own splat) from the same
source frames once the window has closed.

tpl_mismatch: superblock offsets that differ. The control runs the
reference's search on 7-bit pixels.
"""

from __future__ import annotations

import numpy as np
import torch


def install(ctx, cfg: dict) -> None:
    import svt_av1_psy_tpu_torch.models.tpl as tpl
    every = int(cfg.get("every", 8))
    fn = tpl.tpl_sb_offsets

    def wrapped(cur_y, future_ys, *args, **kwargs):
        future_ys = list(future_ys)
        out = fn(cur_y, future_ys, *args, **kwargs)
        if ctx.take("tpl", every) and out is not None:
            # the command's frames are read-only views of what it read
            # from the pipe: kept as they are, at no cost
            ctx.keep("tpl", {"cur": cur_y, "future": future_ys,
                             "out": np.array(out)})
        return out

    ctx.patch(tpl, "tpl_sb_offsets", wrapped)


def readings(ctx, cfg: dict, control: bool = False) -> dict:
    import harness
    P = harness.reference()
    samples = ctx.samples.get("tpl", [])
    if not samples:
        return {"tpl_mismatch": None}

    def low(src, ref, r=12):
        return P.hme_search(src.to(torch.int32) & ~1,
                            ref.to(torch.int32) & ~1, r)

    worst = 0
    with torch.no_grad():
        for s in samples:
            want = P.tpl_sb_offsets(s["cur"], s["future"], ctx.device)
            got = P.tpl_sb_offsets(s["cur"], s["future"], ctx.device,
                                   search=low) if control else s["out"]
            worst = max(worst, int((want != got).sum()))
    return {"tpl_mismatch": worst}
