"""Check of the single-level full search (the K1 kernel, hme_search_kernel
in svt_av1_psy_tpu_torch.kernels.hme) on the low-delay route: a sample
(`every`) of the window's calls, from the P frames' searches and the
lookahead's, recomputed by the plain full search on the same two planes
once the window has closed.

k1_mismatch: MV and SAD entries that differ. The reference plane of a P
frame's search is the encoder's reconstruction, which the reference takes
as given (the host walks that make it are not recomputed). The control
runs the plain search on 7-bit pixels.
"""

from __future__ import annotations

import numpy as np
import torch


def install(ctx, cfg: dict) -> None:
    import svt_av1_psy_tpu_torch.models.fast_intra as fi
    every = int(cfg.get("every", 8))
    fn = fi.hme_search_kernel

    def wrapped(src, ref, search_range=12):
        out = fn(src, ref, search_range)
        if ctx.take("k1", every):
            ctx.keep("k1", {"src": src, "ref": ref, "r": search_range,
                            "out": out})
        return out

    ctx.patch(fi, "hme_search_kernel", wrapped)


def readings(ctx, cfg: dict, control: bool = False) -> dict:
    import harness
    P = harness.reference()
    samples = ctx.samples.get("k1", [])
    if not samples:
        return {"k1_mismatch": None}
    worst = 0
    with torch.no_grad():
        for s in samples:
            src, ref = s["src"].to(torch.int32), s["ref"].to(torch.int32)
            want = P.hme_search(src, ref, s["r"])
            got = P.hme_search(src & ~1, ref & ~1, s["r"]) if control \
                else s["out"]
            n = sum(int((w.cpu().numpy().astype(np.int64) !=
                         g.cpu().numpy().astype(np.int64)).sum())
                    for w, g in zip(want, got))
            worst = max(worst, n)
    return {"k1_mismatch": worst}
