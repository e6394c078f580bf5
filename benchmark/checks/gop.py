"""Check of the GoP program (random access): every mini-GoP program that
the window dispatches (or a sample of them, `every`), compared with the
plain reference on the same inputs once the window has closed.

The program (svt_av1_psy_tpu_torch.ops.torch_backend gop_search_tf, or
gop_search with TF off) returns one packed buffer: the MVs and SADs of
every prediction edge, the SAD tree, the decide of every frame, and the
temporal filter's planes of the anchors. The reference recomputes:
- the temporal filter of each anchor from the window's frames, in
  float64 where the program computes in float32 (tf_max_abs: the largest
  |difference| of a filtered pixel; tf_off_share: the share of filtered
  pixels that differ at all);
- the search and the decide on the same frame stack, with the anchors
  replaced by the program's own filtered planes, so that a filter within
  its limits cannot show up as a search mismatch
  (gop_search_mismatch: MV, SAD and SAD-tree entries that differ;
  gop_decide_mismatch: decide bytes that differ).
The control runs the reference one precision below the configuration:
the filter in bfloat16, the search and decide on 7-bit pixels.
"""

from __future__ import annotations

import numpy as np
import torch


def install(ctx, cfg: dict) -> None:
    import svt_av1_psy_tpu_torch.models.ra as ra
    import svt_av1_psy_tpu_torch.ops.torch_backend as tb
    every = int(cfg.get("every", 1))
    for attr, tf in (("gop_search_tf", True), ("gop_search", False)):
        fn = getattr(ra, attr)
        # the arguments by the names of the program's own signature
        sig = getattr(tb, attr)

        def wrapped(*args, _fn=fn, _sig=sig, _tf=tf, **kwargs):
            out = _fn(*args, **kwargs)
            if ctx.take("gop", every):
                import harness
                ctx.keep("gop", {"tf": _tf,
                                 "args": harness.bind(_sig, args, kwargs),
                                 "out": out})
            return out

        ctx.patch(ra, attr, wrapped)


def _program_outputs(s: dict, P) -> dict:
    a = s["args"]
    frames = a["frames"]
    F_, H, W = frames.shape
    E = len(np.asarray(a["edges"]))
    buf = s["out"].cpu().numpy()
    if s["tf"]:
        n_f = 2 if a["win2_idx"] is not None else 1
        mv, sad, s32, s64, dec, filt = P.gop_search_tf_unpack(
            buf, F_, E, (H, W), a["bd"], n_filtered=n_f)
        filt = [tuple(np.asarray(p, np.int32) for p in f) for f in filt]
    else:
        mv, sad, s32, s64, dec = P.gop_search_unpack(buf, F_, E, (H, W))
        filt = []
    return {"search": (mv, sad, s32, s64), "dec": dec, "filt": filt}


def _windows(a: dict):
    """(luma window, u, v, mask) of each filtered anchor."""
    dev = a["frames"].device
    out = [(a["win_idx"], a["win_u"], a["win_v"], a["win_mask"])]
    if a["win2_idx"] is not None:
        out.append((a["win2_idx"], a["win2_u"], a["win2_v"],
                    a["win2_mask"]))
    return [(a["frames"][torch.as_tensor(np.asarray(i), dtype=torch.long)
                         .to(dev)], u, v, m) for i, u, v, m in out]


def _filtered_stack(a: dict, filt: list) -> torch.Tensor:
    """The frame stack with the anchors (positions 1, 2) replaced by the
    given filtered luma planes, as the program searches it."""
    frames = a["frames"].clone()
    for k, (fy, _, _) in enumerate(filt):
        frames[1 + k] = torch.as_tensor(fy, device=frames.device)
    return frames


def _control_outputs(s: dict, P) -> dict:
    a = s["args"]
    filt = []
    if s["tf"]:
        for wy, wu, wv, wm in _windows(a):
            filt.append(tuple(p.cpu().numpy() for p in P.tf_filter_device(
                wy, wu, wv, wm, a["strength"], a["bd"], torch.bfloat16)))
    frames = _filtered_stack(a, filt) & ~1
    mv, sad, s32, s64, dec = P.gop_search(frames, a["edges"],
                                          a["split_bias"], a["bd"],
                                          a["min_block"])
    return {"search": tuple(t.cpu().numpy() for t in (mv, sad, s32, s64)),
            "dec": dec.cpu().numpy(), "filt": filt}


def _judge(s: dict, out: dict, P) -> dict:
    a = s["args"]
    tf_max = 0.0
    tf_off = 0
    tf_n = 0
    if s["tf"]:
        for (wy, wu, wv, wm), got in zip(_windows(a), out["filt"]):
            ref = P.tf_filter_device(wy, wu, wv, wm, a["strength"], a["bd"],
                                     torch.float64)
            for r, g in zip(ref, got):
                d = np.abs(r.cpu().numpy().astype(np.int64) -
                           np.asarray(g, np.int64))
                tf_max = max(tf_max, float(d.max()))
                tf_off += int((d > 0).sum())
                tf_n += d.size
    frames = _filtered_stack(a, out["filt"])
    ref = P.gop_search(frames, a["edges"], a["split_bias"], a["bd"],
                       a["min_block"])
    mism = 0
    for r, g in zip(ref[:4], out["search"]):
        mism += int((r.cpu().numpy().astype(np.int64) !=
                     np.asarray(g, np.int64)).sum())
    dec = int((ref[4].cpu().numpy() != np.asarray(out["dec"])).sum())
    return {"gop_search_mismatch": mism, "gop_decide_mismatch": dec,
            "tf_max_abs": tf_max,
            "tf_off_share": tf_off / tf_n if tf_n else 0.0}


def readings(ctx, cfg: dict, control: bool = False) -> dict:
    """The worst of each number over the window's samples (None when the
    window dispatched no GoP program)."""
    import harness
    P = harness.reference()
    samples = ctx.samples.get("gop", [])
    keys = ("gop_search_mismatch", "gop_decide_mismatch", "tf_max_abs",
            "tf_off_share")
    if not samples:
        return {k: None for k in keys}
    worst = {k: 0 for k in keys}
    with torch.no_grad():
        for s in samples:
            out = _control_outputs(s, P) if control \
                else _program_outputs(s, P)
            for k, v in _judge(s, out, P).items():
                worst[k] = max(worst[k], v)
    return worst
