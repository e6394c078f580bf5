"""TPL: temporal-dependency-model adaptive quantization.

The lookahead TPL pass of the reference (ref Source/Lib/Codec/
tpl_model.c: tpl_mc_flow dependency propagation, generate_r0beta ->
sb_setup_lambda per-SB qindex offsets) re-designed for the two-phase
architecture:

- the device HME (ops/jax_backend.hme_search) motion-searches each
  LOOKAHEAD frame against the frame being encoded (telescoping, with a
  per-hop decay standing in for the reference's recursive backward
  induction over mc_dep_cost),
- each future block's prediction benefit max(0, intra_cost - inter_cost)
  is splatted through its motion vector onto the referenced area of the
  current frame (area-weighted, the tpl_model_update_b analog),
- per-superblock offsets are -strength * log2(1 + credit/self_cost):
  blocks the future leans on get a lower qindex, normalized zero-mean so
  the frame's average rate is unchanged (the beta = r0/rk rule).

Costs are computed at half resolution in matched units: inter cost is
the HME SAD itself, intra cost is the gradient activity of the same 8x8
half-res block.

The port's copy of svt_av1_psy_tpu/models/tpl.py: tpl_sb_offsets and the
edge_results=None fallback of tpl_gop_q run their motion search through
the port's hme_mv_sad on a ``device=`` argument; the rest is the
reference's code (tests/test_torch_standalone.py guards it).
"""

from __future__ import annotations

import numpy as np


def _activity_halfres(yh: np.ndarray) -> np.ndarray:
    """Per-8x8 gradient activity of a half-res plane (intra-cost proxy,
    same abs-pixel-diff units as the HME SAD)."""
    a = yh.astype(np.int32)
    gx = np.abs(np.diff(a, axis=1))
    gy = np.abs(np.diff(a, axis=0))
    act = np.zeros_like(a)
    act[:, :-1] += gx
    act[:-1, :] += gy
    hh, wh = a.shape
    n8r, n8c = hh // 8, wh // 8
    return act[:n8r * 8, :n8c * 8].reshape(n8r, 8, n8c, 8).sum((1, 3))


def _downsample2(y: np.ndarray) -> np.ndarray:
    a = y.astype(np.int32)
    h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
    a = a[:h2, :w2]
    return (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
            + a[1::2, 1::2] + 2) >> 2


def tpl_sb_offsets(cur_y: np.ndarray, future_ys, strength: float = 4.0,
                   decay: float = 0.7, max_hops: int = 3, *, device):
    """Per-superblock qindex offsets for `cur_y` given lookahead frames.

    cur_y: (H, W) luma (any uint dtype); future_ys: iterable of future
    source lumas nearest-first; device: where the motion search runs
    ("cpu" or "cuda[:N]"). Returns (sb_rows, sb_cols) int32 offsets
    (<= 0 where the future depends on the block, > 0 elsewhere;
    zero-mean) or None when there is no usable lookahead."""
    future_ys = [f for f in future_ys][:max_hops]
    if not future_ys:
        return None
    from svt_av1_psy_tpu_torch.utils import trace as _tr
    with _tr.span("tpl_sb_offsets"):
        from svt_av1_psy_tpu_torch.models.fast_intra import hme_mv_sad

        H, W = cur_y.shape
        ph = (H + 15) // 16 * 16
        pw = (W + 15) // 16 * 16

        def pad(p):
            return np.pad(np.asarray(p), ((0, ph - H), (0, pw - W)),
                          mode="edge")

        cp = pad(cur_y)
        credit = np.zeros((ph // 2, pw // 2), np.float64)
        for k, fy in enumerate(future_ys):
            fp = pad(fy)
            mv16, sad16 = hme_mv_sad(fp, cp, device)
            mv16 = np.asarray(mv16, np.int64)
            sad16 = np.asarray(sad16, np.int64)
            act = _activity_halfres(_downsample2(fp))
            ben = np.clip(act - sad16, 0, None).astype(np.float64) \
                * (decay ** (k + 1))
            n8r, n8c = ben.shape
            hh, wh = credit.shape
            for br in range(n8r):
                for bc in range(n8c):
                    b = ben[br, bc]
                    if b <= 0:
                        continue
                    # splat through the (half-res) motion vector onto the
                    # referenced 8x8 area of the current frame
                    y0 = br * 8 + int(mv16[br, bc, 0]) // 2
                    x0 = bc * 8 + int(mv16[br, bc, 1]) // 2
                    y0 = max(0, min(y0, hh - 8))
                    x0 = max(0, min(x0, wh - 8))
                    credit[y0:y0 + 8, x0:x0 + 8] += b / 64.0

        self_cost = _activity_halfres(_downsample2(cp)).astype(np.float64)
        cost_px = np.repeat(np.repeat(self_cost / 64.0, 8, 0), 8, 1)
        sb_rows = (H + 63) // 64
        sb_cols = (W + 63) // 64

        def sb_sum(plane):
            p = np.zeros((sb_rows * 32, sb_cols * 32), np.float64)
            p[:plane.shape[0], :plane.shape[1]] = \
                plane[:sb_rows * 32, :sb_cols * 32]
            return p.reshape(sb_rows, 32, sb_cols, 32).sum((1, 3))

        cred_sb = sb_sum(credit)
        cost_sb = sb_sum(cost_px)
        r = cred_sb / np.maximum(cost_sb, 1.0)
        off = -strength * np.log2(1.0 + r)
        off -= off.mean()                      # rate-neutral (beta rule)
        return np.clip(np.rint(off), -12, 12).astype(np.int32)


def qindex_for_qstep_ratio(base_q: int, ratio: float, bd: int = 8) -> int:
    """qindex whose AC quantizer step is closest to ratio * qstep(base_q)
    (the av1_get_q_index_from_qstep_ratio role in the reference's
    tpl_get_q_index, ref rc_process.c:873 generate_r0beta consumer)."""
    from svt_av1_psy_tpu_torch.ops.quant import ac_q
    target = ac_q(base_q, bd) * ratio
    best, bestd = base_q, None
    for q in range(1, 256):
        d = abs(ac_q(q, bd) - target)
        if bestd is None or d < bestd:
            best, bestd = q, d
    return best


def _splat8(credit8: np.ndarray, y0: np.ndarray, x0: np.ndarray,
            val: np.ndarray) -> None:
    """Scatter per-block credit onto an 8x8-cell grid with bilinear
    overlap weights (the tpl_model_update_b block-overlap rule): an 8x8
    landing area at half-res pixel (y0, x0) overlaps up to four cells."""
    n8r, n8c = credit8.shape
    y0 = np.clip(y0, 0, n8r * 8 - 8)
    x0 = np.clip(x0, 0, n8c * 8 - 8)
    gr, gc = y0 // 8, x0 // 8
    oy, ox = (y0 - gr * 8).astype(np.float64), \
        (x0 - gc * 8).astype(np.float64)
    for dy, dx, w in ((0, 0, (8 - oy) * (8 - ox)), (0, 1, (8 - oy) * ox),
                      (1, 0, oy * (8 - ox)), (1, 1, oy * ox)):
        rr = np.clip(gr + dy, 0, n8r - 1)
        cc = np.clip(gc + dx, 0, n8c - 1)
        np.add.at(credit8, (rr, cc), val * (w / 64.0))


# reference boost-formula constants (behavioral model of
# ref rc_process.c:776 r0_weight {0.75 I, 0.9 BASE} and the r0
# adjustment divisors rc_process.c:831/:847 with the preset-6
# initial_rc_process.c r0_adjust_factor 2.8 and islice factor 0.7 at
# 5 hierarchical levels: key divides by 2.8*0.7, base frames by 2.8)
_KEY_W, _KEY_DIV = 0.75, 1.96
_ARF_W, _ARF_DIV = 0.9, 2.8


def _knob(name: str, default: float) -> float:
    import os
    v = os.environ.get(name)
    return float(v) if v else default
# skip-ability gate: dependency credit only flows through cells whose
# best inter SAD sits below tau * qstep — a dependent block whose
# residual exceeds the quantizer deadzone re-codes itself at the
# operating point and the anchor's extra fidelity dies there (the
# quantized-cost propagation fraction of ref tpl_model.c
# tpl_model_update). tau swept against BD-rate on 5 content classes
# (occl/default/grain/text/pan) x 4 CRFs vs the measured reference:
# 0.03 won overall (deep boosts survive only for exactly-predictable
# content like static text; noisy content converges to the flat
# r0=1 ladder whose anchors sit at the w/sqrt(div) ratio floor).
# Thresholds in halfres-SAD units per 64-px cell, qstep = ac_q/8.
_GATE_TAU = 0.03


def tpl_gop_q(frames_y: dict, plan, base_q: int, bd: int = 8,
              strength: float = 1.0, edge_results: dict | None = None,
              key_d=None, base_q_coded: int | None = None, *,
              device=None) -> dict:
    """Per-frame qindex ladder for a mini-GoP from TPL dependency flow —
    the r0/beta half of the reference's TPL (ref tpl_model.c tpl_mc_flow
    / tpl_model_update_b backward induction; rc_process.c:783
    crf_qindex_calc), re-designed for the two-phase architecture: the
    device HME supplies per-16x16 inter costs, gradient activity the
    intra costs; dependency credit is splatted through the MV onto the
    referenced frame's cell grid (bilinear overlap weights), gated by
    skip-ability (see _GATE_TAU).

    The ladder follows the reference shape:
    - base-layer frames (the GoP base when key_d is given, and the ARF)
      get qstep(base_q) * sqrt(r0/div) * weight where
      r0 = own/(own + credit) (ref rc_process.c:873 qstep_ratio);
    - non-base referenced frames interpolate halfway from their worst
      reference's qindex toward base_q per pyramid level (the
      non_base_qindex_weight rule, rc_process.c:902-916);
    - leaves code slightly below base_q (the INTER_NORMAL frame-type
      qdelta analog).

    frames_y: {display_idx: luma plane} (the base anchor entry may be
    its recon). plan: encode-order [(d, lo_ref_d, hi_ref_d, depth)];
    references always precede their dependents. edge_results (optional):
    {(d, ref_d) -> (mv16, sad16)} precomputed by the GoP-batched device
    search (ops/jax_backend.gop_search) — when given, no device work
    happens here at all. key_d: display index of the GoP base when it
    is a not-yet-coded key frame whose q should come from the same r0
    model (included in the returned dict). Returns {d: qindex} for
    every planned frame (+ key_d). base_q_coded: the qindex the GoP
    base anchor was actually coded at (the ref_pic_qp_array role,
    rc_process.c:808) — used as the interpolation start for frames that
    reference it; defaults to the key's computed q or base_q. device:
    where the motion search runs when edge_results is None ("cpu" or
    "cuda[:N]"; required then)."""
    from svt_av1_psy_tpu_torch.ops.quant import ac_q

    some = next(iter(frames_y.values()))
    H, W = np.asarray(some).shape[:2]
    ph, pw = (H + 15) // 16 * 16, (W + 15) // 16 * 16

    def pad(p):
        p = np.asarray(p)[:H, :W]
        return np.pad(p, ((0, ph - H), (0, pw - W)), mode="edge")

    padded = {d: pad(y) for d, y in frames_y.items()}
    if edge_results is None:
        from svt_av1_psy_tpu_torch.models.fast_intra import hme_mv_sad
        if device is None:
            raise ValueError("tpl_gop_q: device= is needed to search the "
                             "edges when edge_results is None")
        edge_results = {}
        for d, lo, hi, *_ in plan:
            for r in sorted({lo, hi}):
                edge_results[(d, r)] = hme_mv_sad(padded[d], padded[r],
                                                  device)
    act = {d: np.maximum(_activity_halfres(_downsample2(p)),
                         1).astype(np.float64)
           for d, p in padded.items()}
    n8r, n8c = next(iter(act.values())).shape
    credit = {d: np.zeros((n8r, n8c)) for d in frames_y}
    gy, gx = np.mgrid[0:n8r, 0:n8c]
    gate_thr = _knob("SVT_TPL_TAU", _GATE_TAU) \
        * (ac_q(base_q, bd) / (8.0 * (1 << (bd - 8)))) * 64.0

    # reverse encode order = backward induction: every frame that
    # references d is processed before d, so credit[d] is complete when
    # d's own flow is propagated further down to its references
    for d, lo, hi, *_ in reversed(list(plan)):
        best_sad = best_mv = best_ref = None
        for r in sorted({lo, hi}):
            mv, sad = edge_results[(d, r)]
            sad = np.asarray(sad, np.float64)[:n8r, :n8c]
            mv = np.asarray(mv, np.int64)[:n8r, :n8c]
            if best_sad is None:
                best_sad, best_mv = sad, mv
                best_ref = np.full(sad.shape, r, np.int64)
            else:
                m = sad < best_sad
                best_sad = np.where(m, sad, best_sad)
                best_mv = np.where(m[..., None], mv, best_mv)
                best_ref = np.where(m, r, best_ref)
        # intra cost = half the gradient activity: gx+gy counts each
        # pixel's unpredictability twice, while the temporal SAD counts
        # it once — for temporally-independent noise E|gx| = E|a-b|, so
        # the halving makes delta vanish on pure noise (no spurious
        # dependency credit) and stay positive only where the future
        # genuinely predicts from this frame
        a = np.maximum(act[d] * 0.5, 1.0)
        # smooth skip-ability weight (hard thresholding is knife-edge
        # sensitive when the SAD distribution is narrow/noise-driven)
        gate = 1.0 / (1.0 + (best_sad / gate_thr) **
                      _knob("SVT_TPL_GATE_P", 4.0))
        delta = np.clip(a - best_sad, 0.0, None) * gate
        # benefit + the transitive share of this frame's own accumulated
        # dependency (the (intra-inter)/intra propagation fraction of
        # tpl_model_update)
        flow = delta + (delta / a) * credit[d]
        y0 = gy * 8 + best_mv[..., 0] // 2
        x0 = gx * 8 + best_mv[..., 1] // 2
        for r in sorted({lo, hi}):
            m = (best_ref == r) & (flow > 0)
            if m.any():
                _splat8(credit[r], y0[m].ravel(), x0[m].ravel(),
                        flow[m].ravel())

    def _r0(d, continuation=1.0):
        """continuation: structural multiplier for credit the GoP-local
        plan cannot see — the ARF of GoP N becomes the BASE of GoP N+1
        and serves ~one more mini-GoP of dependents (the reference's
        TPL group spans tpl_lad_mg extra mini-GoPs of lookahead, ref
        src_ops_process.c tpl_group; our pipeline walks GoP-locally, so
        the ARF's continuation is known structurally, not measured)."""
        own = float(np.maximum(act[d] * 0.5, 1.0).sum())
        s = strength * _knob("SVT_TPL_CRED", 1.0) * continuation
        return own / (own + s * float(credit[d].sum()))

    qmap = {}
    b, arf_d = plan[0][1], plan[0][0]
    if key_d is not None:
        ratio = min(1.0, float(np.sqrt(
            _r0(key_d, continuation=2.0)
            / _knob("SVT_TPL_KEY_DIV", _KEY_DIV))) * _KEY_W)
        qmap[key_d] = qindex_for_qstep_ratio(base_q, ratio, bd)
    if b not in qmap:
        qmap[b] = base_q_coded if base_q_coded is not None else base_q
    referenced = set()
    for d, lo, hi, *_ in plan:
        referenced.add(lo)
        referenced.add(hi)
    # leaves at base q (the reference refines them ~base-10, but both a
    # fixed and a gate-pass-adaptive leaf refinement measured 2-4% BD
    # worse across occl/default/pan; only the grain class likes finer
    # leaves)
    leaf_q = base_q - int(_knob("SVT_TPL_LEAF", 0.0) *
                          max(4, base_q // 16))
    for d, lo, hi, dep in plan:
        if d == arf_d:
            ratio = min(1.0, float(np.sqrt(
                _r0(arf_d, continuation=2.0)
                / _knob("SVT_TPL_ARF_DIV", _ARF_DIV)))
                * _ARF_W)
            qmap[d] = qindex_for_qstep_ratio(base_q, ratio, bd)
        elif d in referenced:
            # worst reference's q, halved toward base per level gap
            refq = max(qmap.get(lo, base_q), qmap.get(hi, base_q))
            qmap[d] = (refq + base_q + 1) // 2
        else:
            qmap[d] = leaf_q
    return qmap


def snap_sb_q(base_q: int, sbq: np.ndarray):
    """Snap absolute per-SB qindex values to the delta_q_res grid the
    bitstream signals (same res-by-operating-point rule as
    variance_boost.adjust_sb_qindex, ref rc_process.c:1675)."""
    sbq = np.clip(sbq, 1, 255).astype(np.int32)
    if base_q >= 160:
        res_log2 = 3
    elif base_q >= 120:
        res_log2 = 2
    elif base_q >= 80:
        res_log2 = 1
    else:
        res_log2 = 0
    if res_log2:
        res = 1 << res_log2
        mask = ~(res - 1)
        rem = base_q & ~mask
        sbq = (sbq & mask) + rem
        sbq = np.where(sbq == 0, res, sbq)
    return sbq.astype(np.int32), res_log2
