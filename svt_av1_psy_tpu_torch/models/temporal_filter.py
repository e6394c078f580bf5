"""Alt-ref temporal filtering: motion-compensated noise reduction.

The key-frame filtering pass of the reference (ref
Source/Lib/Codec/temporal_filtering.c: svt_av1_init_temporal_filtering
:4064, medium planewise filter :1021) re-designed for the two-phase
architecture: the device HME (ops/jax_backend.hme_search) aligns each
neighbor source frame to the center frame per 16x16 block; the native MC
kernel produces the aligned predictions; blocks blend with
error-adaptive weights (high-error blocks fall back to the center). The
PSY tf-strength semantics scale the filter weaker than mainline
(ref README.md:79-105): higher `strength` filters MORE (0 disables).

The port's copy of svt_av1_psy_tpu/models/temporal_filter.py: the motion
search goes through the port's hme_mv_sad on a ``device=`` argument; the
alignment and the float64 accumulation are the reference's numpy code,
unchanged.
"""

from __future__ import annotations

import numpy as np


def _align_plane(center: np.ndarray, neigh: np.ndarray, mv16: np.ndarray,
                 bd: int, sub: int = 0):
    """MC-align `neigh` to `center` with per-16x16 (luma units) full-pel
    MVs — a pure clamped gather, fully vectorized (the per-block
    mc_block loop cost ~4.5 s/plane-set at 1080p; this is ~30 ms).
    Returns the aligned plane (int32) + per-block mean-SSE map."""
    H, W = center.shape
    bs = 16 >> sub
    n16r, n16c = mv16.shape[:2]
    dy = mv16[..., 0].astype(np.int32) >> sub
    dx = mv16[..., 1].astype(np.int32) >> sub
    dyp = np.repeat(np.repeat(dy, bs, 0), bs, 1)[:H, :W]
    dxp = np.repeat(np.repeat(dx, bs, 0), bs, 1)[:H, :W]
    ys = np.clip(np.arange(H)[:, None] + dyp, 0, H - 1)
    xs = np.clip(np.arange(W)[None, :] + dxp, 0, W - 1)
    out = np.asarray(neigh)[ys, xs].astype(np.int32)
    d2 = (out.astype(np.int64)
          - np.asarray(center, np.int64)) ** 2
    ph, pw = n16r * bs, n16c * bs
    d2p = np.zeros((ph, pw), np.int64)
    d2p[:H, :W] = d2
    cnt = np.zeros((ph, pw), np.int64)
    cnt[:H, :W] = 1
    bsum = d2p.reshape(n16r, bs, n16c, bs).sum((1, 3))
    bcnt = np.maximum(cnt.reshape(n16r, bs, n16c, bs).sum((1, 3)), 1)
    return out, bsum // bcnt


def temporal_filter(frames, center_idx: int, strength: int = 1,
                    bd: int = 8, *, device):
    """Filter frames[center_idx] against the other frames in the window.

    frames: list of (y, u, v); strength 0..4 (0 = off, returns center);
    device: where the motion search runs ("cpu" or "cuda[:N]").
    Returns filtered (y, u, v) uint arrays."""
    if strength <= 0 or len(frames) < 2:
        return frames[center_idx]
    from svt_av1_psy_tpu_torch.models.fast_intra import hme_mv_sad

    cy, cu, cv = [np.asarray(p) for p in frames[center_idx]]
    H, W = cy.shape
    # pad to 16-multiples for HME
    ph = (H + 15) // 16 * 16
    pw = (W + 15) // 16 * 16
    cyp = np.pad(cy, ((0, ph - H), (0, pw - W)), mode="edge")
    acc_y = cy.astype(np.float64).copy()
    acc_u = cu.astype(np.float64).copy()
    acc_v = cv.astype(np.float64).copy()
    wt_y = np.ones_like(acc_y)
    wt_c = np.ones_like(acc_u)
    # noise-adaptive threshold: weight decays with block MSE
    sigma2 = max(4.0, float(np.var(np.diff(cy.astype(np.int32), axis=1)))
                 / 8.0)
    for i, f in enumerate(frames):
        if i == center_idx:
            continue
        ny, nu, nv = [np.asarray(p) for p in f]
        nyp = np.pad(ny, ((0, ph - H), (0, pw - W)), mode="edge")
        mv16, _ = hme_mv_sad(cyp, nyp, device)
        mv16 = np.asarray(mv16, np.int32)
        ay, err = _align_plane(cy, ny, mv16, bd, 0)
        # per-block weights (medium planewise filter analog): the PSY
        # tf-strength scales filtering DOWN at low strengths
        w_blk = np.exp(-err / (sigma2 * (1.0 + strength)))
        w_blk = np.where(err > 16 * sigma2, 0.0, w_blk)
        w_px = np.repeat(np.repeat(w_blk, 16, 0), 16, 1)[:H, :W]
        acc_y += w_px * ay
        wt_y += w_px
        au, _ = _align_plane(cu, nu, mv16, bd, 1)
        av, _ = _align_plane(cv, nv, mv16, bd, 1)
        w_pc = np.repeat(np.repeat(w_blk, 8, 0), 8, 1)[:cu.shape[0],
                                                       :cu.shape[1]]
        acc_u += w_pc * au
        acc_v += w_pc * av
        wt_c += w_pc
    hi = (1 << bd) - 1
    dt = cy.dtype
    fy = np.clip(np.rint(acc_y / wt_y), 0, hi).astype(dt)
    fu = np.clip(np.rint(acc_u / wt_c), 0, hi).astype(dt)
    fv = np.clip(np.rint(acc_v / wt_c), 0, hi).astype(dt)
    return fy, fu, fv
