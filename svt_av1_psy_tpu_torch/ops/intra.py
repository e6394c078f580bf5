"""AV1 intra prediction — decoder-normative (spec 7.11.2).

Covers the non-directional predictor family (DC, V, H, SMOOTH/V/H, PAETH)
plus edge preparation; directional modes with angle deltas, filter-intra and
CfL land in later passes. Reference counterparts:
Source/Lib/Codec/intra_prediction.c (decoder-side exactness) and
enc_intra_prediction.c (search-side usage).

All predictors are pure functions of the prepared edge arrays so the JAX
batch path can vmap them over superblock candidate sets.
"""

from __future__ import annotations

import functools

import numpy as np

from svt_av1_psy_tpu_torch.constants import PredMode

# spec 7.11.2.6 smooth-weight table, indexed by block dimension
_SM_WEIGHTS = {
    4: np.array([255, 149, 85, 64], np.int32),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32], np.int32),
    16: np.array([255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26,
                  20, 17, 16], np.int32),
    32: np.array([255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
                  101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14,
                  12, 10, 9, 8, 8], np.int32),
    64: np.array([255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176,
                  169, 163, 156, 150, 144, 138, 133, 127, 121, 116, 111, 106,
                  101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44,
                  41, 38, 35, 32, 29, 27, 25, 22, 20, 18, 16, 15, 13, 12, 10,
                  9, 8, 7, 6, 6, 5, 5, 4, 4, 4], np.int32),
}


def prepare_edges(recon: np.ndarray, x: int, y: int, w: int, h: int,
                  have_above: bool, have_left: bool, bd: int = 8):
    """Build (above[w], left[h], above_left) from the recon plane at (x, y).

    Unavailable edges follow the spec fill rules (libaom
    build_intra_predictors equivalent). recon is the in-progress plane."""
    base = 1 << (bd - 1)
    if have_above:
        above = recon[y - 1, x:x + w].astype(np.int32)
    elif have_left:
        above = np.full(w, int(recon[y, x - 1]), np.int32)
    else:
        above = np.full(w, base - 1, np.int32)
    if have_left:
        left = recon[y:y + h, x - 1].astype(np.int32)
    elif have_above:
        left = np.full(h, int(recon[y - 1, x]), np.int32)
    else:
        left = np.full(h, base + 1, np.int32)
    if have_above and have_left:
        above_left = int(recon[y - 1, x - 1])
    elif have_above:
        above_left = int(recon[y - 1, x])
    elif have_left:
        above_left = int(recon[y, x - 1])
    else:
        above_left = base
    return above, left, above_left


def dc_pred(above, left, w: int, h: int, have_above: bool, have_left: bool,
            bd: int = 8) -> np.ndarray:
    if have_above and have_left:
        s = int(above[:w].sum() + left[:h].sum())
        dc = (s + ((w + h) >> 1)) // (w + h)
    elif have_above:
        dc = (int(above[:w].sum()) + (w >> 1)) >> w.bit_length() - 1
    elif have_left:
        dc = (int(left[:h].sum()) + (h >> 1)) >> h.bit_length() - 1
    else:
        dc = 1 << (bd - 1)
    return np.full((h, w), dc, np.int32)


def v_pred(above, left, w: int, h: int) -> np.ndarray:
    return np.broadcast_to(above[:w].reshape(1, w), (h, w)).astype(np.int32)


def h_pred(above, left, w: int, h: int) -> np.ndarray:
    return np.broadcast_to(left[:h].reshape(h, 1), (h, w)).astype(np.int32)


def smooth_pred(above, left, w: int, h: int) -> np.ndarray:
    wx = _SM_WEIGHTS[w]
    wy = _SM_WEIGHTS[h]
    below = int(left[h - 1])
    right = int(above[w - 1])
    a = above[:w].astype(np.int64).reshape(1, w)
    l = left[:h].astype(np.int64).reshape(h, 1)
    num = (wy.reshape(h, 1) * a + (256 - wy).reshape(h, 1) * below +
           wx.reshape(1, w) * l + (256 - wx).reshape(1, w) * right)
    return ((num + 256) >> 9).astype(np.int32)


def smooth_v_pred(above, left, w: int, h: int) -> np.ndarray:
    wy = _SM_WEIGHTS[h]
    below = int(left[h - 1])
    a = above[:w].astype(np.int64).reshape(1, w)
    num = wy.reshape(h, 1) * a + (256 - wy).reshape(h, 1) * below
    return ((num + 128) >> 8).astype(np.int32)


def smooth_h_pred(above, left, w: int, h: int) -> np.ndarray:
    wx = _SM_WEIGHTS[w]
    right = int(above[w - 1])
    l = left[:h].astype(np.int64).reshape(h, 1)
    num = wx.reshape(1, w) * l + (256 - wx).reshape(1, w) * right
    return ((num + 128) >> 8).astype(np.int32)


def paeth_pred(above, left, above_left: int, w: int, h: int) -> np.ndarray:
    a = above[:w].astype(np.int32).reshape(1, w)
    l = left[:h].astype(np.int32).reshape(h, 1)
    al = np.int32(above_left)
    base = a + l - al
    pa = np.abs(base - a)
    pl = np.abs(base - l)
    pal = np.abs(base - al)
    out = np.where((pa <= pl) & (pa <= pal), np.broadcast_to(a, (h, w)),
                   np.where(pl <= pal, np.broadcast_to(l, (h, w)), al))
    return out.astype(np.int32)


# --- directional prediction (spec 7.11.2.4) --------------------------------

from svt_av1_psy_tpu_torch.constants import MODE_TO_ANGLE, tables as _tables

ANGLE_STEP = 3
_EDGE_KERNELS = np.array([[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]],
                         np.int32)


def _deriv(angle: int) -> int:
    t = _tables()["dr_intra_derivative"]
    if angle < 90:
        return int(t[angle])
    if angle < 180:
        return int(t[180 - angle])
    return int(t[angle - 90]) if angle <= 180 else int(t[270 - angle])


def dr_deriv_dx(p_angle: int) -> int:
    t = _tables()["dr_intra_derivative"]
    return int(t[p_angle]) if p_angle < 90 else int(t[180 - p_angle])


def dr_deriv_dy(p_angle: int) -> int:
    t = _tables()["dr_intra_derivative"]
    return int(t[p_angle - 90]) if p_angle < 180 else int(t[270 - p_angle])


def edge_filter_strength(w: int, h: int, filter_type: int, delta: int) -> int:
    """spec intra_edge_filter_strength."""
    d = abs(delta)
    blk_wh = w + h
    s = 0
    if filter_type == 0:
        if blk_wh <= 8:
            if d >= 56:
                s = 1
        elif blk_wh <= 12:
            if d >= 40:
                s = 1
        elif blk_wh <= 16:
            if d >= 40:
                s = 1
        elif blk_wh <= 24:
            if d >= 8:
                s = 1
            if d >= 16:
                s = 2
            if d >= 32:
                s = 3
        elif blk_wh <= 32:
            s = 1
            if d >= 4:
                s = 2
            if d >= 32:
                s = 3
        else:
            s = 3
    else:
        if blk_wh <= 8:
            if d >= 40:
                s = 1
            if d >= 64:
                s = 2
        elif blk_wh <= 16:
            if d >= 20:
                s = 1
            if d >= 48:
                s = 2
        elif blk_wh <= 24:
            if d >= 4:
                s = 3
        else:
            s = 3
    return s


def use_edge_upsample(w: int, h: int, filter_type: int, delta: int) -> bool:
    d = abs(delta)
    blk_wh = w + h
    if d <= 0 or d >= 40:
        return False
    return blk_wh <= 8 if filter_type else blk_wh <= 16


def _edge_filter(buf: np.ndarray, sz: int, strength: int) -> None:
    """spec intra_edge_filter over buf[0..sz-1], in place (vectorized)."""
    if strength == 0 or sz <= 1:
        return
    k = _EDGE_KERNELS[strength - 1]
    src = buf[:sz].astype(np.int64)
    padded = np.concatenate((src[:1], src[:1], src, src[-1:], src[-1:]))
    acc = np.zeros(sz, np.int64)
    for j in range(5):
        acc += padded[j:j + sz] * int(k[j])
    out = (acc + 8) >> 4
    buf[1:sz] = out[1:]


def _edge_upsample(buf_m2: np.ndarray, num_px: int, bd: int) -> None:
    """spec intra_edge_upsample (vectorized). buf_m2 offset +2 indexing."""
    dup = np.zeros(num_px + 3, np.int64)
    dup[0] = buf_m2[1]
    dup[1:num_px + 2] = buf_m2[1:num_px + 2]
    dup[num_px + 2] = buf_m2[num_px + 1]
    buf_m2[0] = dup[0]
    hi = (1 << bd) - 1
    sv = -dup[:num_px] + 9 * dup[1:num_px + 1] + 9 * dup[2:num_px + 2] \
        - dup[3:num_px + 3]
    odd = np.clip((sv + 8) >> 4, 0, hi)
    buf_m2[1:1 + 2 * num_px:2] = odd
    buf_m2[2:2 + 2 * num_px:2] = dup[2:num_px + 2]


def directional_pred(mode: int, angle_delta: int, above_ext: np.ndarray,
                     left_ext: np.ndarray, above_left: int, w: int, h: int,
                     have_above: bool, have_left: bool, *,
                     enable_edge_filter: bool = True, filter_type: int = 0,
                     n_top_px: int = 0, n_left_px: int = 0,
                     bd: int = 8) -> np.ndarray:
    """Directional intra prediction (spec 7.11.2.4 + edge prep 7.11.2).

    above_ext: (w+h,) edge row (already availability-filled + extended);
    left_ext: (h+w,) edge col; n_top_px / n_left_px: count of REAL pixels in
    each array (for the edge-filter length), rest is replication."""
    p_angle = MODE_TO_ANGLE[PredMode(mode)] + angle_delta * ANGLE_STEP
    hi = (1 << bd) - 1
    if p_angle == 90:
        return v_pred(above_ext, left_ext, w, h)
    if p_angle == 180:
        return h_pred(above_ext, left_ext, w, h)

    # working buffers with index offset +2 (room for [-2], [-1])
    ab = np.zeros(2 + w + h + 16, np.int32)
    le = np.zeros(2 + w + h + 16, np.int32)
    ab[1] = above_left
    ab[2:2 + w + h] = above_ext[:w + h]
    le[1] = above_left
    le[2:2 + w + h] = left_ext[:w + h]

    upsample_above = upsample_left = False
    if enable_edge_filter:
        if 90 < p_angle < 180 and (w + h) >= 24:
            # filter corner
            v = (5 * int(le[2]) + 6 * int(ab[1]) + 5 * int(ab[2]) + 8) >> 4
            ab[1] = v
            le[1] = v
        if have_above:
            strength = edge_filter_strength(w, h, filter_type, p_angle - 90)
            num_px = min(w, n_top_px) + (h if p_angle < 90 else 0) + 1
            _edge_filter(ab[1:], num_px, strength)
        if have_left:
            strength = edge_filter_strength(w, h, filter_type, p_angle - 180)
            num_px = min(h, n_left_px) + (w if p_angle > 180 else 0) + 1
            _edge_filter(le[1:], num_px, strength)
        upsample_above = use_edge_upsample(w, h, filter_type, p_angle - 90)
        if upsample_above:
            num_px = w + (h if p_angle < 90 else 0)
            _edge_upsample(ab, num_px, bd)
        upsample_left = use_edge_upsample(w, h, filter_type, p_angle - 180)
        if upsample_left:
            num_px = h + (w if p_angle > 180 else 0)
            _edge_upsample(le, num_px, bd)

    ua = 1 if upsample_above else 0
    ul = 1 if upsample_left else 0
    if p_angle < 90:
        base, shift, clip_mask = _dr_maps_z1(w, h, p_angle, ua, False)
        max_base = (w + h - 1) << ua
        b = np.minimum(base, max_base)
        v = (ab[2 + b] * (32 - shift) + ab[2 + b + 1] * shift + 16) >> 5
        out = np.where(base < max_base, v, ab[2 + max_base])
    elif p_angle < 180:
        (a_base, a_shift, use_above, l_base,
         l_shift) = _dr_maps_z2(w, h, p_angle, ua, ul)
        va = (ab[2 + a_base] * (32 - a_shift) +
              ab[2 + a_base + 1] * a_shift + 16) >> 5
        vl = (le[2 + l_base] * (32 - l_shift) +
              le[2 + l_base + 1] * l_shift + 16) >> 5
        out = np.where(use_above, va, vl)
    else:
        base, shift, clip_mask = _dr_maps_z1(h, w, 270 + (180 - p_angle) - 90,
                                             ul, True)
        # zone 3 mirrors zone 1 over the left edge: reuse via explicit maps
        base, shift, _ = _dr_maps_z3(w, h, p_angle, ul)
        max_base = (w + h - 1) << ul
        b = np.minimum(base, max_base)
        v = (le[2 + b] * (32 - shift) + le[2 + b + 1] * shift + 16) >> 5
        out = np.where(base < max_base, v, le[2 + max_base])
    return np.clip(out, 0, hi).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _dr_maps_z1(w, h, p_angle, ua, _unused):
    dx = dr_deriv_dx(p_angle)
    i = np.arange(h).reshape(h, 1)
    j = np.arange(w).reshape(1, w)
    idx = (i + 1) * dx
    base = (idx >> (6 - ua)) + (j << ua)
    shift = ((idx << ua) >> 1) & 0x1F
    shift = np.broadcast_to(shift, (h, w))
    return base, shift, None


@functools.lru_cache(maxsize=None)
def _dr_maps_z2(w, h, p_angle, ua, ul):
    dx = dr_deriv_dx(p_angle)
    dy = dr_deriv_dy(p_angle)
    i = np.arange(h).reshape(h, 1)
    j = np.arange(w).reshape(1, w)
    idx = (j << 6) - (i + 1) * dx
    a_base = idx >> (6 - ua)
    a_shift = ((idx << ua) >> 1) & 0x1F
    use_above = a_base >= -(1 << ua)
    a_base = np.maximum(a_base, -(1 << ua))   # safe index when unused
    idx2 = (i << 6) - (j + 1) * dy
    l_base = idx2 >> (6 - ul)
    l_shift = ((idx2 << ul) >> 1) & 0x1F
    l_base = np.maximum(l_base, -2)
    return (np.broadcast_to(a_base, (h, w)),
            np.broadcast_to(a_shift, (h, w)), use_above,
            np.broadcast_to(l_base, (h, w)),
            np.broadcast_to(l_shift, (h, w)))


@functools.lru_cache(maxsize=None)
def _dr_maps_z3(w, h, p_angle, ul):
    dy = dr_deriv_dy(p_angle)
    i = np.arange(h).reshape(h, 1)
    j = np.arange(w).reshape(1, w)
    idx = (j + 1) * dy
    base = (idx >> (6 - ul)) + (i << ul)
    shift = ((idx << ul) >> 1) & 0x1F
    shift = np.broadcast_to(shift, (h, w))
    return base, shift, None


def filter_intra_pred(fi_mode: int, above: np.ndarray, left: np.ndarray,
                      above_left: int, w: int, h: int,
                      bd: int = 8) -> np.ndarray:
    """Filter-intra prediction (spec 7.11.6 / ref filterintra_c.c:70-110)."""
    taps = _tables()["filter_intra_taps"][fi_mode]
    hi = (1 << bd) - 1
    buf = np.zeros((h + 1, w + 1), np.int32)
    buf[0, 0] = above_left
    buf[0, 1:w + 1] = above[:w]
    buf[1:h + 1, 0] = left[:h]
    for r in range(1, h + 1, 2):
        for c in range(1, w + 1, 4):
            p = [buf[r - 1][c - 1], buf[r - 1][c], buf[r - 1][c + 1] if c + 1 <= w else buf[r - 1][w],
                 buf[r - 1][c + 2] if c + 2 <= w else buf[r - 1][w],
                 buf[r - 1][c + 3] if c + 3 <= w else buf[r - 1][w],
                 buf[r][c - 1], buf[r + 1][c - 1] if r + 1 <= h else buf[h][c - 1]]
            for k in range(8):
                ro, co = k >> 2, k & 3
                s = sum(int(taps[k][t]) * int(p[t]) for t in range(7))
                val = (s + (1 << 3)) >> 4 if s >= 0 else -((-s + (1 << 3)) >> 4)
                buf[r + ro][c + co] = np.clip(val, 0, hi)
    return buf[1:h + 1, 1:w + 1].copy()


def cfl_pred(dc_pred_block: np.ndarray, luma_ac: np.ndarray, alpha_q3: int,
             bd: int = 8) -> np.ndarray:
    """CfL prediction: dc + Round2Signed(alpha * luma_ac, 6) (spec 7.11.5)."""
    hi = (1 << bd) - 1
    prod = alpha_q3 * luma_ac.astype(np.int64)
    adj = np.where(prod >= 0, (prod + 32) >> 6, -((-prod + 32) >> 6))
    return np.clip(dc_pred_block.astype(np.int64) + adj, 0, hi).astype(np.int32)


def cfl_luma_ac(luma_recon_block: np.ndarray, w: int, h: int) -> np.ndarray:
    """Subsampled luma (420) minus average, Q3 (spec 7.11.5.2/7.11.5.3).

    luma_recon_block: (2h, 2w) luma recon covering the chroma block."""
    l = luma_recon_block.astype(np.int32)
    t = (l[0::2, 0::2] + l[0::2, 1::2] + l[1::2, 0::2] + l[1::2, 1::2]) << 1
    n = w * h
    avg = (int(t.sum()) + (n >> 1)) >> int(np.log2(n))
    return t - avg


def predict(mode: int, above, left, above_left: int, w: int, h: int,
            have_above: bool, have_left: bool, bd: int = 8) -> np.ndarray:
    """Dispatch over the supported (non-directional) intra modes."""
    m = PredMode(mode)
    if m == PredMode.DC_PRED:
        return dc_pred(above, left, w, h, have_above, have_left, bd)
    if m == PredMode.V_PRED:
        return v_pred(above, left, w, h)
    if m == PredMode.H_PRED:
        return h_pred(above, left, w, h)
    if m == PredMode.SMOOTH_PRED:
        return smooth_pred(above, left, w, h)
    if m == PredMode.SMOOTH_V_PRED:
        return smooth_v_pred(above, left, w, h)
    if m == PredMode.SMOOTH_H_PRED:
        return smooth_h_pred(above, left, w, h)
    if m == PredMode.PAETH_PRED:
        return paeth_pred(above, left, above_left, w, h)
    raise NotImplementedError(f"mode {m} arrives with the directional pass")


SUPPORTED_MODES = (PredMode.DC_PRED, PredMode.V_PRED, PredMode.H_PRED,
                   PredMode.SMOOTH_PRED, PredMode.SMOOTH_V_PRED,
                   PredMode.SMOOTH_H_PRED, PredMode.PAETH_PRED)
