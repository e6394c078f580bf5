"""Motion-compensated prediction: normative subpel interpolation (spec
7.11.3) for translational single-reference inter blocks.

Semantics mirror the reference C (ref inter_prediction.c
svt_av1_convolve_2d_sr_c / _x_sr_c / _y_sr_c / _2d_copy_sr_c), vectorized
with numpy; reference fetch uses per-sample coordinate clamping (spec
7.11.3.3), so arbitrary MVs are legal. 8-bit single-ref path (round_0=3,
round_1=11).
"""
from __future__ import annotations

import numpy as np

FILTER_BITS = 7
ROUND0 = 3
ROUND1 = 11

# Subpel_Filters (spec 7.11.3.4): REGULAR, SMOOTH, SHARP, then the short
# variants used for 4-wide blocks + bilinear.
_F_REGULAR = [
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 2, -6, 126, 8, -2, 0, 0],
    [0, 2, -10, 122, 18, -4, 0, 0], [0, 2, -12, 116, 28, -8, 2, 0],
    [0, 2, -14, 110, 38, -10, 2, 0], [0, 2, -14, 102, 48, -12, 2, 0],
    [0, 2, -16, 94, 58, -12, 2, 0], [0, 2, -14, 84, 66, -12, 2, 0],
    [0, 2, -14, 76, 76, -14, 2, 0], [0, 2, -12, 66, 84, -14, 2, 0],
    [0, 2, -12, 58, 94, -16, 2, 0], [0, 2, -12, 48, 102, -14, 2, 0],
    [0, 2, -10, 38, 110, -14, 2, 0], [0, 2, -8, 28, 116, -12, 2, 0],
    [0, 0, -4, 18, 122, -10, 2, 0], [0, 0, -2, 8, 126, -6, 2, 0]]
_F_SMOOTH = [
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 2, 28, 62, 34, 2, 0, 0],
    [0, 0, 26, 62, 36, 4, 0, 0], [0, 0, 22, 62, 40, 4, 0, 0],
    [0, 0, 20, 60, 42, 6, 0, 0], [0, 0, 18, 58, 44, 8, 0, 0],
    [0, 0, 16, 56, 46, 10, 0, 0], [0, -2, 16, 54, 48, 12, 0, 0],
    [0, -2, 14, 52, 52, 14, -2, 0], [0, 0, 12, 48, 54, 16, -2, 0],
    [0, 0, 10, 46, 56, 16, 0, 0], [0, 0, 8, 44, 58, 18, 0, 0],
    [0, 0, 6, 42, 60, 20, 0, 0], [0, 0, 4, 40, 62, 22, 0, 0],
    [0, 0, 4, 36, 62, 26, 0, 0], [0, 0, 2, 34, 62, 28, 2, 0]]
_F_SHARP = [
    [0, 0, 0, 128, 0, 0, 0, 0], [-2, 2, -6, 126, 8, -2, 2, 0],
    [-2, 6, -12, 124, 16, -6, 4, -2], [-2, 8, -18, 120, 26, -10, 6, -2],
    [-4, 10, -22, 116, 38, -14, 6, -2], [-4, 10, -22, 108, 48, -18, 8, -2],
    [-4, 10, -24, 100, 60, -20, 8, -2], [-4, 10, -24, 90, 70, -22, 10, -2],
    [-4, 12, -24, 80, 80, -24, 12, -4], [-2, 10, -22, 70, 90, -24, 10, -4],
    [-2, 8, -20, 60, 100, -24, 10, -4], [-2, 8, -18, 48, 108, -22, 10, -4],
    [-2, 6, -14, 38, 116, -22, 10, -4], [-2, 6, -10, 26, 120, -18, 8, -2],
    [-2, 4, -6, 16, 124, -12, 6, -2], [0, 2, -2, 8, 126, -6, 2, -2]]
_F_REGULAR4 = [
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, -4, 126, 8, -2, 0, 0],
    [0, 0, -8, 122, 18, -4, 0, 0], [0, 0, -10, 116, 28, -6, 0, 0],
    [0, 0, -12, 110, 38, -8, 0, 0], [0, 0, -12, 102, 48, -10, 0, 0],
    [0, 0, -14, 94, 58, -10, 0, 0], [0, 0, -12, 84, 66, -10, 0, 0],
    [0, 0, -12, 76, 76, -12, 0, 0], [0, 0, -10, 66, 84, -12, 0, 0],
    [0, 0, -10, 58, 94, -14, 0, 0], [0, 0, -10, 48, 102, -12, 0, 0],
    [0, 0, -8, 38, 110, -12, 0, 0], [0, 0, -6, 28, 116, -10, 0, 0],
    [0, 0, -4, 18, 122, -8, 0, 0], [0, 0, -2, 8, 126, -4, 0, 0]]
_F_SMOOTH4 = [
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, 30, 62, 34, 2, 0, 0],
    [0, 0, 26, 62, 36, 4, 0, 0], [0, 0, 22, 62, 40, 4, 0, 0],
    [0, 0, 20, 60, 42, 6, 0, 0], [0, 0, 18, 58, 44, 8, 0, 0],
    [0, 0, 16, 56, 46, 10, 0, 0], [0, 0, 14, 54, 48, 12, 0, 0],
    [0, 0, 12, 52, 52, 12, 0, 0], [0, 0, 12, 48, 54, 14, 0, 0],
    [0, 0, 10, 46, 56, 16, 0, 0], [0, 0, 8, 44, 58, 18, 0, 0],
    [0, 0, 6, 42, 60, 20, 0, 0], [0, 0, 4, 40, 62, 22, 0, 0],
    [0, 0, 4, 36, 62, 26, 0, 0], [0, 0, 2, 34, 62, 30, 0, 0]]
_F_BILINEAR = [[0, 0, 0, 128, 0, 0, 0, 0]] + [
    [0, 0, 0, 128 - 8 * i, 8 * i, 0, 0, 0] for i in range(1, 16)]

_TABLES = {
    0: np.array(_F_REGULAR, np.int32),   # EIGHTTAP_REGULAR
    1: np.array(_F_SMOOTH, np.int32),    # EIGHTTAP_SMOOTH
    2: np.array(_F_SHARP, np.int32),     # MULTITAP_SHARP
    3: np.array(_F_BILINEAR, np.int32),  # BILINEAR
}
_TABLES4 = {
    0: np.array(_F_REGULAR4, np.int32),
    1: np.array(_F_SMOOTH4, np.int32),
    2: np.array(_F_REGULAR4, np.int32),
    3: np.array(_F_BILINEAR, np.int32),
}


def get_filter_kernel(interp_filter: int, dim: int, subpel: int):
    """Kernel row for one direction (ref
    av1_get_interp_filter_params_with_block_size: 4-tap variants when the
    block dimension is <= 4)."""
    tab = _TABLES4 if dim <= 4 else _TABLES
    return tab[interp_filter][subpel]


def _gather(ref: np.ndarray, ys, xs):
    H, W = ref.shape
    return ref[np.clip(ys, 0, H - 1)[:, None],
               np.clip(xs, 0, W - 1)[None, :]].astype(np.int32)


def _round2(v, n):
    return (v + (1 << (n - 1))) >> n


COMPOUND_ROUND1 = 7                     # spec round_1 for compound


def mc_block_compound_part(ref: np.ndarray, px: int, py: int, w: int,
                           h: int, mvx_q4: int, mvy_q4: int,
                           interp_x: int, interp_y: int,
                           bd: int = 8) -> np.ndarray:
    """One compound prediction component at intermediate precision (the
    CONV_BUF value incl. round_offset; ref inter_prediction.c
    svt_av1_jnt_convolve_2d_c / _x_c / _y_c / _2d_copy_c). Blend two of
    these with blend_compound. round_0=3, round_1=7."""
    r0, r1 = ROUND0, COMPOUND_ROUND1
    offset_bits = bd + 2 * FILTER_BITS - r0
    round_offset = (1 << (offset_bits - r1)) + \
        (1 << (offset_bits - r1 - 1))
    x0 = px + (mvx_q4 >> 4)
    y0 = py + (mvy_q4 >> 4)
    sx = mvx_q4 & 15
    sy = mvy_q4 & 15
    if sx == 0 and sy == 0:
        reg = _gather(ref, np.arange(y0, y0 + h), np.arange(x0, x0 + w))
        bits = 2 * FILTER_BITS - r0 - r1
        return (reg << bits) + round_offset
    fx = get_filter_kernel(interp_x, w, sx)
    fy = get_filter_kernel(interp_y, h, sy)
    if sx and sy:
        reg = _gather(ref, np.arange(y0 - 3, y0 + h + 4),
                      np.arange(x0 - 3, x0 + w + 4))
        im = (1 << (bd + FILTER_BITS - 1)) + sum(
            int(fx[k]) * reg[:, k:k + w] for k in range(8))
        im = _round2(im, r0)
        sm = (1 << offset_bits) + sum(
            int(fy[k]) * im[k:k + h, :] for k in range(8))
        return _round2(sm, r1)
    if sx:
        reg = _gather(ref, np.arange(y0, y0 + h),
                      np.arange(x0 - 3, x0 + w + 4))
        res = _round2(sum(int(fx[k]) * reg[:, k:k + w] for k in range(8)),
                      r0)
        return (res << (FILTER_BITS - r1)) + round_offset
    reg = _gather(ref, np.arange(y0 - 3, y0 + h + 4),
                  np.arange(x0, x0 + w))
    res = sum(int(fy[k]) * reg[k:k + h, :] for k in range(8))
    res = res << (FILTER_BITS - r0)
    return _round2(res, r1) + round_offset


def blend_compound(p0: np.ndarray, p1: np.ndarray, bd: int = 8,
                   fwd_offset: int = 0, bck_offset: int = 0) -> np.ndarray:
    """Average (or dist-wtd) blend of two CONV_BUF components + final
    rounding (ref jnt convolve do_average branch)."""
    r0, r1 = ROUND0, COMPOUND_ROUND1
    offset_bits = bd + 2 * FILTER_BITS - r0
    round_bits = 2 * FILTER_BITS - r0 - r1
    if fwd_offset:
        tmp = (p0 * fwd_offset + p1 * bck_offset) >> 4
    else:
        tmp = (p0 + p1) >> 1
    tmp = tmp - ((1 << (offset_bits - r1)) +
                 (1 << (offset_bits - r1 - 1)))
    return np.clip(_round2(tmp, round_bits), 0, (1 << bd) - 1)


_QUANT_DIST_WEIGHT = ((2, 3), (2, 5), (2, 7), (1, 31))
_QUANT_DIST_LOOKUP = ((9, 7), (11, 5), (12, 4), (13, 3))


def dist_wtd_weights(d0: int, d1: int):
    """(fwd_offset, bck_offset) for compound_idx == 0 (spec 7.11.3.15;
    ref svt_av1_dist_wtd_comp_weight_assign, order_idx = 0). d0 =
    |dist(ref1 hint, cur)|, d1 = |dist(cur, ref0 hint)|, both clamped
    to MAX_FRAME_DISTANCE before the call."""
    order = int(d0 <= d1)
    if d0 == 0 or d1 == 0:
        return (_QUANT_DIST_LOOKUP[3][order],
                _QUANT_DIST_LOOKUP[3][1 - order])
    for i in range(3):
        c0 = _QUANT_DIST_WEIGHT[i][order]
        c1 = _QUANT_DIST_WEIGHT[i][1 - order]
        if (d0 > d1 and d0 * c0 < d1 * c1) or \
                (d0 <= d1 and d0 * c0 > d1 * c1):
            break
    else:
        i = 3
    return (_QUANT_DIST_LOOKUP[i][order],
            _QUANT_DIST_LOOKUP[i][1 - order])


def mc_block(ref: np.ndarray, px: int, py: int, w: int, h: int,
             mvx_q4: int, mvy_q4: int, interp_x: int, interp_y: int,
             bd: int = 8) -> np.ndarray:
    """Predict a w x h block at plane position (px, py) from `ref` with a
    1/16-pel MV (already plane-scaled). Returns (h, w) int32."""
    x0 = px + (mvx_q4 >> 4)
    y0 = py + (mvy_q4 >> 4)
    sx = mvx_q4 & 15
    sy = mvy_q4 & 15
    hi = (1 << bd) - 1
    if sx == 0 and sy == 0:
        return _gather(ref, np.arange(y0, y0 + h), np.arange(x0, x0 + w))
    fx = get_filter_kernel(interp_x, w, sx)
    fy = get_filter_kernel(interp_y, h, sy)
    if sx and sy:
        reg = _gather(ref, np.arange(y0 - 3, y0 + h + 4),
                      np.arange(x0 - 3, x0 + w + 4))
        im = (1 << (bd + FILTER_BITS - 1)) + sum(
            int(fx[k]) * reg[:, k:k + w] for k in range(8))
        im = _round2(im, ROUND0)
        offset_bits = bd + 2 * FILTER_BITS - ROUND0
        sm = (1 << offset_bits) + sum(
            int(fy[k]) * im[k:k + h, :] for k in range(8))
        res = _round2(sm, ROUND1) - ((1 << (offset_bits - ROUND1)) +
                                     (1 << (offset_bits - ROUND1 - 1)))
        bits = 2 * FILTER_BITS - ROUND0 - ROUND1
        return np.clip(_round2(res, bits) if bits > 0 else res, 0, hi)
    if sx:
        reg = _gather(ref, np.arange(y0, y0 + h),
                      np.arange(x0 - 3, x0 + w + 4))
        sm = sum(int(fx[k]) * reg[:, k:k + w] for k in range(8))
        sm = _round2(sm, ROUND0)
        return np.clip(_round2(sm, FILTER_BITS - ROUND0), 0, hi)
    reg = _gather(ref, np.arange(y0 - 3, y0 + h + 4),
                  np.arange(x0, x0 + w))
    sm = sum(int(fy[k]) * reg[k:k + h, :] for k in range(8))
    return np.clip(_round2(sm, FILTER_BITS), 0, hi)
