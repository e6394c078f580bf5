"""Normative AV1 in-loop deblocking filter (spec 7.14).

Vectorized numpy implementation: for each plane and direction, edges are
walked in 4-px steps; all sample lines crossing one edge segment are
filtered as a batch. Kernel/mask semantics mirror the reference's C kernels
(ref deblocking_common.c svt_aom_lpf_*_c) and edge/parameter derivation
(ref deblocking_filter.c set_lpf_parameters), property-tested bit-exact.

Intra-only simplification: the inter skip short-circuit never triggers
(skip && is_inter == false for intra blocks), so every tx edge with a
nonzero level is filtered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


# --- threshold derivation (ref av1_update_sharpness) ------------------------

def filter_thresholds(level: int, sharpness: int):
    """(blimit, limit, hev_thr) for one filter level."""
    shift = 2 if sharpness > 4 else (1 if sharpness > 0 else 0)
    limit = level >> shift
    if sharpness > 0:
        limit = min(limit, 9 - sharpness)
    limit = max(limit, 1)
    blimit = 2 * (level + 2) + limit
    hev = level >> 4
    return blimit, limit, hev


# --- sample classification (ref filter_mask* / flat_mask*) ------------------

def _filter_mask2(limit, blimit, p1, p0, q0, q1):
    m = (np.abs(p1 - p0) > limit) | (np.abs(q1 - q0) > limit)
    m |= np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2 > blimit
    return ~m


def _filter_mask3_chroma(limit, blimit, p2, p1, p0, q0, q1, q2):
    m = (np.abs(p2 - p1) > limit) | (np.abs(p1 - p0) > limit)
    m |= (np.abs(q1 - q0) > limit) | (np.abs(q2 - q1) > limit)
    m |= np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2 > blimit
    return ~m


def _filter_mask(limit, blimit, p3, p2, p1, p0, q0, q1, q2, q3):
    m = (np.abs(p3 - p2) > limit) | (np.abs(p2 - p1) > limit) | \
        (np.abs(p1 - p0) > limit)
    m |= (np.abs(q1 - q0) > limit) | (np.abs(q2 - q1) > limit) | \
         (np.abs(q3 - q2) > limit)
    m |= np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2 > blimit
    return ~m


def _flat_mask3_chroma(thresh, p2, p1, p0, q0, q1, q2):
    m = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)
    m |= (np.abs(p2 - p0) > thresh) | (np.abs(q2 - q0) > thresh)
    return ~m


def _flat_mask4(thresh, p3, p2, p1, p0, q0, q1, q2, q3):
    m = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)
    m |= (np.abs(p2 - p0) > thresh) | (np.abs(q2 - q0) > thresh)
    m |= (np.abs(p3 - p0) > thresh) | (np.abs(q3 - q0) > thresh)
    return ~m


def _r2(x):
    return (x + 4) >> 3


# --- kernels (batched over sample lines; x: (n_lines, n_samples)) -----------

def _filter4_core(mask, hev, p1, p0, q0, q1, bd=8):
    """Returns (op1, op0, oq0, oq1) int32 arrays (highbd: ref
    highbd_filter4 semantics with the 0x80<<shift offset)."""
    sh = bd - 8
    mid = 128 << sh
    lo, hi = -mid, mid - 1
    ps1 = p1 - mid
    ps0 = p0 - mid
    qs0 = q0 - mid
    qs1 = q1 - mid
    c = lambda v: np.clip(v, lo, hi)
    f = np.where(hev, c(ps1 - qs1), 0)
    f = c(f + 3 * (qs0 - ps0))
    f = np.where(mask, f, 0)
    f1 = c(f + 4) >> 3
    f2 = c(f + 3) >> 3
    oq0 = np.clip(qs0 - f1, lo, hi) + mid
    op0 = np.clip(ps0 + f2, lo, hi) + mid
    f3 = np.where(hev, 0, (f1 + 1) >> 1)
    oq1 = np.clip(qs1 - f3, lo, hi) + mid
    op1 = np.clip(ps1 + f3, lo, hi) + mid
    keep = ~mask
    return (np.where(keep, p1, op1), np.where(keep, p0, op0),
            np.where(keep, q0, oq0), np.where(keep, q1, oq1))


def filter_lines(x: np.ndarray, length: int, blimit: int, limit: int,
                 thresh: int, bd: int = 8) -> np.ndarray:
    """Filter sample lines crossing one edge.

    x: (n, 2*half) int32, columns are p(half-1)..p0 q0..q(half-1) where
    half = 7 for length 14, else length/2 rounded up to cover taps (callers
    pass half=4 for 4/6/8, half=7 for 14). Returns filtered copy.
    """
    half = x.shape[1] // 2
    P = lambda i: x[:, half - 1 - i]
    Q = lambda i: x[:, half + i]
    p0, p1 = P(0), P(1)
    q0, q1 = Q(0), Q(1)
    out = x.copy()

    ft = 1 << (bd - 8)
    if length == 4:
        mask = _filter_mask2(limit, blimit, p1, p0, q0, q1)
        hev = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)
        r = _filter4_core(mask, hev, p1, p0, q0, q1, bd)
        for i, v in zip((half - 2, half - 1, half, half + 1), r):
            out[:, i] = v
        return out

    p2, q2 = P(2), Q(2)
    if length == 6:
        mask = _filter_mask3_chroma(limit, blimit, p2, p1, p0, q0, q1, q2)
        hev = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)
        flat = _flat_mask3_chroma(ft, p2, p1, p0, q0, q1, q2)
        sel = mask & flat
        op1 = _r2(p2 * 3 + p1 * 2 + p0 * 2 + q0)
        op0 = _r2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1)
        oq0 = _r2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2)
        oq1 = _r2(p0 + q0 * 2 + q1 * 2 + q2 * 3)
        f1, f0, g0, g1 = _filter4_core(mask, hev, p1, p0, q0, q1, bd)
        out[:, half - 2] = np.where(sel, op1, f1)
        out[:, half - 1] = np.where(sel, op0, f0)
        out[:, half] = np.where(sel, oq0, g0)
        out[:, half + 1] = np.where(sel, oq1, g1)
        return out

    p3, q3 = P(3), Q(3)
    mask8 = _filter_mask(limit, blimit, p3, p2, p1, p0, q0, q1, q2, q3)
    hev = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)
    flat = _flat_mask4(ft, p3, p2, p1, p0, q0, q1, q2, q3)
    f1, f0, g0, g1 = _filter4_core(mask8, hev, p1, p0, q0, q1, bd)
    sel8 = mask8 & flat
    op2 = _r2(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0)
    op1 = _r2(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1)
    op0 = _r2(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2)
    oq0 = _r2(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3)
    oq1 = _r2(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3)
    oq2 = _r2(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3)

    if length == 8:
        out[:, half - 3] = np.where(sel8, op2, p2)
        out[:, half - 2] = np.where(sel8, op1, f1)
        out[:, half - 1] = np.where(sel8, op0, f0)
        out[:, half] = np.where(sel8, oq0, g0)
        out[:, half + 1] = np.where(sel8, oq1, g1)
        out[:, half + 2] = np.where(sel8, oq2, q2)
        return out

    # length 14
    p4, p5, p6 = P(4), P(5), P(6)
    q4, q5, q6 = Q(4), Q(5), Q(6)
    flat2 = _flat_mask4(ft, p6, p5, p4, p0, q0, q4, q5, q6)
    sel14 = sel8 & flat2
    r4 = lambda v: (v + 8) >> 4
    o = {}
    o[-6] = r4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0)
    o[-5] = r4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1)
    o[-4] = r4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 +
               q1 + q2)
    o[-3] = r4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 +
               q1 + q2 + q3)
    o[-2] = r4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 +
               q1 + q2 + q3 + q4)
    o[-1] = r4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 +
               q2 + q3 + q4 + q5)
    o[0] = r4(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 +
              q3 + q4 + q5 + q6)
    o[1] = r4(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 +
              q4 + q5 + q6 * 2)
    o[2] = r4(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 +
              q5 + q6 * 3)
    o[3] = r4(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 +
              q6 * 4)
    o[4] = r4(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5)
    o[5] = r4(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7)

    cur8 = {-3: np.where(sel8, op2, p2), -2: np.where(sel8, op1, f1),
            -1: np.where(sel8, op0, f0), 0: np.where(sel8, oq0, g0),
            1: np.where(sel8, oq1, g1), 2: np.where(sel8, oq2, q2)}
    for k in range(-6, 6):
        col = half + k          # p(-k-1) for k<0, q(k) for k>=0
        base = cur8.get(k, x[:, col])
        out[:, col] = np.where(sel14, o[k], base)
    return out


# --- frame-level driver -----------------------------------------------------

@dataclass
class LoopFilterMaps:
    """Per-4px-unit maps in each plane's subsampled grid."""
    txw: List[np.ndarray]     # tx width in px at each unit
    txh: List[np.ndarray]     # tx height in px
    skip_inter: List[np.ndarray] = None   # skip && is_inter per unit
    ox: List[np.ndarray] = None           # block origin col (units)
    oy: List[np.ndarray] = None           # block origin row (units)


def apply_loop_filter(planes: List[np.ndarray], maps: LoopFilterMaps,
                      levels, sharpness: int = 0, dims=None,
                      bd: int = 8) -> None:
    """Filter the reconstruction in place.

    planes: [y, u, v] uint/int arrays (full padded size ok; filtering uses
    map dims). levels: (y_vert, y_horz, u, v). Per plane: all vertical
    edges frame-wide (pass 0), then all horizontal edges (pass 1), matching
    the spec 7.14.1 loop order. 8-bit only (flat thresholds use 1<<(bd-8)
    with bd=8)."""
    for plane in range(3):
        lv_v = levels[0] if plane == 0 else levels[1 + plane]
        lv_h = levels[1] if plane == 0 else levels[1 + plane]
        if lv_v == 0 and lv_h == 0:
            continue
        sub = 1 if plane else 0
        txw = maps.txw[plane]
        txh = maps.txh[plane]
        rows, cols = txw.shape
        if dims is not None:
            pw, ph = dims[plane]
            cols = min(cols, (pw + 3) // 4)
            rows = min(rows, (ph + 3) // 4)
        img = planes[plane]
        # vertical edges (filter horizontally across columns)
        if lv_v:
            blimit, limit, hev = filter_thresholds(lv_v, sharpness)
            sh8 = bd - 8
            blimit <<= sh8
            limit <<= sh8
            hev <<= sh8
            for cu in range(1, cols):
                xpx = cu * 4
                cur_w = txw[:, cu]
                prev_w = txw[:, cu - 1]
                is_edge = (xpx % np.maximum(cur_w, 1)) == 0
                # mi units whose origin lies past the display dims are
                # not filtered (spec 7.14.1); mask rows past `rows`
                is_edge = is_edge.copy()
                is_edge[rows:] = False
                # inter skip blocks: interior (non-prediction-boundary) tx
                # edges between two skipped blocks are not filtered
                if maps.skip_inter is not None:
                    sk_c = maps.skip_inter[plane][:, cu]
                    sk_p = maps.skip_inter[plane][:, cu - 1]
                    pu_edge = maps.ox[plane][:, cu] == cu
                    is_edge &= (~(sk_c.astype(bool) & sk_p.astype(bool))
                                ) | pu_edge
                mn = np.minimum(cur_w, prev_w)
                if plane:
                    fl = np.where(mn >= 8, 6, 4)
                else:
                    fl = np.where(mn >= 16, 14, np.where(mn >= 8, 8, 4))
                for length in (4, 6, 8, 14):
                    units = np.nonzero(is_edge & (fl == length))[0]
                    if units.size == 0:
                        continue
                    half = 7 if length == 14 else 4
                    ridx = (units[:, None] * 4 + np.arange(4)).ravel()
                    seg = img[ridx, xpx - half:xpx + half].astype(np.int32)
                    res = filter_lines(seg, length, blimit, limit, hev, bd)
                    img[ridx, xpx - half:xpx + half] = res
        # horizontal edges
        if lv_h:
            blimit, limit, hev = filter_thresholds(lv_h, sharpness)
            sh8 = bd - 8
            blimit <<= sh8
            limit <<= sh8
            hev <<= sh8
            for ru in range(1, rows):
                ypx = ru * 4
                cur_h = txh[ru, :]
                prev_h = txh[ru - 1, :]
                is_edge = (ypx % np.maximum(cur_h, 1)) == 0
                # skip mi units past the display width (spec 7.14.1)
                is_edge = is_edge.copy()
                is_edge[cols:] = False
                if maps.skip_inter is not None:
                    sk_c = maps.skip_inter[plane][ru, :]
                    sk_p = maps.skip_inter[plane][ru - 1, :]
                    pu_edge = maps.oy[plane][ru, :] == ru
                    is_edge &= (~(sk_c.astype(bool) & sk_p.astype(bool))
                                ) | pu_edge
                mn = np.minimum(cur_h, prev_h)
                if plane:
                    fl = np.where(mn >= 8, 6, 4)
                else:
                    fl = np.where(mn >= 16, 14, np.where(mn >= 8, 8, 4))
                for length in (4, 6, 8, 14):
                    units = np.nonzero(is_edge & (fl == length))[0]
                    if units.size == 0:
                        continue
                    half = 7 if length == 14 else 4
                    cidx = (units[:, None] * 4 + np.arange(4)).ravel()
                    seg = img[ypx - half:ypx + half, cidx].astype(np.int32).T
                    res = filter_lines(seg, length, blimit, limit, hev, bd)
                    img[ypx - half:ypx + half, cidx] = res.T
