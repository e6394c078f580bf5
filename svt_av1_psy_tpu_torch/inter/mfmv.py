"""Motion field motion vectors (MFMV): saved per-frame motion fields and
the projection into the current frame (spec 7.9 / 7.20).

Behavioral targets (re-derived, vectorized with numpy):
  - storage:    ref md_config_process.c (av1_copy_frame_mvs semantics):
                one (ref, mv) per 8x8, second-slot wins, only refs on the
                PAST side, |mv| <= REFMVS_LIMIT
  - projection: ref md_config_process.c:437 motion_field_projection /
                :505 av1_setup_motion_field (frame order: LAST backward,
                BWD/ALT2/ALT forward, LAST2 backward, capped at
                MFMV_STACK_SIZE=3 projections)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from svt_av1_psy_tpu_torch.inter.mvref import DIV_MULT, MAX_FRAME_DISTANCE

REFMVS_LIMIT = (1 << 12) - 1
MFMV_STACK_SIZE = 3


@dataclass
class SavedMotionField:
    """Per-frame stored motion field (one entry per 8x8)."""
    ref: np.ndarray          # (n8r, n8c) int8: 1..7, 0 = none
    mv: np.ndarray           # (n8r, n8c, 2) int16 (row, col) 1/8 px
    order_hint: int
    ref_hints: List[int]     # the frame's own 7 ref order hints
    is_intra: bool
    mi_rows: int
    mi_cols: int


def _rel_dist(a: int, b: int, bits: int) -> int:
    if bits <= 0:
        return 0
    d = a - b
    m = 1 << (bits - 1)
    return (d & (m - 1)) - (d & m)


def save_motion_field(grids, mi_rows: int, mi_cols: int, order_hint: int,
                      ref_hints, cur_hints, bits: int,
                      is_intra: bool) -> SavedMotionField:
    """Build the frame's saved field from the tile parsers' mi grids.

    grids: list of (MiGrid, (r0, r1, c0, c1)). Per 8x8 the representative
    mi is the odd position (r|1, c|1); for each ref slot in order the
    LAST valid past-side ref wins (av1_copy_frame_mvs loop order)."""
    n8r, n8c = (mi_rows + 1) >> 1, (mi_cols + 1) >> 1
    mref = np.zeros((n8r, n8c), np.int8)
    mmv = np.zeros((n8r, n8c, 2), np.int16)
    if is_intra:
        return SavedMotionField(mref, mmv, order_hint, list(ref_hints),
                                True, mi_rows, mi_cols)
    # side[ref] != 0 for future/same-hint refs -> not stored
    side = [0] * 8
    for k in range(7):
        d = _rel_dist(cur_hints[k], order_hint, bits)
        if d > 0:
            side[k + 1] = 1
        elif cur_hints[k] == order_hint:
            side[k + 1] = -1
    past = np.array([False] + [side[k] == 0 for k in range(1, 8)])

    for grid, (r0, r1, c0, c1) in grids:
        rr = np.minimum(np.arange(r0 | 1, r1, 2), mi_rows - 1)
        cc = np.minimum(np.arange(c0 | 1, c1, 2), mi_cols - 1)
        if len(rr) == 0 or len(cc) == 0:
            continue
        i8 = rr[:, None] >> 1
        j8 = cc[None, :] >> 1
        for refs, mvs in ((grid.ref0, grid.mv0), (grid.ref1, grid.mv1)):
            rf = np.asarray(refs)[np.ix_(rr, cc)].astype(np.int64)
            mv = np.asarray(mvs)[np.ix_(rr, cc)].astype(np.int64)
            ok = (rf > 0) & past[np.clip(rf, 0, 7)] & \
                (np.abs(mv[..., 0]) <= REFMVS_LIMIT) & \
                (np.abs(mv[..., 1]) <= REFMVS_LIMIT)
            bi = np.broadcast_to(i8, ok.shape)[ok]
            bj = np.broadcast_to(j8, ok.shape)[ok]
            mref[bi, bj] = rf[ok]
            mmv[bi, bj] = mv[ok]
    return SavedMotionField(mref, mmv, order_hint, list(ref_hints), False,
                            mi_rows, mi_cols)


def _project_one(tpl_mv, tpl_off, tpl_valid, sf: SavedMotionField,
                 cur_hint: int, bits: int, direction: int) -> bool:
    """motion_field_projection for one start frame; returns True when the
    projection counted toward the MFMV_STACK budget."""
    if sf is None or sf.is_intra:
        return False
    n8r, n8c = tpl_valid.shape
    if ((sf.mi_rows + 1) >> 1, (sf.mi_cols + 1) >> 1) != (n8r, n8c):
        return False
    s2c = _rel_dist(sf.order_hint, cur_hint, bits)
    if direction == 2:
        s2c = -s2c
    ref_off = np.zeros(8, np.int64)
    for k in range(7):
        ref_off[k + 1] = _rel_dist(sf.order_hint, sf.ref_hints[k], bits)

    rf = sf.ref.astype(np.int64)
    roff = ref_off[np.clip(rf, 0, 7)]
    valid = (rf > 0) & (np.abs(roff) <= MAX_FRAME_DISTANCE) & \
        (roff > 0) & (abs(s2c) <= MAX_FRAME_DISTANCE)
    if not valid.any():
        return True
    mv = sf.mv.astype(np.int64)
    # get_mv_projection, vectorized
    den = np.minimum(roff, MAX_FRAME_DISTANCE)
    num = min(s2c, MAX_FRAME_DISTANCE) if s2c > 0 \
        else max(s2c, -MAX_FRAME_DISTANCE)
    dm = np.array(DIV_MULT, np.int64)[np.clip(den, 0, 31)]
    prod_r = mv[..., 0] * num * dm
    prod_c = mv[..., 1] * num * dm

    def rps(v):
        return np.where(v >= 0, (v + (1 << 13)) >> 14,
                        -((-v + (1 << 13)) >> 14))

    pr = np.clip(rps(prod_r), -(1 << 14) + 1, (1 << 14) - 1)
    pc = np.clip(rps(prod_c), -(1 << 14) + 1, (1 << 14) - 1)
    # get_block_position: 8px-unit offsets, sign per direction
    ro = np.where(pr >= 0, pr >> 6, -((-pr) >> 6))
    co = np.where(pc >= 0, pc >> 6, -((-pc) >> 6))
    blk_r = np.arange(n8r)[:, None]
    blk_c = np.arange(n8c)[None, :]
    if (direction >> 1) == 1:
        row = blk_r - ro
        col = blk_c - co
    else:
        row = blk_r + ro
        col = blk_c + co
    base_r = (blk_r >> 3) << 3
    base_c = (blk_c >> 3) << 3
    # MAX_OFFSET_HEIGHT = 0, MAX_OFFSET_WIDTH = 64 (8 in 8px units)
    pos_ok = (row >= 0) & (row < n8r) & (col >= 0) & (col < n8c) & \
        (row >= base_r) & (row < base_r + 8) & \
        (col >= base_c - 8) & (col < base_c + 16)
    valid &= pos_ok
    if not valid.any():
        return True
    # scatter in raster order of the source blocks (later writes win,
    # matching the reference's sequential store loop)
    tr = np.broadcast_to(row, valid.shape)[valid]
    tc = np.broadcast_to(col, valid.shape)[valid]
    tpl_mv[tr, tc, 0] = sf.mv[..., 0][valid]
    tpl_mv[tr, tc, 1] = sf.mv[..., 1][valid]
    tpl_off[tr, tc] = roff[valid]
    tpl_valid[tr, tc] = True
    return True


def setup_motion_field(slots: List[Optional[SavedMotionField]],
                       ref_frame_idx, cur_hint: int, bits: int,
                       mi_rows: int, mi_cols: int):
    """av1_setup_motion_field: project up to MFMV_STACK_SIZE reference
    motion fields into the current frame. slots/ref_frame_idx follow the
    decoder DPB; returns (mv, off, valid) arrays for the tile parsers."""
    n8r, n8c = (mi_rows + 1) >> 1, (mi_cols + 1) >> 1
    tpl_mv = np.zeros((n8r, n8c, 2), np.int16)
    tpl_off = np.zeros((n8r, n8c), np.int16)
    tpl_valid = np.zeros((n8r, n8c), bool)

    def sf(ref):                      # ref 1..7
        s = slots[ref_frame_idx[ref - 1]]
        return s

    hints = [sf(r).order_hint if sf(r) is not None else 0
             for r in range(1, 8)]
    ref_stamp = MFMV_STACK_SIZE - 1
    if sf(1) is not None:
        # skip LAST when it is the overlay of GOLDEN's altref
        alt_of_lst = sf(1).ref_hints[6]
        if alt_of_lst != hints[3]:
            _project_one(tpl_mv, tpl_off, tpl_valid, sf(1), cur_hint,
                         bits, 2)
        ref_stamp -= 1
    if _rel_dist(hints[4], cur_hint, bits) > 0:       # BWDREF
        if _project_one(tpl_mv, tpl_off, tpl_valid, sf(5), cur_hint,
                        bits, 0):
            ref_stamp -= 1
    if _rel_dist(hints[5], cur_hint, bits) > 0:       # ALTREF2
        if _project_one(tpl_mv, tpl_off, tpl_valid, sf(6), cur_hint,
                        bits, 0):
            ref_stamp -= 1
    if _rel_dist(hints[6], cur_hint, bits) > 0 and ref_stamp >= 0:
        if _project_one(tpl_mv, tpl_off, tpl_valid, sf(7), cur_hint,
                        bits, 0):
            ref_stamp -= 1
    if ref_stamp >= 0:
        _project_one(tpl_mv, tpl_off, tpl_valid, sf(2), cur_hint, bits, 2)
    return tpl_mv, tpl_off, tpl_valid
