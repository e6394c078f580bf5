"""MV reference-stack construction (spec 7.10.2, ref adaptive_mv_pred.c
setup_ref_mv_list).

Python-side stack builder used by the slow path and the decoder.
Supports global motion and temporal MVP (MFMV) candidates — the native
C walk (native/inter_backend.c) mirrors the same derivation for the
fast path, including the temporal candidates fed from
inter/mfmv.setup_motion_field. The stack, weights, and the
new/global/ref mode-context derivation must match the reference exactly;
transcode identity over reference-encoded inter streams pins this.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

MV_BORDER = 4 << 5              # 128, in 1/8 px
REF_CAT_LEVEL = 640
MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
MVREF_ROW_COLS = 3
INTRA_FRAME = 0
NONE_FRAME = -1


@dataclass
class MiGrid:
    """Per-4x4-unit mode info of the frame being coded (decode order)."""
    mi_rows: int
    mi_cols: int
    # tile bounds (mi units): availability and candidate scans never cross
    # these (spec 5.11.x is_inside / MiColStart..MiColEnd). Defaults = the
    # whole frame, i.e. single-tile behavior.
    row_start: int = 0
    col_start: int = 0
    row_end: int = -1
    col_end: int = -1

    def __post_init__(self):
        if self.row_end < 0:
            self.row_end = self.mi_rows
        if self.col_end < 0:
            self.col_end = self.mi_cols
        shape = (self.mi_rows, self.mi_cols)
        self.ref0 = np.full(shape, NONE_FRAME, np.int8)
        self.ref1 = np.full(shape, NONE_FRAME, np.int8)
        self.mv0 = np.zeros(shape + (2,), np.int16)     # (row, col) 1/8 px
        self.mv1 = np.zeros(shape + (2,), np.int16)
        self.newmv = np.zeros(shape, np.uint8)           # mode has NEWMV
        self.bsize = np.zeros(shape, np.uint8)
        self.partition = np.zeros(shape, np.uint8)
        self.filters = np.zeros(shape + (2,), np.uint8)
        # compound syntax neighbor state (spec comp_group_idx /
        # compound_idx contexts)
        self.comp_group = np.zeros(shape, np.uint8)
        self.cmp_idx = np.ones(shape, np.uint8)
        self.ibc = np.zeros(shape, np.uint8)     # use_intrabc blocks
        # mode was GLOBALMV / GLOBAL_GLOBALMV: under a non-translational
        # gm these neighbors contribute the CURRENT block's global mv to
        # the candidate stack (spec 7.10.2.7 add_ref_mv_candidate)
        self.gmv = np.zeros(shape, np.uint8)

    _FIELDS = ("ref0", "ref1", "mv0", "mv1", "newmv", "bsize",
               "partition", "filters", "comp_group", "cmp_idx", "ibc",
               "gmv")

    def snapshot(self, r, c, h4, w4):
        sl = (slice(r, r + h4), slice(c, c + w4))
        return (r, c, tuple(getattr(self, a)[sl].copy()
                            for a in self._FIELDS))

    def restore(self, snap):
        r, c, arrs = snap
        for a, v in zip(self._FIELDS, arrs):
            getattr(self, a)[r:r + v.shape[0], c:c + v.shape[1]] = v

    def set_block(self, r, c, h4, w4, bsize, ref0, ref1, mv0, mv1,
                  has_newmv, partition=0, filters=(0, 0),
                  comp_group=0, cmp_idx=1, is_gmv=0):
        self.ref0[r:r + h4, c:c + w4] = ref0
        self.ref1[r:r + h4, c:c + w4] = ref1
        self.mv0[r:r + h4, c:c + w4] = mv0
        self.mv1[r:r + h4, c:c + w4] = mv1
        self.newmv[r:r + h4, c:c + w4] = int(has_newmv)
        self.bsize[r:r + h4, c:c + w4] = bsize
        self.partition[r:r + h4, c:c + w4] = partition
        self.filters[r:r + h4, c:c + w4] = filters
        self.comp_group[r:r + h4, c:c + w4] = comp_group
        self.cmp_idx[r:r + h4, c:c + w4] = cmp_idx
        self.gmv[r:r + h4, c:c + w4] = int(is_gmv)


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


class MvRefs:
    """Result of setup_ref_mv_list for one (block, ref pair)."""

    def __init__(self):
        self.stack: List[Tuple[int, int]] = []    # (row, col) per candidate
        self.stack2: List[Tuple[int, int]] = []   # comp_mv (compound only)
        self.weights: List[int] = []
        self.mode_context = 0

    n_found = 0     # NumMvFound (gm fills excluded)

    @property
    def count(self):
        return self.n_found

    @property
    def newmv_ctx(self):
        return self.mode_context & 7

    @property
    def refmv_ctx(self):
        return (self.mode_context >> 4) & 15

    @property
    def zeromv_ctx(self):
        return (self.mode_context >> 3) & 1


def _bsize_dims(bsize):
    from svt_av1_psy_tpu_torch.constants import BLOCK_SIZE_HIGH, BLOCK_SIZE_WIDE
    return BLOCK_SIZE_WIDE[bsize] // 4, BLOCK_SIZE_HIGH[bsize] // 4


# Div_Mult (spec 7.9.3; ref mcomp.c div_mult): 16384/d rounded
DIV_MULT = (0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820,
            1638, 1489, 1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819,
            780, 744, 712, 682, 655, 630, 606, 585, 564, 546, 528)
MAX_FRAME_DISTANCE = 31
_MV_MAX = (1 << 14) - 1


def _round2_signed(v: int, n: int) -> int:
    if v >= 0:
        return (v + (1 << (n - 1))) >> n
    return -((-v + (1 << (n - 1))) >> n)


def mv_projection(mv, num: int, den: int):
    """get_mv_projection (spec 7.9.3): scale mv by num/den with the
    Div_Mult reciprocal table."""
    den = min(den, MAX_FRAME_DISTANCE)
    num = min(num, MAX_FRAME_DISTANCE) if num > 0 \
        else max(num, -MAX_FRAME_DISTANCE)
    r = _clamp(_round2_signed(int(mv[0]) * num * DIV_MULT[den], 14),
               -_MV_MAX, _MV_MAX)
    c = _clamp(_round2_signed(int(mv[1]) * num * DIV_MULT[den], 14),
               -_MV_MAX, _MV_MAX)
    return (r, c)


def _lower_precision(mv, allow_hp: bool):
    """lower_mv_precision with force_integer 0 (temporal candidates are
    never force-integer rounded; ref add_tpl_ref_mv passes 0)."""
    if allow_hp:
        return mv
    out = []
    for v in mv:
        if v & 1:
            v = v - 1 if v > 0 else v + 1
        out.append(v)
    return tuple(out)


def has_top_right(grid: MiGrid, mi_row: int, mi_col: int, n8_w: int,
                  n8_h: int, sb_mi: int = 16) -> int:
    """Top-right availability (spec has_top_right; shared by the MV
    stack scan and warp-sample collection)."""
    bs = max(n8_w, n8_h)
    if bs > 16:
        return 0
    if n8_w > n8_h:
        # bottom of two horizontal rects never has a TR
        if mi_row & (n8_w - 1):
            return 0
    if n8_w < n8_h:
        # left of two vertical rects always has a TR (is_sec_rect==0)
        if (mi_col + n8_w) & (n8_h - 1):
            return 1
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = 0
                break
        else:
            break
        b <<= 1
    # VERT_A bottom-left square
    if int(grid.partition[mi_row, mi_col]) == 6 and n8_w == n8_h:
        if mask_row & bs:
            return 0
    return has_tr


def setup_ref_mv_list(grid: MiGrid, mi_row: int, mi_col: int, bsize: int,
                      ref_frame: int, sb_mi: int = 16,
                      gm_mv=(0, 0), ref_frame2: int = NONE_FRAME,
                      gm_mv2=(0, 0), sign_bias=None, tpl=None,
                      ibc=False, gm_nontrans=False,
                      gm_nontrans2=False) -> MvRefs:
    """Build the MV stack (temporal mvp via `tpl`), single-ref or compound
    (ref_frame2 > INTRA_FRAME). gm_mv/gm_mv2 are the precision-lowered
    global motion vectors per component (spec 7.10.2.1 setup_global_mv)
    used for the under-full stack fill; identity (TRANSLATION type never
    routes candidates through gm — spec is_global_mv_block requires type
    > TRANSLATION). sign_bias[1..7] = RefFrameSignBias, used by the
    relaxed rescans to flip other-ref candidates pointing the other way
    (ref adaptive_mv_pred.c:457 scan_row_col_light)."""
    n8_w, n8_h = _bsize_dims(bsize)
    is_comp = ref_frame2 > INTRA_FRAME
    if sign_bias is None:
        sign_bias = [0] * 8
    mi_rows, mi_cols = grid.mi_rows, grid.mi_cols
    row_start, row_end = grid.row_start, grid.row_end
    col_start, col_end = grid.col_start, grid.col_end
    out = MvRefs()
    stack: List[List[int]] = []   # [mv0_r, mv0_c, mv1_r, mv1_c, weight]

    up_avail = mi_row > row_start
    left_avail = mi_col > col_start
    row_adj = (n8_h < 2) and (mi_row & 1)
    col_adj = (n8_w < 2) and (mi_col & 1)
    max_row_offset = 0
    max_col_offset = 0
    if up_avail:
        max_row_offset = -(MVREF_ROW_COLS << 1) + row_adj
        if n8_h < 2:
            max_row_offset = -(2 << 1) + row_adj
        max_row_offset = _clamp(max_row_offset, row_start - mi_row,
                                row_end - mi_row - 1)
    if left_avail:
        max_col_offset = -(MVREF_ROW_COLS << 1) + col_adj
        if n8_w < 2:
            max_col_offset = -(2 << 1) + col_adj
        max_col_offset = _clamp(max_col_offset, col_start - mi_col,
                                col_end - mi_col - 1)

    counts = {"row_match": 0, "col_match": 0, "newmv": 0}
    processed = {"rows": 0, "cols": 0}

    def add_candidate(r, c, len_, weight, which):
        """add_ref_mv_candidate (ref adaptive_mv_pred.c:56)."""
        if c >= col_end or r >= row_end or c < col_start or r < row_start:
            return
        if ibc:
            # intrabc DV stack (spec 7.10.2 with RefFrame = INTRA):
            # candidates are previous intrabc blocks only
            if not grid.ibc[r, c]:
                return
            mv = (int(grid.mv0[r, c, 0]), int(grid.mv0[r, c, 1]))
            for ent in stack:
                if (ent[0], ent[1]) == mv:
                    ent[4] += weight * len_
                    break
            else:
                if len(stack) < MAX_REF_MV_STACK_SIZE:
                    stack.append([mv[0], mv[1], 0, 0, weight * len_])
            counts[which] += 1
            return
        if grid.ref0[r, c] <= INTRA_FRAME:
            return
        # spec 7.10.2.7 / libaom is_global_mv_block: >=8x8 neighbors
        # coded GLOBALMV contribute the CURRENT block's global mv when
        # the component ref's GmType > TRANSLATION (the stored mv was
        # derived at the NEIGHBOR's center under ROTZOOM/AFFINE models)
        sub_gm = grid.gmv[r, c] and gm_nontrans
        if is_comp:
            if int(grid.ref0[r, c]) == ref_frame and \
                    int(grid.ref1[r, c]) == ref_frame2:
                m0 = (gm_mv if sub_gm else grid.mv0[r, c])
                m1 = (gm_mv2 if grid.gmv[r, c] and gm_nontrans2
                      else grid.mv1[r, c])
                key = (int(m0[0]), int(m0[1]), int(m1[0]), int(m1[1]))
                for ent in stack:
                    if tuple(ent[:4]) == key:
                        ent[4] += weight * len_
                        break
                else:
                    if len(stack) < MAX_REF_MV_STACK_SIZE:
                        stack.append([*key, weight * len_])
                if grid.newmv[r, c]:
                    counts["newmv"] += 1
                counts[which] += 1
            return
        for ref_i, refs in ((0, grid.ref0), (1, grid.ref1)):
            if refs[r, c] == ref_frame:
                mv = grid.mv0[r, c] if ref_i == 0 else grid.mv1[r, c]
                mv = (int(mv[0]), int(mv[1]))
                if sub_gm:
                    mv = (gm_mv[0], gm_mv[1])
                for ent in stack:
                    if (ent[0], ent[1]) == mv:
                        ent[4] += weight * len_
                        break
                else:
                    if len(stack) < MAX_REF_MV_STACK_SIZE:
                        stack.append([mv[0], mv[1], 0, 0, weight * len_])
                if grid.newmv[r, c]:
                    counts["newmv"] += 1
                counts[which] += 1

    def scan_row(row_offset):
        end_mi = min(n8_w, col_end - mi_col, 16)
        col_offset = 0
        if abs(row_offset) > 1:
            col_offset = 1
            if (mi_col & 1) and n8_w < 2:
                col_offset -= 1
        use_step_16 = n8_w >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_offset
            c = mi_col + col_offset + i
            cand_bsize = int(grid.bsize[r, c])
            cw4, ch4 = _bsize_dims(cand_bsize)
            ln = min(n8_w, cw4)
            if use_step_16:
                ln = max(4, ln)
            elif abs(row_offset) > 1:
                ln = max(ln, 2)
            weight = 2
            if n8_w >= 2 and n8_w <= cw4:
                inc = min(-max_row_offset + row_offset + 1, ch4)
                weight = max(weight, inc)
                processed["rows"] = inc - row_offset - 1
            add_candidate(r, c, ln, weight, "row_match")
            i += ln

    def scan_col(col_offset):
        end_mi = min(n8_h, row_end - mi_row, 16)
        row_offset = 0
        if abs(col_offset) > 1:
            row_offset = 1
            if (mi_row & 1) and n8_h < 2:
                row_offset -= 1
        use_step_16 = n8_h >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_offset + i
            c = mi_col + col_offset
            cand_bsize = int(grid.bsize[r, c])
            cw4, ch4 = _bsize_dims(cand_bsize)
            ln = min(n8_h, ch4)
            if use_step_16:
                ln = max(4, ln)
            elif abs(col_offset) > 1:
                ln = max(ln, 2)
            weight = 2
            if n8_h >= 2 and n8_h <= ch4:
                inc = min(-max_col_offset + col_offset + 1, cw4)
                weight = max(weight, inc)
                processed["cols"] = inc - col_offset - 1
            add_candidate(r, c, ln, weight, "col_match")
            i += ln

    def scan_blk(row_offset, col_offset):
        r = mi_row + row_offset
        c = mi_col + col_offset
        if r < row_start or c < col_start or r >= row_end or c >= col_end:
            return
        add_candidate(r, c, 2, 2, "row_match")


    if abs(max_row_offset) >= 1:
        scan_row(-1)
    if abs(max_col_offset) >= 1:
        scan_col(-1)
    if has_top_right(grid, mi_row, mi_col, n8_w, n8_h, sb_mi):
        scan_blk(-1, n8_w)

    nearest_match = (counts["row_match"] > 0) + (counts["col_match"] > 0)
    nearest_newmv = counts["newmv"]
    for ent in stack:
        ent[4] += REF_CAT_LEVEL

    # --- temporal (MFMV) candidates (spec 7.10.2; ref add_tpl_ref_mv /
    # the use_ref_frame_mvs block of setup_ref_mv_list). tpl carries the
    # current frame's projected motion field + the cur-to-ref offsets.
    gm_bit = [False]
    if tpl is not None:
        tpl_mv, tpl_off, tpl_valid, cur_off0, cur_off1, allow_hp = tpl

        def add_tpl(blk_row, blk_col):
            pos_r = blk_row if (mi_row & 1) else blk_row + 1
            pos_c = blk_col if (mi_col & 1) else blk_col + 1
            rr, cc = mi_row + pos_r, mi_col + pos_c
            if rr < row_start or rr >= row_end or \
                    cc < col_start or cc >= col_end:
                return 0
            i8, j8 = rr >> 1, cc >> 1
            if not tpl_valid[i8, j8]:
                return 0
            src = (int(tpl_mv[i8, j8, 0]), int(tpl_mv[i8, j8, 1]))
            off = int(tpl_off[i8, j8])
            this = _lower_precision(mv_projection(src, cur_off0, off),
                                    allow_hp)
            if not is_comp:
                if blk_row == 0 and blk_col == 0:
                    if abs(this[0] - gm_mv[0]) >= 16 or \
                            abs(this[1] - gm_mv[1]) >= 16:
                        gm_bit[0] = True
                for ent in stack:
                    if (ent[0], ent[1]) == this:
                        ent[4] += 2
                        break
                else:
                    if len(stack) < MAX_REF_MV_STACK_SIZE:
                        stack.append([this[0], this[1], 0, 0, 2])
                return 1
            comp = _lower_precision(mv_projection(src, cur_off1, off),
                                    allow_hp)
            if blk_row == 0 and blk_col == 0:
                if abs(this[0] - gm_mv[0]) >= 16 or \
                        abs(this[1] - gm_mv[1]) >= 16 or \
                        abs(comp[0] - gm_mv2[0]) >= 16 or \
                        abs(comp[1] - gm_mv2[1]) >= 16:
                    gm_bit[0] = True
            for ent in stack:
                if (ent[0], ent[1]) == this and (ent[2], ent[3]) == comp:
                    ent[4] += 2
                    break
            else:
                if len(stack) < MAX_REF_MV_STACK_SIZE:
                    stack.append([this[0], this[1], comp[0], comp[1], 2])
            return 1

        blk_row_end = min(n8_h, 16)
        blk_col_end = min(n8_w, 16)
        allow_ext = (2 <= n8_h < 16) and (2 <= n8_w < 16)
        step_h = 4 if n8_h >= 16 else 2
        step_w = 4 if n8_w >= 16 else 2
        is_available = 0
        for blk_row in range(0, blk_row_end, step_h):
            for blk_col in range(0, blk_col_end, step_w):
                ret = add_tpl(blk_row, blk_col)
                if blk_row == 0 and blk_col == 0:
                    is_available = ret
        if not is_available:
            gm_bit[0] = True
        if allow_ext:
            voff = max(2, n8_h)
            hoff = max(2, n8_w)
            mrow = mi_row & (sb_mi - 1)
            mcol = mi_col & (sb_mi - 1)
            for br, bc in ((voff, -2), (voff, hoff), (voff - 2, hoff)):
                # check_sb_border: stay within the current superblock
                if not (0 <= mrow + br < sb_mi and 0 <= mcol + bc < sb_mi):
                    continue
                add_tpl(br, bc)

    # top-left + outer rows/cols (newmv counter no longer updated)
    saved_newmv = counts["newmv"]
    scan_blk(-1, -1)
    for idx in range(2, MVREF_ROW_COLS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if abs(row_offset) <= abs(max_row_offset) and \
                abs(row_offset) > processed["rows"]:
            scan_row(row_offset)
        if abs(col_offset) <= abs(max_col_offset) and \
                abs(col_offset) > processed["cols"]:
            scan_col(col_offset)
    counts["newmv"] = saved_newmv

    ref_match_count = (counts["row_match"] > 0) + (counts["col_match"] > 0)
    mode_context = 0
    if nearest_match == 0:
        if ref_match_count >= 1:
            mode_context |= 1
        if ref_match_count == 1:
            mode_context |= (1 << 4)
        elif ref_match_count >= 2:
            mode_context |= (2 << 4)
    elif nearest_match == 1:
        mode_context |= 2 if nearest_newmv > 0 else 3
        if ref_match_count == 1:
            mode_context |= (3 << 4)
        elif ref_match_count >= 2:
            mode_context |= (4 << 4)
    else:
        mode_context |= 4 if nearest_newmv >= 1 else 5
        mode_context |= (5 << 4)
    if gm_bit[0]:
        mode_context |= (1 << 3)      # GLOBALMV_OFFSET

    # stable sort by weight (reference's repeated bubble pass == stable
    # descending order)
    stack.sort(key=lambda e: -e[4])

    # under-full extension (ref adaptive_mv_pred.c:457 scan_row_col_light)
    n_counted = None
    if len(stack) < MAX_MV_REF_CANDIDATES:
        mi_width = min(16, n8_w, col_end - mi_col)
        mi_height = min(16, n8_h, row_end - mi_row)
        mi_size = min(mi_width, mi_height)
        if is_comp:
            # compound: collect same-ref / sign-flipped other-ref
            # candidates per component, then combine
            ref_id = [[], []]
            ref_diff = [[], []]

            def collect(r, c):
                for ref_i in range(2):
                    refs = grid.ref0 if ref_i == 0 else grid.ref1
                    can_rf = int(refs[r, c])
                    mvv = grid.mv0[r, c] if ref_i == 0 else grid.mv1[r, c]
                    mv = (int(mvv[0]), int(mvv[1]))
                    for ci, rf in enumerate((ref_frame, ref_frame2)):
                        if can_rf == rf and len(ref_id[ci]) < 2:
                            ref_id[ci].append(mv)
                        elif can_rf > INTRA_FRAME and len(ref_diff[ci]) < 2:
                            if sign_bias[can_rf] != sign_bias[rf]:
                                mv2 = (-mv[0], -mv[1])
                            else:
                                mv2 = mv
                            ref_diff[ci].append(mv2)

            if abs(max_row_offset) >= 1:
                i = 0
                while i < mi_size:
                    collect(mi_row - 1, mi_col + i)
                    i += _bsize_dims(
                        int(grid.bsize[mi_row - 1, mi_col + i]))[0]
            if abs(max_col_offset) >= 1:
                i = 0
                while i < mi_size:
                    collect(mi_row + i, mi_col - 1)
                    i += _bsize_dims(
                        int(grid.bsize[mi_row + i, mi_col - 1]))[1]
            comp_list = [[None, None] for _ in
                         range(MAX_MV_REF_CANDIDATES + 1)]
            for ci, gmv in ((0, gm_mv), (1, gm_mv2)):
                pool = (ref_id[ci] + ref_diff[ci])[:MAX_MV_REF_CANDIDATES]
                while len(pool) < MAX_MV_REF_CANDIDATES:
                    pool.append(tuple(gmv))
                for k, mv in enumerate(pool):
                    comp_list[k][ci] = mv
            if stack:   # refmv_count == 1
                if comp_list[0][0] == (stack[0][0], stack[0][1]) and \
                        comp_list[0][1] == (stack[0][2], stack[0][3]):
                    pick = comp_list[1]
                else:
                    pick = comp_list[0]
                stack.append([pick[0][0], pick[0][1],
                              pick[1][0], pick[1][1], 2])
            else:
                for k in range(MAX_MV_REF_CANDIDATES):
                    stack.append([comp_list[k][0][0], comp_list[k][0][1],
                                  comp_list[k][1][0], comp_list[k][1][1],
                                  2])
            # compound adds COUNT toward NumMvFound (unlike the single
            # gm fill below)
        else:
            if abs(max_row_offset) >= 1:
                i = 0
                while i < mi_size and len(stack) < MAX_MV_REF_CANDIDATES:
                    r, c = mi_row - 1, mi_col + i
                    for ref_i, refs in ((0, grid.ref0), (1, grid.ref1)):
                        can_rf = int(refs[r, c])
                        if can_rf > INTRA_FRAME:
                            mvv = grid.mv0[r, c] if ref_i == 0 \
                                else grid.mv1[r, c]
                            mv = (int(mvv[0]), int(mvv[1]))
                            if sign_bias[can_rf] != sign_bias[ref_frame]:
                                mv = (-mv[0], -mv[1])
                            if not any((e[0], e[1]) == mv for e in stack):
                                stack.append([mv[0], mv[1], 0, 0, 2])
                    i += _bsize_dims(int(grid.bsize[r, c]))[0]
            if abs(max_col_offset) >= 1:
                i = 0
                while i < mi_size and len(stack) < MAX_MV_REF_CANDIDATES:
                    r, c = mi_row + i, mi_col - 1
                    for ref_i, refs in ((0, grid.ref0), (1, grid.ref1)):
                        can_rf = int(refs[r, c])
                        if can_rf > INTRA_FRAME:
                            mvv = grid.mv0[r, c] if ref_i == 0 \
                                else grid.mv1[r, c]
                            mv = (int(mvv[0]), int(mvv[1]))
                            if sign_bias[can_rf] != sign_bias[ref_frame]:
                                mv = (-mv[0], -mv[1])
                            if not any((e[0], e[1]) == mv for e in stack):
                                stack.append([mv[0], mv[1], 0, 0, 2])
                    i += _bsize_dims(int(grid.bsize[r, c]))[1]
            # gm fill writes stack entries but does NOT bump refmv_count
            # (ref adaptive_mv_pred.c:632)
            n_counted = len(stack)
            while len(stack) < MAX_MV_REF_CANDIDATES:
                stack.append([gm_mv[0], gm_mv[1], 0, 0, 2])

    # clamp
    bw8 = n8_w * 4 * 8
    bh8 = n8_h * 4 * 8
    to_left = -(mi_col * 4 * 8)
    to_right = (mi_cols - n8_w - mi_col) * 4 * 8
    to_top = -(mi_row * 4 * 8)
    to_bottom = (mi_rows - n8_h - mi_row) * 4 * 8
    lo_c = to_left - bw8 - MV_BORDER
    hi_c = to_right + bw8 + MV_BORDER
    lo_r = to_top - bh8 - MV_BORDER
    hi_r = to_bottom + bh8 + MV_BORDER
    for ent in stack:
        ent[0] = _clamp(ent[0], lo_r, hi_r)
        ent[1] = _clamp(ent[1], lo_c, hi_c)
        if is_comp:
            ent[2] = _clamp(ent[2], lo_r, hi_r)
            ent[3] = _clamp(ent[3], lo_c, hi_c)

    out.stack = [(e[0], e[1]) for e in stack]
    if is_comp:
        out.stack2 = [(e[2], e[3]) for e in stack]
    out.weights = [e[4] for e in stack]
    out.n_found = len(stack) if n_counted is None else n_counted
    out.mode_context = mode_context
    return out


COMP_NEWMV_CTXS = 5
_COMPOUND_MODE_CTX_MAP = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))


def compound_mode_ctx(mode_context: int) -> int:
    """av1_mode_context_analyzer compound mapping
    (ref inter_prediction.c:2431)."""
    newmv_ctx = mode_context & 7
    refmv_ctx = (mode_context >> 4) & 15
    return _COMPOUND_MODE_CTX_MAP[refmv_ctx >> 1][
        min(newmv_ctx, COMP_NEWMV_CTXS - 1)]


def _is_bwd(ref: int) -> bool:
    return ref >= 5                      # BWDREF/ALTREF2/ALTREF


def has_uni_comp_refs(ref0: int, ref1: int) -> bool:
    return ref1 > INTRA_FRAME and not (_is_bwd(ref0) ^ _is_bwd(ref1))


def comp_ref_type_ctx(grid: MiGrid, r: int, c: int) -> int:
    """av1_get_comp_reference_type_context
    (ref entropy_coding.c:1727)."""
    have_above, have_left = r > grid.row_start, c > grid.col_start
    g = grid

    def info(rr, cc):
        r0 = int(g.ref0[rr, cc])
        r1 = int(g.ref1[rr, cc])
        return (r0 > 0, r1 > 0, r0, r1)   # is_inter, has_second

    if have_above and have_left:
        a_in, a_cp, a0, a1 = info(r - 1, c)
        l_in, l_cp, l0, l1 = info(r, c - 1)
        if not a_in and not l_in:
            return 2
        if not a_in or not l_in:
            ii, cp, i0, i1 = (l_in, l_cp, l0, l1) if not a_in else \
                (a_in, a_cp, a0, a1)
            if not cp:
                return 2
            return 1 + 2 * has_uni_comp_refs(i0, i1)
        if not a_cp and not l_cp:
            return 1 + 2 * (not (_is_bwd(a0) ^ _is_bwd(l0)))
        if not a_cp or not l_cp:
            uni = has_uni_comp_refs(l0, l1) if not a_cp else \
                has_uni_comp_refs(a0, a1)
            if not uni:
                return 1
            return 3 + (not (_is_bwd(a0) ^ _is_bwd(l0)))
        a_uni = has_uni_comp_refs(a0, a1)
        l_uni = has_uni_comp_refs(l0, l1)
        if not a_uni and not l_uni:
            return 0
        if not a_uni or not l_uni:
            return 2
        return 3 + ((a0 == 5) == (l0 == 5))   # BWDREF_FRAME == 5
    if have_above or have_left:
        e_in, e_cp, e0, e1 = info(r - 1, c) if have_above else info(r, c - 1)
        if not e_in:
            return 2
        if not e_cp:
            return 2
        return 4 * has_uni_comp_refs(e0, e1)
    return 2


def drl_ctx(weights: List[int], idx: int) -> int:
    """av1_drl_ctx: context for the DRL bit after position idx."""
    if idx < len(weights) and weights[idx] >= REF_CAT_LEVEL:
        if idx + 1 < len(weights) and weights[idx + 1] >= REF_CAT_LEVEL:
            return 0
        return 1
    if idx + 1 < len(weights):
        return 2
    return 0


# --- shared writer/parser context helpers (spec 5.11.*) --------------------

def intra_inter_ctx(grid: MiGrid, r: int, c: int) -> int:
    have_above, have_left = r > grid.row_start, c > grid.col_start
    if have_above and have_left:
        ai = int(grid.ref0[r - 1, c]) <= 0
        li = int(grid.ref0[r, c - 1]) <= 0
        return 3 if (ai and li) else (1 if (ai or li) else 0)
    if have_above or have_left:
        pos = (r - 1, c) if have_above else (r, c - 1)
        return 2 * (int(grid.ref0[pos]) <= 0)
    return 0


def neighbor_ref_counts(grid: MiGrid, r: int, c: int):
    counts = [0] * 8
    for ok, pos in ((r > grid.row_start, (r - 1, c)),
                    (c > grid.col_start, (r, c - 1))):
        if not ok:
            continue
        r0 = int(grid.ref0[pos])
        r1 = int(grid.ref1[pos])
        if r0 > 0:
            counts[r0] += 1
            if r1 > 0:
                counts[r1] += 1
    return counts


def ctx3(a: int, b: int) -> int:
    return 1 if a == b else (0 if a < b else 2)


def interp_filter_ctx(grid: MiGrid, r: int, c: int, ref: int,
                      direction: int) -> int:
    ctx = (direction & 1) * 8

    def ref_filt(rr, cc):
        if int(grid.ref0[rr, cc]) == ref or int(grid.ref1[rr, cc]) == ref:
            return int(grid.filters[rr, cc, direction])
        return 3
    lt = ref_filt(r, c - 1) if c > grid.col_start else 3
    at = ref_filt(r - 1, c) if r > grid.row_start else 3
    if lt == at:
        return ctx + lt
    if lt == 3:
        return ctx + at
    if at == 3:
        return ctx + lt
    return ctx + 3


def reference_mode_ctx(grid: MiGrid, r: int, c: int) -> int:
    """av1_get_reference_mode_context (ref entropy_coding.c:1860)."""
    have_above, have_left = r > grid.row_start, c > grid.col_start
    g = grid

    def info(rr, cc):
        r0 = int(g.ref0[rr, cc])
        r1 = int(g.ref1[rr, cc])
        return (r0 != 0, r1 > 0, r0 >= 5)   # is_inter, has_second, backward

    if have_above and have_left:
        a_in, a_comp, a_bwd = info(r - 1, c)
        l_in, l_comp, l_bwd = info(r, c - 1)
        if not a_comp and not l_comp:
            return int(a_bwd) ^ int(l_bwd)
        if not a_comp:
            return 2 + int(a_bwd or not a_in)
        if not l_comp:
            return 2 + int(l_bwd or not l_in)
        return 4
    if have_above or have_left:
        e_in, e_comp, e_bwd = info(r - 1, c) if have_above else info(r, c - 1)
        return 3 if e_comp else int(e_bwd)
    return 1


def has_overlappable(grid: MiGrid, r: int, c: int, w4: int, h4: int) -> bool:
    if r > grid.row_start:
        for i in range(0, min(w4, grid.col_end - c)):
            if int(grid.ref0[r - 1, c + i]) > 0:
                return True
    if c > grid.col_start:
        for i in range(0, min(h4, grid.row_end - r)):
            if int(grid.ref0[r + i, c - 1]) > 0:
                return True
    return False


def count_warp_samples(grid: MiGrid, r: int, c: int, bsize: int, ref: int,
                       mv) -> int:
    """find_warp_samples sample count (spec 7.10.4)."""
    from svt_av1_psy_tpu_torch.constants import BLOCK_SIZE_HIGH, BLOCK_SIZE_WIDE
    w4 = BLOCK_SIZE_WIDE[bsize] // 4
    h4 = BLOCK_SIZE_HIGH[bsize] // 4
    num = 0

    def try_sample(rr, cc):
        nonlocal num
        if num >= 8:
            return
        if rr < grid.row_start or cc < grid.col_start or \
                rr >= grid.row_end or cc >= grid.col_end:
            return
        if int(grid.ref0[rr, cc]) == ref and int(grid.ref1[rr, cc]) < 0:
            mvd = abs(int(grid.mv0[rr, cc, 0]) - mv[0]) + \
                abs(int(grid.mv0[rr, cc, 1]) - mv[1])
            if mvd <= 256:
                num += 1

    do_tl = True
    do_tr = True
    if r > grid.row_start:
        src_b = int(grid.bsize[r - 1, c])
        src_w = BLOCK_SIZE_WIDE[src_b] // 4
        if w4 <= src_w:
            col_off = -(c & (src_w - 1))
            if col_off < 0:
                do_tl = False
            if col_off + src_w > w4:
                do_tr = False
            try_sample(r - 1, c)
        else:
            i = 0
            while i < min(w4, grid.col_end - c):
                src_b = int(grid.bsize[r - 1, c + i])
                src_w = BLOCK_SIZE_WIDE[src_b] // 4
                i = (i & ~(src_w - 1))
                try_sample(r - 1, c + i)
                i += src_w
    if c > grid.col_start:
        src_b = int(grid.bsize[r, c - 1])
        src_h = BLOCK_SIZE_HIGH[src_b] // 4
        if h4 <= src_h:
            row_off = -(r & (src_h - 1))
            if row_off < 0:
                do_tl = False
            try_sample(r, c - 1)
        else:
            i = 0
            while i < min(h4, grid.row_end - r):
                src_b = int(grid.bsize[r + i, c - 1])
                src_h = BLOCK_SIZE_HIGH[src_b] // 4
                i = (i & ~(src_h - 1))
                try_sample(r + i, c - 1)
                i += src_h
    if do_tl:
        try_sample(r - 1, c - 1)
    if do_tr and max(w4, h4) <= 16:
        try_sample(r - 1, c + w4)
    return num


def lower_mv_precision(mv, allow_hp: bool, force_int: bool):
    r, c = mv
    if force_int:
        r = ((r + 3 if r > 0 else r - 3) // 8) * 8 if r % 8 else r
        c = ((c + 3 if c > 0 else c - 3) // 8) * 8 if c % 8 else c
    elif not allow_hp:
        if r & 1:
            r += -1 if r > 0 else 1
        if c & 1:
            c += -1 if c > 0 else 1
    return (r, c)
