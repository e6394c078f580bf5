"""Tile symbol parser — the decode-side mirror of entropy/tile_writer.py.

Part of the in-repo conformance decoder (role of libaom's RefDecoder in the
reference's e2e tests). Decodes KEY-frame tile data into block records +
quantized coefficients, maintaining the same normative neighbor contexts as
the writer. Used to (a) cross-parse bitstreams from other AV1 encoders to
validate context derivation, and (b) trace-diff our own encoder's streams.

Every symbol is appended to `trace` as (name, value) for debugging.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from svt_av1_psy_tpu_torch.constants import (BLOCK_SIZE_HIGH, BLOCK_SIZE_WIDE,
                                       TX_SIZE_HIGH, TX_SIZE_SQR,
                                       TX_SIZE_SQR_UP, TX_SIZE_WIDE,
                                       BlockSize, PredMode, TxSize, TxType,
                                       get_scan)
from svt_av1_psy_tpu_torch.entropy import coeff_coder as cc
from svt_av1_psy_tpu_torch.entropy.frame_context import FrameContext
from svt_av1_psy_tpu_torch.entropy.range_coder import RangeDecoder
from svt_av1_psy_tpu_torch.entropy.tile_writer import (_INTRA_MODE_CTX, _PART_CTX,
                                                 MAX_TX_SIZE_RECT,
                                                 cfl_allowed, has_chroma,
                                                 is_directional,
                                                 use_angle_delta)

from svt_av1_psy_tpu_torch.entropy.tx_trees import (SUB_TX as _SUB_TX,
                                              max_tx_depth as _max_tx_depth_fn,
                                              tx_size_cat as _tx_size_cat_fn)

from svt_av1_psy_tpu_torch.entropy.tx_sets import (EXT_TX_INV, EXT_TX_SET_SIZES,
                                             intra_tx_set, uv_tx_type)


# compound inter modes (spec inter_compound_mode symbol order)
NEAREST_NEARESTMV, NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV, \
    NEAR_NEWMV, NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV = range(8)
# per-component sub-mode (0 NEAREST, 1 NEAR, 2 GLOBAL, 3 NEW — matches
# the single-ref inter_mode numbering)
_COMP_MODE0 = (0, 1, 0, 3, 1, 3, 2, 3)
_COMP_MODE1 = (0, 1, 3, 0, 3, 1, 2, 3)
_COMP_HAS_NEWMV = (False, False, True, True, True, True, False, True)


@dataclass
class ParsedBlock:
    mi_row: int
    mi_col: int
    bsize: int
    y_mode: int
    uv_mode: int
    angle_delta_y: int = 0
    angle_delta_uv: int = 0
    skip: bool = False
    tx_size: int = 0
    cfl_joint_sign: int = -1
    cfl_idx_u: int = 0
    cfl_idx_v: int = 0
    use_filter_intra: bool = False
    filter_intra_mode: int = 0
    is_inter: bool = False
    ref_frame: int = 0                         # LAST=1..ALTREF=7
    mv: tuple = (0, 0)                         # (row, col) in 1/8 px
    inter_mode: int = 0                        # 0 NEARESTMV 1 NEARMV 2 GLOBALMV 3 NEWMV
    ref_mv_idx: int = 0
    interp_filters: tuple = (0, 0)             # (x, y)
    # compound prediction (ref_frame2 > 0): second ref + MV, the coded
    # mode index (0..7, spec inter_compound_mode), jnt-comp index
    ref_frame2: int = -1
    mv2: tuple = (0, 0)
    compound_mode: int = -1
    compound_idx: int = 1
    skip_mode: bool = False
    # motion modes (spec 5.11.27): 0 SIMPLE, 1 OBMC, 2 WARPED_CAUSAL
    motion_mode: int = 0
    warp_params: object = None       # wm dict or None (invalid -> simple)
    obmc_above: list = None          # [(rel4, n4, ref, mv, filters)]
    obmc_left: list = None
    # inter-intra (spec 5.11.28): mode 0..3 = II_DC/V/H/SMOOTH
    interintra: bool = False
    interintra_mode: int = 0
    ii_wedge: bool = False
    ii_wedge_idx: int = 0
    # masked compound (spec 5.11.29): 0 avg/dist-wtd, 1 wedge, 2 diffwtd
    comp_type: int = 0
    comp_wedge_idx: int = 0
    comp_wedge_sign: int = 0
    comp_mask_type: int = 0
    # intrabc (spec 5.11.31): DV in mv, prediction from the current frame
    use_intrabc: bool = False
    # luma palette (spec 5.11.42/5.11.49): colors tuple + index map
    palette: tuple = None
    palette_map: object = None
    # sub-8x8 chroma prediction group (ref enc_inter_prediction.c:3903
    # inter_chroma_4xn_pred): [(ref0, (mv_r, mv_c), (fx, fy)), ...] in
    # raster order over the covered luma 4x4s, or None when any covered
    # block is intra (fallback: whole aligned chroma from this block's MV)
    chroma_sub8x8: list = None
    qindex: int = None                         # per-block q (delta_q)
    txbs: list = field(default_factory=list)   # (plane, u_row, u_col, TxSize, TxType, qcoeff|None)
    # inter var-tx (TX_MODE_SELECT): luma leaf layout + split flags in
    # read order (spec 5.11.16 read_var_tx_size)
    tx_leaves: list = None                     # [(r_off4, c_off4, TxSize)]
    txfm_splits: list = None                   # [0/1, ...] DFS order


# min(3, min(log2(w4), log2(h4))) (ref definitions.h:1608)
_SIZE_GROUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
               0, 0, 1, 1, 2, 2]


def _ceil_log2(n: int) -> int:
    return 0 if n < 2 else (n - 1).bit_length()


def _neg_deinterleave(diff: int, ref: int, mx: int) -> int:
    """neg_deinterleave (spec 5.11.14 segment-id decoding)."""
    if ref == 0:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        if diff & 1:
            return ref + ((diff + 1) >> 1)
        return ref - (diff >> 1)
    return mx - (diff + 1)


_WIENER_TAP_SPEC = ((-5, 10, 1), (-23, 8, 2), (-17, 46, 3))


def _inv_recenter(r, v):
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


class TileParser:
    def __init__(self, fc: FrameContext, data: bytes, mi_rows: int,
                 mi_cols: int, *, sb_size: int = 64,
                 tx_mode_select: bool = False, reduced_tx_set: bool = False,
                 delta_q_present: bool = False, allow_update_cdf: bool = True,
                 enable_filter_intra: bool = False, cdef_bits: int = -1,
                 frame_is_intra: bool = True, allow_hp: bool = False,
                 force_integer_mv: bool = False,
                 reference_select: bool = False,
                 switchable_filter: bool = False,
                 dual_filter: bool = False,
                 enable_interintra: bool = False,
                 motion_mode_switchable: bool = False,
                 allow_warped_motion: bool = False,
                 skip_mode_present: bool = False,
                 skip_mode_frame=(1, 2),
                 ref_order_hints=None, cur_order_hint: int = 0,
                 order_hint_bits: int = 0,
                 enable_jnt_comp: bool = False,
                 enable_masked_compound: bool = False,
                 gm_trans=None,
                 lr_type=None, lr_unit_size=None,
                 frame_width: int = 0, frame_height: int = 0,
                 base_q_idx=None, delta_q_res_log2: int = 0,
                 mi_bounds=None, tpl_mvs=None, seg=None,
                 allow_intrabc: bool = False,
                 allow_screen_content: bool = False,
                 bit_depth: int = 8):
        self.fc = fc
        self.skip_mode_frame = tuple(skip_mode_frame)
        self.cur_order_hint = cur_order_hint
        self.order_hint_bits = order_hint_bits
        self.enable_jnt_comp = enable_jnt_comp
        self.enable_masked_compound = enable_masked_compound
        # per-ref order hints (index 0 = LAST_FRAME) and the derived
        # RefFrameSignBias (spec 5.9.2: backward refs get bias 1)
        self.ref_hints = list(ref_order_hints) if ref_order_hints \
            else [0] * 7
        self.sign_bias = [0] * 8
        if order_hint_bits > 0:
            for k in range(7):
                self.sign_bias[k + 1] = int(self._rel_dist(
                    self.ref_hints[k], cur_order_hint) > 0)
        # per-ref precision-lowered global MV (spec setup_global_mv);
        # index 0 = LAST_FRAME
        from svt_av1_psy_tpu_torch.inter.global_motion import gm_mv8
        self.gm_mv = [(0, 0)] * 7
        self.gm_trans = gm_trans
        # shear-validated warp params per ROTZOOM ref (spec setup_shear;
        # GLOBALMV blocks >= 8x8 then predict through the warp filter)
        self.gm_warp = [None] * 7
        if gm_trans is not None:
            from svt_av1_psy_tpu_torch.inter.warp import _shear_params
            for i, wm in enumerate(gm_trans):
                if wm is None:
                    continue
                if len(wm) == 2:
                    self.gm_mv[i] = gm_mv8(wm, allow_hp,
                                           bool(force_integer_mv))
                else:
                    wmd = {"mat": list(wm)}
                    if _shear_params(wmd):
                        self.gm_warp[i] = wmd
        self.dec = RangeDecoder(data)
        self.mi_rows, self.mi_cols = mi_rows, mi_cols
        # tile bounds (mi units): (row_start, row_end, col_start, col_end).
        # Availability and scans never cross these (spec MiRowStart..End).
        self.r0, self.r1, self.c0, self.c1 = \
            mi_bounds if mi_bounds is not None else (0, mi_rows, 0, mi_cols)
        self.sb_mi = sb_size // 4
        self.tx_mode_select = tx_mode_select
        self.reduced_tx_set = reduced_tx_set
        self.delta_q_present = delta_q_present
        self.adapt = allow_update_cdf
        self.enable_filter_intra = enable_filter_intra
        self.ss_x = self.ss_y = 1
        self.trace: list = []
        self.events: list = []   # ('part',r,c,bsize,part) | ('block',ParsedBlock) | ('pctx',r,c,bsize,sub)
        self.blocks: list[ParsedBlock] = []
        self.read_deltas = False
        # cdef_idx per 64x64 unit (-1 = unset; spec 5.11.56 read_cdef).
        # cdef_bits < 0 disables the syntax (no cdef in frame header).
        self.cdef_bits = cdef_bits
        self.cdef_idx = np.full(((mi_rows + 15) // 16, (mi_cols + 15) // 16),
                                -1, np.int32)
        self.frame_is_intra = frame_is_intra
        self.allow_hp = allow_hp
        # projected motion field (spec 7.9): (mv (n8r,n8c,2) int16,
        # ref_frame_offset (n8r,n8c) int16, valid (n8r,n8c) bool)
        self.tpl_mvs = tpl_mvs
        # segmentation (spec 5.11.14): dict(enabled, update_map, temporal,
        # pre_skip, last_active, altq[8] (int or None), prev_map) or None
        self.seg = seg if (seg is not None and seg.get("enabled")) else None
        self.cur_seg_id = 0
        self.force_integer_mv = force_integer_mv
        self.allow_intrabc = allow_intrabc
        self.allow_screen_content = allow_screen_content
        self.bit_depth = bit_depth
        self.reference_select = reference_select
        self.switchable_filter = switchable_filter
        self.dual_filter = dual_filter
        self.enable_interintra = enable_interintra
        self.motion_mode_switchable = motion_mode_switchable
        self.allow_warped_motion = allow_warped_motion
        self.skip_mode_present = skip_mode_present
        self.lr_type = lr_type
        self.lr_unit_size = lr_unit_size
        self.frame_width = frame_width or mi_cols * 4
        self.frame_height = frame_height or mi_rows * 4
        self.lr_units = [{}, {}, {}]
        self.lr_ref_wiener = [[[3, -7, 15], [3, -7, 15]] for _ in range(3)]
        self.lr_ref_sgr = [[-32, 31] for _ in range(3)]
        # per-block qindex tracking needs the frame base q; without it the
        # dq events are still consumed/replayed but blocks carry no qindex
        self.base_q_idx = base_q_idx
        self.cur_q = base_q_idx if base_q_idx is not None else 0
        self.delta_q_res_log2 = delta_q_res_log2
        if not frame_is_intra or allow_intrabc:
            from svt_av1_psy_tpu_torch.inter.mvref import MiGrid
            self.grid = MiGrid(mi_rows, mi_cols, row_start=self.r0,
                               col_start=self.c0, row_end=self.r1,
                               col_end=self.c1)
            # per-4x4 luma tx types for inter-chroma tx type derivation
            # (spec compute_tx_type)
            self.txtype_grid = np.zeros((mi_rows, mi_cols), np.uint8)
        # palette neighbor state: each mi column/row remembers the
        # covering block's luma palette (colors tuple) or None
        self.above_pal = [None] * mi_cols
        self.left_pal = [None] * mi_rows

        self.above_part = np.zeros(mi_cols, np.uint8)
        self.left_part = np.zeros(mi_rows, np.uint8)
        self.above_mode = np.full(mi_cols, int(PredMode.DC_PRED), np.uint8)
        self.left_mode = np.full(mi_rows, int(PredMode.DC_PRED), np.uint8)
        self.above_skip = np.zeros(mi_cols, np.uint8)
        self.left_skip = np.zeros(mi_rows, np.uint8)
        self.above_skip_mode = np.zeros(mi_cols, np.uint8)
        self.left_skip_mode = np.zeros(mi_rows, np.uint8)
        self.seg_map = np.zeros((mi_rows, mi_cols), np.int8)
        self.above_seg_pred = np.zeros(mi_cols, np.uint8)
        self.left_seg_pred = np.zeros(mi_rows, np.uint8)
        # txfm context: above stores tx widths, left tx heights (px per 4-unit)
        self.above_txw = np.full(mi_cols, 64, np.int32)
        self.left_txh = np.full(mi_rows, 64, np.int32)
        self.above_coef = [np.zeros(mi_cols, np.uint8),
                           np.zeros((mi_cols + 1) >> 1, np.uint8),
                           np.zeros((mi_cols + 1) >> 1, np.uint8)]
        self.left_coef = [np.zeros(mi_rows, np.uint8),
                          np.zeros((mi_rows + 1) >> 1, np.uint8),
                          np.zeros((mi_rows + 1) >> 1, np.uint8)]

    # --- symbol helpers --------------------------------------------------
    def _sym(self, name, cdf, nsyms=None):
        if getattr(self, 'trace_cdfs', False):
            n = nsyms if nsyms is not None else len(cdf) - 1
            head = (int(cdf[0]), int(cdf[1]) if n > 1 else 0,
                    int(cdf[2]) if n > 2 else 0)
            v = self.dec.decode_symbol(cdf, nsyms=nsyms, adapt=self.adapt)
            self.trace.append((name, v, n, head))
            return v
        v = self.dec.decode_symbol(cdf, nsyms=nsyms, adapt=self.adapt)
        self.trace.append((name, v))
        return v

    def _lit(self, name, bits):
        v = self.dec.decode_literal(bits)
        self.trace.append((name, v))
        return v

    # --- top level -------------------------------------------------------
    def parse_tile(self):
        for sbr in range(self.r0, self.r1, self.sb_mi):
            for sbc in range(self.c0, self.c1, self.sb_mi):
                self.read_deltas = self.delta_q_present
                if self.lr_type is not None and any(self.lr_type):
                    self._read_lr(sbr, sbc)
                self._parse_partition(sbr, sbc, int(BlockSize.BLOCK_64X64))
        return self.blocks

    # --- loop restoration syntax (spec 5.11.57) --------------------------
    def _decode_subexp_bool(self, num_syms, k):
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num_syms <= mk + 3 * a:
                return self._ns(num_syms - mk) + mk
            if self._lit("subexp_more", 1):
                i += 1
                mk += a
            else:
                return self._lit("subexp_bits", b2) + mk

    def _ns(self, n):
        w = n.bit_length()
        m = (1 << w) - n
        v = self._lit("ns_v", w - 1) if w > 1 else 0
        if v < m:
            return v
        extra = self._lit("ns_extra", 1)
        return (v << 1) - m + extra

    def _decode_signed_subexp(self, low, high, k, ref):
        mx = high - low
        rr = ref - low
        v = self._decode_subexp_bool(mx, k)
        if (rr << 1) <= mx:
            x = _inv_recenter(rr, v)
        else:
            x = mx - 1 - _inv_recenter(mx - 1 - rr, v)
        return x + low

    def _read_lr(self, sbr, sbc):
        from svt_av1_psy_tpu_torch.entropy.range_coder import uniform_icdf
        fc = self.fc
        for plane in range(3):
            if not self.lr_type[plane]:
                continue
            sub = 1 if plane else 0
            usize = self.lr_unit_size[plane]
            pw = (self.frame_width + sub) >> sub
            ph = (self.frame_height + sub) >> sub
            ucols = max((pw + (usize >> 1)) // usize, 1)
            urows = max((ph + (usize >> 1)) // usize, 1)
            px = 4 >> sub       # plane px per mi
            r0 = (sbr * px + usize - 1) // usize
            r1 = min(urows, ((sbr + self.sb_mi) * px + usize - 1) // usize)
            c0 = (sbc * px + usize - 1) // usize
            c1 = min(ucols, ((sbc + self.sb_mi) * px + usize - 1) // usize)
            for ur in range(r0, r1):
                for uc in range(c0, c1):
                    self._read_lr_unit(plane, ur, uc)

    def _read_lr_unit(self, plane, ur, uc):
        fc = self.fc
        ftype = self.lr_type[plane]
        if ftype == 3:          # SWITCHABLE
            rtype = self._sym("lr_switchable", fc.switchable_restore)
        elif ftype == 1:        # WIENER
            rtype = 1 if self._sym("lr_wiener", fc.wiener_restore) else 0
        else:                   # SGRPROJ
            rtype = 2 if self._sym("lr_sgrproj", fc.sgrproj_restore) else 0
        info = {"type": rtype}
        if rtype == 1:
            taps = []
            for p2 in range(2):       # vert then horz
                f = []
                first = 1 if plane else 0
                for j in range(3):
                    if j < first:
                        f.append(0)
                        continue
                    mn, mx, k = _WIENER_TAP_SPEC[j]
                    v = self._decode_signed_subexp(
                        mn, mx + 1, k, self.lr_ref_wiener[plane][p2][j])
                    self.lr_ref_wiener[plane][p2][j] = v
                    f.append(v)
                taps.append(tuple(f))
            info["vfilter"] = taps[0]
            info["hfilter"] = taps[1]
        elif rtype == 2:
            from svt_av1_psy_tpu_torch.ops.restoration import SGR_PARAMS
            ep = self._lit("lr_sgr_set", 4)
            r0, _, r1, _ = SGR_PARAMS[ep]
            if r0:
                x0 = self._decode_signed_subexp(
                    -96, 32, 4, self.lr_ref_sgr[plane][0])
            else:
                x0 = 0
            if r1:
                x1 = self._decode_signed_subexp(
                    -32, 96, 4, self.lr_ref_sgr[plane][1])
            else:
                x1 = max(-32, min(95, (1 << 7) - x0))
            self.lr_ref_sgr[plane][0] = x0
            self.lr_ref_sgr[plane][1] = x1
            info["ep"] = ep
            info["xqd"] = (x0, x1)
        self.lr_units[plane][(ur, uc)] = info

    def _parse_partition(self, r, c, bsize):
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        h4 = BLOCK_SIZE_HIGH[bsize] // 4
        has_rows = r + h4 // 2 < self.mi_rows
        has_cols = c + w4 // 2 < self.mi_cols
        bsl = w4.bit_length() - 1
        if bsize == int(BlockSize.BLOCK_8X8):
            nsyms = 4
        elif bsize == int(BlockSize.BLOCK_128X128):
            nsyms = 8
        else:
            nsyms = 10
        if bsize < int(BlockSize.BLOCK_8X8):
            part = 0
            ctx = 0
        else:
            above = (int(self.above_part[c]) >> (bsl - 1)) & 1
            left = (int(self.left_part[r]) >> (bsl - 1)) & 1
            ctx = (bsl - 1) * 4 + left * 2 + above
        if bsize < int(BlockSize.BLOCK_8X8):
            pass
        elif has_rows and has_cols:
            part = self._sym(f"partition@{r},{c},{bsize}",
                             self.fc.partition[ctx], nsyms=nsyms)
        elif not has_rows and not has_cols:
            part = 3
        else:
            from svt_av1_psy_tpu_torch.entropy.tile_writer import TileWriter as _TW

            icdf = _TW._gather_bool_icdf(self.fc.partition[ctx],
                                         not has_rows, bsize)
            bit = self.dec.decode_symbol(icdf, nsyms=2, adapt=False)
            self.trace.append((f"split_or_{'horz' if not has_rows else 'vert'}"
                               f"@{r},{c}", bit))
            if bit:
                part = 3
            else:
                part = 1 if not has_rows else 2

        self.events.append(('part', r, c, bsize, part))
        half4 = w4 // 2
        sub = _subsize(bsize, part)
        if part == 0:                       # NONE
            self._parse_block(r, c, bsize)
            self._update_part_ctx(r, c, bsize, bsize)
        elif part == 3:                     # SPLIT
            self._parse_partition(r, c, sub)
            self._parse_partition(r, c + half4, sub)
            self._parse_partition(r + half4, c, sub)
            self._parse_partition(r + half4, c + half4, sub)
        elif part == 1:                     # HORZ
            self._parse_block(r, c, sub)
            if r + h4 // 2 < self.mi_rows:
                self._parse_block(r + half4, c, sub)
            self._update_part_ctx(r, c, bsize, sub)
        elif part == 2:                     # VERT
            self._parse_block(r, c, sub)
            if c + w4 // 2 < self.mi_cols:
                self._parse_block(r, c + half4, sub)
            self._update_part_ctx(r, c, bsize, sub)
        else:
            sq = _subsize(bsize, 3)         # quarter square
            if part == 4:                   # HORZ_A: 2 squares / wide rect
                self._parse_block(r, c, sq)
                self._parse_block(r, c + half4, sq)
                self._parse_block(r + half4, c, sub)
                self._update_part_ctx(r, c, sub, sq)
                self._update_part_ctx(r + half4, c, sub, sub)
            elif part == 5:                 # HORZ_B: wide rect / 2 squares
                self._parse_block(r, c, sub)
                self._parse_block(r + half4, c, sq)
                self._parse_block(r + half4, c + half4, sq)
                self._update_part_ctx(r, c, sub, sub)
                self._update_part_ctx(r + half4, c, sub, sq)
            elif part == 6:                 # VERT_A: 2 squares | tall rect
                self._parse_block(r, c, sq)
                self._parse_block(r + half4, c, sq)
                self._parse_block(r, c + half4, sub)
                self._update_part_ctx(r, c, sub, sq)
                self._update_part_ctx(r, c + half4, sub, sub)
            elif part == 7:                 # VERT_B: tall rect | 2 squares
                self._parse_block(r, c, sub)
                self._parse_block(r, c + half4, sq)
                self._parse_block(r + half4, c + half4, sq)
                self._update_part_ctx(r, c, sub, sub)
                self._update_part_ctx(r, c + half4, sub, sq)
            elif part == 8:                 # HORZ_4
                q4 = h4 // 4
                for i in range(4):
                    if r + i * q4 >= self.mi_rows:
                        break
                    self._parse_block(r + i * q4, c, sub)
                self._update_part_ctx(r, c, bsize, sub)
            elif part == 9:                 # VERT_4
                q4 = w4 // 4
                for i in range(4):
                    if c + i * q4 >= self.mi_cols:
                        break
                    self._parse_block(r, c + i * q4, sub)
                self._update_part_ctx(r, c, bsize, sub)
            else:
                raise NotImplementedError(f"partition {part}")

    def _update_part_ctx(self, r, c, bsize, subsize):
        self.events.append(('pctx', r, c, bsize, subsize))
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        h4 = BLOCK_SIZE_HIGH[bsize] // 4
        self.above_part[c:c + w4] = _PART_CTX[BLOCK_SIZE_WIDE[subsize]]
        self.left_part[r:r + h4] = _PART_CTX[BLOCK_SIZE_HIGH[subsize]]

    # --- block -----------------------------------------------------------
    def _parse_block(self, r, c, bsize):
        fc = self.fc
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        h4 = BLOCK_SIZE_HIGH[bsize] // 4
        have_above = r > self.r0
        have_left = c > self.c0

        seg_id = 0
        seg = self.seg
        if seg is not None and seg["pre_skip"]:
            seg_id = self._read_block_segment(r, c, w4, h4, skip=False,
                                              pre_skip=True)

        sm = 0
        if self.skip_mode_present and not self.frame_is_intra and \
                min(BLOCK_SIZE_WIDE[bsize], BLOCK_SIZE_HIGH[bsize]) >= 8:
            smctx = int(self.above_skip_mode[c]) + \
                int(self.left_skip_mode[r])
            sm = self._sym(f"skip_mode@{r},{c}", fc.skip_mode[smctx])
        # every block stores skip_mode (0 when not read) — stale values
        # would corrupt later skip_mode contexts
        self.above_skip_mode[c:c + w4] = sm
        self.left_skip_mode[r:r + h4] = sm

        if sm:
            skip = True               # spec: skip inferred, not coded
        else:
            skip_ctx = int(self.above_skip[c]) + int(self.left_skip[r])
            skip = bool(self._sym(f"skip@{r},{c}", fc.skip[skip_ctx]))

        if seg is not None and not seg["pre_skip"]:
            seg_id = self._read_block_segment(r, c, w4, h4, skip=skip,
                                              pre_skip=False)
        self.cur_seg_id = seg_id

        # read_cdef (spec 5.11.56): first non-skip block per 64x64 unit
        if self.cdef_bits >= 0 and not skip:
            r64, c64 = r >> 4, c >> 4
            if self.cdef_idx[r64, c64] < 0:
                v = 0
                for _ in range(self.cdef_bits):
                    v = (v << 1) | self._lit("cdef_idx_bit", 1)
                for i in range(r64, min((r + h4 + 15) >> 4,
                                        self.cdef_idx.shape[0])):
                    for j in range(c64, min((c + w4 + 15) >> 4,
                                            self.cdef_idx.shape[1])):
                        self.cdef_idx[i, j] = v

        # read_delta_qindex (sb-size blocks with skip don't read)
        if self.read_deltas:
            if getattr(self, 'dbg_dq_nonskip_only', False):
                dq_code = not skip
            else:
                dq_code = not (w4 == self.sb_mi and h4 == self.sb_mi and skip)
            if dq_code:
                abs_q = self._sym("delta_q_abs", fc.delta_q)
                if abs_q == 3:
                    rem = self._lit("delta_q_rem_bits", 3) + 1
                    abs_q = self._lit("delta_q_abs_bits", rem) + (1 << rem) + 1
                sign = 0
                if abs_q:
                    sign = self._lit("delta_q_sign", 1)
                self.events.append(('dq', abs_q, sign))
                delta = -abs_q if sign else abs_q
                self.cur_q = max(1, min(255, self.cur_q +
                                        (delta << self.delta_q_res_log2)))
            self.read_deltas = False

        if self.frame_is_intra and self.allow_intrabc:
            if self._sym("use_intrabc", fc.intrabc):
                self._parse_intrabc_block(r, c, bsize, skip)
                return

        is_inter = False
        if sm:
            is_inter = True           # spec: inferred for skip_mode
        elif not self.frame_is_intra:
            ctx = self._intra_inter_ctx(r, c, have_above, have_left)
            is_inter = bool(self._sym(f"is_inter@{r},{c}",
                                      fc.intra_inter[ctx]))
        if is_inter:
            self._parse_inter_block(r, c, bsize, skip, have_above,
                                    have_left, skip_mode=bool(sm))
            return

        if self.frame_is_intra:
            am = int(self.above_mode[c]) if have_above \
                else int(PredMode.DC_PRED)
            lm = int(self.left_mode[r]) if have_left \
                else int(PredMode.DC_PRED)
            y_mode = self._sym(
                f"y_mode@{r},{c}",
                fc.kf_y[_INTRA_MODE_CTX[am]][_INTRA_MODE_CTX[lm]])
        else:
            y_mode = self._sym(f"y_mode@{r},{c}",
                               fc.y_mode[_SIZE_GROUP[bsize]])
        ad_y = 0
        if is_directional(y_mode) and use_angle_delta(bsize):
            ad_y = self._sym("angle_y",
                             fc.angle_delta[y_mode - PredMode.V_PRED]) - 3

        hc = has_chroma(r, c, bsize)
        cfl_ok = cfl_allowed(bsize)
        uv_mode = int(PredMode.DC_PRED)
        if hc:
            uv_mode = self._sym(f"uv_mode@{r},{c}",
                                fc.uv_mode[int(cfl_ok)][y_mode],
                                nsyms=14 if cfl_ok else 13)
        ad_uv = 0
        cfl_js, cfl_u, cfl_v = -1, 0, 0
        if not hc:
            pass
        elif uv_mode == int(PredMode.UV_CFL_PRED):
            cfl_js = self._sym("cfl_sign", fc.cfl_sign)
            sign_u = ((cfl_js + 1) * 11) >> 5
            sign_v = (cfl_js + 1) - 3 * sign_u
            if sign_u != 0:
                cfl_u = self._sym("cfl_alpha_u",
                                  fc.cfl_alpha[cfl_js + 1 - 3])
            if sign_v != 0:
                cfl_v = self._sym("cfl_alpha_v",
                                  fc.cfl_alpha[sign_v * 3 + sign_u - 3])
        elif is_directional(uv_mode) and use_angle_delta(bsize):
            ad_uv = self._sym("angle_uv",
                              fc.angle_delta[uv_mode - PredMode.V_PRED]) - 3

        # palette_mode_info (spec 5.11.42): luma palette for DC blocks
        # 8x8..64x64 when screen content tools are on; the reference
        # never emits chroma palettes (palette_size[1] asserts 0)
        pal_colors = None
        hc = has_chroma(r, c, bsize)
        if self.allow_screen_content and bsize >= 3 \
                and BLOCK_SIZE_WIDE[bsize] <= 64 \
                and BLOCK_SIZE_HIGH[bsize] <= 64:
            bctx = (BLOCK_SIZE_WIDE[bsize].bit_length() +
                    BLOCK_SIZE_HIGH[bsize].bit_length() - 2) - 6
            if y_mode == int(PredMode.DC_PRED):
                pctx = int(have_above and
                           self.above_pal[c] is not None) + \
                    int(have_left and self.left_pal[r] is not None)
                if self._sym("palette_y_mode",
                             fc.palette_y_mode[bctx][pctx]):
                    n_pal = self._sym("palette_y_size",
                                      fc.palette_y_size[bctx]) + 2
                    pal_colors = self._read_palette_colors_y(r, c, n_pal)
            if hc and uv_mode == int(PredMode.DC_PRED):
                has_uv = self._sym(
                    "palette_uv_mode",
                    fc.palette_uv_mode[int(pal_colors is not None)])
                assert not has_uv, "chroma palette unsupported"

        use_fi, fi_mode = False, 0
        if (self.enable_filter_intra and y_mode == int(PredMode.DC_PRED)
                and pal_colors is None
                and BLOCK_SIZE_WIDE[bsize] <= 32
                and BLOCK_SIZE_HIGH[bsize] <= 32):
            use_fi = bool(self._sym("filter_intra", fc.filter_intra[bsize]))
            if use_fi:
                fi_mode = self._sym("filter_intra_mode", fc.filter_intra_mode)

        # palette_tokens (spec 5.11.49): color index map, decoded after
        # mode info and before the tx-size symbols (spec decode_block)
        pal_map = None
        if pal_colors is not None:
            pal_map = self._read_palette_map(r, c, bsize, len(pal_colors))

        # tx size
        max_tx = int(MAX_TX_SIZE_RECT[bsize])
        tx_size = max_tx
        if self.tx_mode_select and bsize > int(BlockSize.BLOCK_4X4) \
                and not (skip and getattr(self, 'dbg_no_skip_txd', False)):
            max_depth = _max_tx_depth(bsize)
            if max_depth > 0:
                cat = _tx_size_cat(bsize)
                ctx = self._tx_size_ctx(r, c, bsize, have_above, have_left)
                depth = self._sym(f"tx_depth@{r},{c}",
                                  fc.tx_size[cat][ctx],
                                  nsyms=max_depth + 1)
                for _ in range(depth):
                    tx_size = int(_SUB_TX[tx_size])
        blk = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=y_mode,
                          uv_mode=uv_mode, angle_delta_y=ad_y,
                          angle_delta_uv=ad_uv, skip=skip, tx_size=tx_size,
                          cfl_joint_sign=cfl_js, cfl_idx_u=cfl_u,
                          cfl_idx_v=cfl_v, use_filter_intra=use_fi,
                          filter_intra_mode=fi_mode,
                          palette=pal_colors, palette_map=pal_map,
                          qindex=self._block_qindex())

        # txfm context update
        self.above_txw[c:c + w4] = TX_SIZE_WIDE[tx_size]
        self.left_txh[r:r + h4] = TX_SIZE_HIGH[tx_size]
        self.above_pal[c:c + w4] = [pal_colors] * w4
        self.left_pal[r:r + h4] = [pal_colors] * h4
        self.above_mode[c:c + w4] = y_mode
        self.left_mode[r:r + h4] = y_mode
        self.above_skip[c:c + w4] = int(skip)
        self.left_skip[r:r + h4] = int(skip)

        if skip:
            self.above_coef[0][c:c + w4] = 0
            self.left_coef[0][r:r + h4] = 0
            # chroma ctx reset only for chroma-bearing blocks
            # (ref entropy_coding.c:4111 resets uv only if blk_geom->has_uv)
            if has_chroma(r, c, bsize):
                cw4 = max(1, w4 >> 1)
                ch4 = max(1, h4 >> 1)
                for p in (1, 2):
                    self.above_coef[p][(c >> 1):(c >> 1) + cw4] = 0
                    self.left_coef[p][(r >> 1):(r >> 1) + ch4] = 0
        else:
            self._parse_residual(blk)
        if not self.frame_is_intra:
            self.grid.set_block(r, c, h4, w4, bsize, 0, -1, (0, 0), (0, 0),
                                False)
        self.blocks.append(blk)
        self.events.append(('block', blk))

    def _has_overlappable(self, r, c, w4, h4) -> bool:
        """has_overlappable_candidates (spec 5.11.27): only ODD mi
        positions are probed (the 4x4-pair representative convention)."""
        g = self.grid
        if r > self.r0:
            for j in range(c | 1, min(self.c1, c + w4), 2):
                if int(g.ref0[r - 1, j]) > 0:
                    return True
        if c > self.c0:
            for k in range(r | 1, min(self.r1, r + h4), 2):
                if int(g.ref0[k, c - 1]) > 0:
                    return True
        return False

    def _gm_mv_block(self, ref, r, c, w4, h4):
        """Per-block global mv (spec 7.10.2.1): frame-constant for
        IDENTITY/TRANSLATION, block-center-derived for ROTZOOM."""
        wm = self.gm_trans[ref - 1] if self.gm_trans else None
        if wm is None or len(wm) == 2:
            return self.gm_mv[ref - 1]
        from svt_av1_psy_tpu_torch.inter.global_motion import gm_block_mv8
        return gm_block_mv8(wm, r, c, w4, h4, self.allow_hp,
                            bool(self.force_integer_mv))

    def _count_warp_samples(self, r, c, bsize, ref, mv) -> int:
        """find_warp_samples sample count (spec 7.10.4): neighbors with
        the same single reference whose MV is close to ours."""
        g = self.grid
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        h4 = BLOCK_SIZE_HIGH[bsize] // 4
        num = 0

        def try_sample(rr, cc2):
            nonlocal num
            if num >= 8:
                return
            if rr < self.r0 or cc2 < self.c0 or rr >= self.r1 or \
                    cc2 >= self.c1:
                return
            if int(g.ref0[rr, cc2]) == ref and int(g.ref1[rr, cc2]) <= 0:
                mvd = abs(int(g.mv0[rr, cc2, 0]) - mv[0]) + \
                    abs(int(g.mv0[rr, cc2, 1]) - mv[1])
                if mvd <= 256:
                    num += 1

        do_tl = True
        do_tr = True
        if r > self.r0:
            src_b = int(g.bsize[r - 1, c])
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
                while i < min(w4, self.c1 - c):
                    src_b = int(g.bsize[r - 1, c + i])
                    src_w = BLOCK_SIZE_WIDE[src_b] // 4
                    i = (i & ~(src_w - 1))
                    try_sample(r - 1, c + i)
                    i += src_w
        if c > self.c0:
            src_b = int(g.bsize[r, c - 1])
            src_h = BLOCK_SIZE_HIGH[src_b] // 4
            if h4 <= src_h:
                row_off = -(r & (src_h - 1))
                if row_off < 0:
                    do_tl = False
                try_sample(r, c - 1)
            else:
                i = 0
                while i < min(h4, self.r1 - r):
                    src_b = int(g.bsize[r + i, c - 1])
                    src_h = BLOCK_SIZE_HIGH[src_b] // 4
                    i = (i & ~(src_h - 1))
                    try_sample(r + i, c - 1)
                    i += src_h
        if do_tl:
            try_sample(r - 1, c - 1)
        if do_tr and max(w4, h4) <= 16:
            try_sample(r - 1, c + w4)
        return num

    # --- inter path (spec 5.11.10/24/25/26) ------------------------------
    def _intra_inter_ctx(self, r, c, have_above, have_left) -> int:
        g = self.grid
        if have_above and have_left:
            ai = int(g.ref0[r - 1, c]) <= 0
            li = int(g.ref0[r, c - 1]) <= 0
            return 3 if (ai and li) else (1 if (ai or li) else 0)
        if have_above or have_left:
            edge = (r - 1, c) if have_above else (r, c - 1)
            return 2 * (int(g.ref0[edge]) <= 0)
        return 0

    def _neighbor_ref_counts(self, r, c, have_above, have_left):
        g = self.grid
        counts = [0] * 8
        for (ok, pos) in ((have_above, (r - 1, c)), (have_left, (r, c - 1))):
            if not ok:
                continue
            r0 = int(g.ref0[pos])
            r1 = int(g.ref1[pos])
            if r0 > 0:
                counts[r0] += 1
                if r1 > 0:
                    counts[r1] += 1
        return counts

    _MAX_NB_OBMC = (0, 1, 2, 3, 4, 4)

    def _collect_obmc(self, r, c, bsize):
        """Overlappable neighbor segments for OBMC prediction (ref
        enc_inter_prediction.c:686 foreach_overlappable_nb_above/left):
        [(rel4, n4, ref0, (mv_r, mv_c), (fx, fy)), ...]. Width-4
        neighbors are treated as pairs, represented by the
        chroma-bearing (odd) member."""
        g = self.grid
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        h4 = BLOCK_SIZE_HIGH[bsize] // 4
        above = []
        if r > self.r0:
            nb_max = self._MAX_NB_OBMC[w4.bit_length() - 1]
            end_col = min(c + w4, self.mi_cols)
            col = c
            while col < end_col and len(above) < nb_max:
                step = min(
                    BLOCK_SIZE_WIDE[int(g.bsize[r - 1, col])] // 4, 16)
                use = (r - 1, col)
                if step == 1:
                    col &= ~1
                    use = (r - 1, col + 1)
                    step = 2
                if int(g.ref0[use]) > 0:
                    above.append((col - c, min(w4, step),
                                  int(g.ref0[use]),
                                  (int(g.mv0[use][0]), int(g.mv0[use][1])),
                                  (int(g.filters[use][0]),
                                   int(g.filters[use][1]))))
                col += step
        left = []
        if c > self.c0:
            nb_max = self._MAX_NB_OBMC[h4.bit_length() - 1]
            end_row = min(r + h4, self.mi_rows)
            row = r
            while row < end_row and len(left) < nb_max:
                step = min(
                    BLOCK_SIZE_HIGH[int(g.bsize[row, c - 1])] // 4, 16)
                use = (row, c - 1)
                if step == 1:
                    row &= ~1
                    use = (row + 1, c - 1)
                    step = 2
                if int(g.ref0[use]) > 0:
                    left.append((row - r, min(h4, step),
                                 int(g.ref0[use]),
                                 (int(g.mv0[use][0]), int(g.mv0[use][1])),
                                 (int(g.filters[use][0]),
                                  int(g.filters[use][1]))))
                row += step
        return above, left

    def _read_comp_refs(self, r, c, have_above, have_left):
        """read_ref_frames compound branch (spec 5.11.25;
        ref entropy_coding.c av1_get_comp_reference_type_context /
        comp_ref / comp_bwdref trees)."""
        from svt_av1_psy_tpu_torch.inter.mvref import comp_ref_type_ctx
        fc = self.fc
        cnt = self._neighbor_ref_counts(r, c, have_above, have_left)

        def ctx3(a, b):
            return 1 if a == b else (0 if a < b else 2)

        ctype = self._sym("comp_ref_type",
                          fc.comp_ref_type[comp_ref_type_ctx(self.grid,
                                                             r, c)])
        if not ctype:                        # UNIDIR_COMP_REFERENCE
            fwd = cnt[1] + cnt[2] + cnt[3] + cnt[4]
            bwd = cnt[5] + cnt[6] + cnt[7]
            p = self._sym("uni_comp_ref",
                          fc.uni_comp_ref[ctx3(fwd, bwd)][0])
            if p:
                return (5, 7)                # (BWDREF, ALTREF)
            p1 = self._sym("uni_comp_ref_p1",
                           fc.uni_comp_ref[ctx3(cnt[2],
                                                cnt[3] + cnt[4])][1])
            if not p1:
                return (1, 2)                # (LAST, LAST2)
            p2 = self._sym("uni_comp_ref_p2",
                           fc.uni_comp_ref[ctx3(cnt[3], cnt[4])][2])
            return (1, 4) if p2 else (1, 3)  # (LAST, GOLDEN/LAST3)
        # BIDIR: forward ref tree then backward ref tree
        p = self._sym("comp_ref",
                      fc.comp_ref[ctx3(cnt[1] + cnt[2],
                                       cnt[3] + cnt[4])][0])
        if not p:
            p1 = self._sym("comp_ref_p1",
                           fc.comp_ref[ctx3(cnt[1], cnt[2])][1])
            ref0 = 2 if p1 else 1            # LAST2 / LAST
        else:
            p2 = self._sym("comp_ref_p2",
                           fc.comp_ref[ctx3(cnt[3], cnt[4])][2])
            ref0 = 4 if p2 else 3            # GOLDEN / LAST3
        bp = self._sym("comp_bwdref",
                       fc.comp_bwdref[ctx3(cnt[5] + cnt[6], cnt[7])][0])
        if bp:
            return (ref0, 7)                 # ALTREF
        bp1 = self._sym("comp_bwdref_p1",
                        fc.comp_bwdref[ctx3(cnt[5], cnt[6])][1])
        return (ref0, 6 if bp1 else 5)       # ALTREF2 / BWDREF

    def _comp_group_idx_ctx(self, r, c, have_above, have_left) -> int:
        """get_comp_group_idx_context (libaom pred_common.h analog)."""
        g = self.grid
        above_ctx = left_ctx = 0
        if have_above:
            if int(g.ref1[r - 1, c]) > 0:
                above_ctx = int(g.comp_group[r - 1, c])
            elif int(g.ref0[r - 1, c]) == 7:
                above_ctx = 3
        if have_left:
            if int(g.ref1[r, c - 1]) > 0:
                left_ctx = int(g.comp_group[r, c - 1])
            elif int(g.ref0[r, c - 1]) == 7:
                left_ctx = 3
        return min(5, above_ctx + left_ctx)

    def _comp_index_ctx(self, r, c, ref, ref2, have_above,
                        have_left) -> int:
        """get_comp_index_context: order-hint distance symmetry +
        neighbor compound_idx."""
        fwd = abs(self._rel_dist(self.ref_hints[ref2 - 1],
                                 self.cur_order_hint))
        bck = abs(self._rel_dist(self.cur_order_hint,
                                 self.ref_hints[ref - 1]))
        offset = int(fwd == bck)
        g = self.grid
        above_ctx = left_ctx = 0
        if have_above:
            if int(g.ref1[r - 1, c]) > 0:
                above_ctx = int(g.cmp_idx[r - 1, c])
            elif int(g.ref0[r - 1, c]) == 7:
                above_ctx = 1
        if have_left:
            if int(g.ref1[r, c - 1]) > 0:
                left_ctx = int(g.cmp_idx[r, c - 1])
            elif int(g.ref0[r, c - 1]) == 7:
                left_ctx = 1
        return above_ctx + left_ctx + 3 * offset

    def _read_single_ref(self, r, c, have_above, have_left) -> int:
        fc = self.fc
        cnt = self._neighbor_ref_counts(r, c, have_above, have_left)

        def ctx3(a, b):
            return 1 if a == b else (0 if a < b else 2)

        fwd = cnt[1] + cnt[2] + cnt[3] + cnt[4]
        bwd = cnt[5] + cnt[6] + cnt[7]
        p1 = self._sym("single_ref_p1", fc.single_ref[ctx3(fwd, bwd)][0])
        if p1:            # backward group
            p2 = self._sym("single_ref_p2",
                           fc.single_ref[ctx3(cnt[5] + cnt[6], cnt[7])][1])
            if p2:
                return 7                      # ALTREF
            p6 = self._sym("single_ref_p6",
                           fc.single_ref[ctx3(cnt[5], cnt[6])][5])
            return 6 if p6 else 5             # ALTREF2 / BWDREF
        p3 = self._sym("single_ref_p3",
                       fc.single_ref[ctx3(cnt[1] + cnt[2],
                                          cnt[3] + cnt[4])][2])
        if p3:            # LAST3/GOLDEN
            p5 = self._sym("single_ref_p5",
                           fc.single_ref[ctx3(cnt[3], cnt[4])][4])
            return 4 if p5 else 3
        p4 = self._sym("single_ref_p4",
                       fc.single_ref[ctx3(cnt[1], cnt[2])][3])
        return 2 if p4 else 1

    def _read_mv_component(self, comp: int, tabs=None,
                           integer=None) -> int:
        fc = self.fc
        tabs = fc.nmv_comp if tabs is None else tabs
        integer = self.force_integer_mv if integer is None else integer
        pre = f"comp{comp}_"
        sign = self._sym("mv_sign", tabs[pre + "sign_cdf"])
        cls = self._sym("mv_class", tabs[pre + "classes_cdf"])
        if cls == 0:
            int_bit = self._sym("mv_class0", tabs[pre + "class0_cdf"])
            d = int_bit
        else:
            d = 0
            for b in range(cls):
                d |= self._sym("mv_bit",
                               tabs[pre + "bits_cdf"][b]) << b
        if integer:
            fr, hp = 3, 1
        else:
            if cls == 0:
                fr = self._sym("mv_fr",
                               tabs[pre + "class0_fp_cdf"][d])
            else:
                fr = self._sym("mv_fr", tabs[pre + "fp_cdf"])
            if self.allow_hp:
                hp = self._sym("mv_hp", tabs[
                    pre + ("class0_hp_cdf" if cls == 0 else "hp_cdf")])
            else:
                hp = 1
        if cls == 0:
            mag = d * 8 + fr * 2 + hp + 1
        else:
            mag = (2 << (cls + 2)) + (d * 8 + fr * 2 + hp + 1)
        return -mag if sign else mag

    def _read_mv(self, pred):
        joint = self._sym("mv_joint", self.fc.nmv_joints)
        dr = self._read_mv_component(0) if joint & 2 else 0
        dc = self._read_mv_component(1) if joint & 1 else 0
        return (pred[0] + dr, pred[1] + dc)

    def _read_dv(self, pred):
        """read_mv for intrabc (spec 5.11.31): the DV coder uses its own
        NMV context instance at integer precision (MV_SUBPEL_NONE)."""
        fc = self.fc
        joint = self._sym("dv_joint", fc.dv_joints)
        dr = self._read_mv_component(0, tabs=fc.dv_comp, integer=True) \
            if joint & 2 else 0
        dc = self._read_mv_component(1, tabs=fc.dv_comp, integer=True) \
            if joint & 1 else 0
        return (pred[0] + dr, pred[1] + dc)

    @staticmethod
    def _lower_precision(mv, allow_hp, force_int):
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

    def _rel_dist(self, a: int, b: int) -> int:
        if self.order_hint_bits <= 0:
            return 0
        d = a - b
        m = 1 << (self.order_hint_bits - 1)
        return (d & (m - 1)) - (d & m)

    def _parse_inter_block(self, r, c, bsize, skip, have_above, have_left,
                           skip_mode=False):
        from svt_av1_psy_tpu_torch.inter.mvref import drl_ctx, setup_ref_mv_list
        fc = self.fc
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        h4 = BLOCK_SIZE_HIGH[bsize] // 4

        # read_ref_frames (spec 5.11.25)
        ref2 = -1
        if skip_mode:
            ref, ref2 = self.skip_mode_frame
        else:
            comp = False
            if self.reference_select and min(BLOCK_SIZE_WIDE[bsize],
                                             BLOCK_SIZE_HIGH[bsize]) >= 8:
                from svt_av1_psy_tpu_torch.inter.mvref import reference_mode_ctx
                comp = bool(self._sym("comp_mode", fc.comp_inter[
                    reference_mode_ctx(self.grid, r, c)]))
            if comp:
                ref, ref2 = self._read_comp_refs(r, c, have_above,
                                                 have_left)
            else:
                ref = self._read_single_ref(r, c, have_above, have_left)
        is_comp = ref2 > 0

        tpl = None
        if self.tpl_mvs is not None:
            cur_off0 = self._rel_dist(self.cur_order_hint,
                                      self.ref_hints[ref - 1])
            cur_off1 = self._rel_dist(self.cur_order_hint,
                                      self.ref_hints[ref2 - 1]) \
                if is_comp else 0
            tpl = self.tpl_mvs + (cur_off0, cur_off1, self.allow_hp)
        def _nt(rf):
            wm = self.gm_trans[rf - 1] if self.gm_trans else None
            return wm is not None and len(wm) == 6
        refs = setup_ref_mv_list(
            self.grid, r, c, bsize, ref, sb_mi=self.sb_mi,
            gm_mv=self._gm_mv_block(ref, r, c, w4, h4),
            ref_frame2=ref2 if is_comp else -1,
            gm_mv2=self._gm_mv_block(ref2, r, c, w4, h4)
            if is_comp else (0, 0),
            sign_bias=self.sign_bias, tpl=tpl,
            gm_nontrans=_nt(ref),
            gm_nontrans2=_nt(ref2) if is_comp else False)

        cmode = -1
        if skip_mode:
            cmode = NEAREST_NEARESTMV
            mode = -1
        elif is_comp:
            from svt_av1_psy_tpu_torch.inter.mvref import compound_mode_ctx
            cmode = self._sym("inter_compound_mode",
                              fc.inter_compound_mode[
                                  compound_mode_ctx(refs.mode_context)])
            mode = -1
        else:
            # inter mode (NEWMV / GLOBALMV / NEARESTMV / NEARMV)
            not_new = self._sym("newmv_flag", fc.newmv[refs.newmv_ctx])
            if not not_new:
                mode = 3                            # NEWMV
            else:
                not_zero = self._sym("zeromv_flag",
                                     fc.zeromv[refs.zeromv_ctx])
                if not not_zero:
                    mode = 2                        # GLOBALMV
                else:
                    not_nearest = self._sym("refmv_flag",
                                            fc.refmv[refs.refmv_ctx])
                    mode = 1 if not_nearest else 0  # NEARMV / NEARESTMV

        # DRL index (spec 5.11.24: NEWMV/NEW_NEWMV scan 0..1,
        # have-nearmv modes scan 1..2)
        ref_mv_idx = 0
        if not skip_mode:
            new_like = mode == 3 or cmode == NEW_NEWMV
            near_like = mode == 1 or cmode in (NEAR_NEARMV, NEAR_NEWMV,
                                               NEW_NEARMV)
            if new_like:
                for idx in range(2):
                    if refs.count > idx + 1:
                        bit = self._sym("drl",
                                        fc.drl[drl_ctx(refs.weights, idx)])
                        if not bit:
                            ref_mv_idx = idx
                            break
                        ref_mv_idx = idx + 1
            elif near_like:
                ref_mv_idx = 1
                for idx in range(1, 3):
                    if refs.count > idx + 1:
                        bit = self._sym("drl",
                                        fc.drl[drl_ctx(refs.weights, idx)])
                        if not bit:
                            ref_mv_idx = idx
                            break
                        ref_mv_idx = idx + 1

        # assign_mv (spec 5.11.26)
        def assign(sub_mode, stack_i, ref_i, mv_comp_read):
            if sub_mode == 2:                    # GLOBALMV component
                return self._gm_mv_block(ref_i, r, c, w4, h4)
            if sub_mode == 3:                    # NEWMV component
                pos = ref_mv_idx if refs.count > 1 else 0
                pred = self._lower_precision(stack_i[pos], self.allow_hp,
                                             self.force_integer_mv)
                return mv_comp_read(pred)
            pos = 0 if sub_mode == 0 else ref_mv_idx
            return self._lower_precision(stack_i[pos], self.allow_hp,
                                         self.force_integer_mv)

        mv2 = (0, 0)
        if is_comp:
            mv = assign(_COMP_MODE0[cmode], refs.stack, ref, self._read_mv)
            mv2 = assign(_COMP_MODE1[cmode], refs.stack2, ref2,
                         self._read_mv)
        else:
            mv = assign(mode, refs.stack, ref, self._read_mv)

        # interintra (spec 5.11.28): allowed bsizes are the ENUM range
        # 8x8..32x32 (excludes 8x32/32x8; libaom
        # is_interintra_allowed_bsize), single ref only
        ii = 0
        ii_mode = 0
        ii_wedge = 0
        ii_wedge_idx = 0
        if self.enable_interintra and not skip_mode and not is_comp and \
                3 <= bsize <= 9:
            grp = _SIZE_GROUP[bsize]
            ii = self._sym("interintra", fc.interintra[grp])
            if ii:
                ii_mode = self._sym("interintra_mode",
                                    fc.interintra_mode[grp])
                # wedge allowed for the whole interintra bsize range
                ii_wedge = self._sym("wedge_interintra",
                                     fc.wedge_interintra[bsize])
                if ii_wedge:
                    ii_wedge_idx = self._sym("wedge_idx",
                                             fc.wedge_idx[bsize])

        # read_motion_mode (spec 5.11.27): OBMC/WARP selection —
        # single-ref, non-skip-mode blocks only
        mm = 0
        warp_params = None
        obmc_above = obmc_left = None
        # GLOBALMV under a non-translational gm forces SIMPLE without a
        # symbol (spec 5.11.27 read_motion_mode GmType > TRANSLATION)
        nontrans_global = (not self.force_integer_mv and
                           (mode == 2 or cmode == 6) and
                           self.gm_trans is not None and
                           self.gm_trans[ref - 1] is not None and
                           len(self.gm_trans[ref - 1]) == 6)
        if self.motion_mode_switchable and not skip_mode and not is_comp \
                and not ii and not nontrans_global \
                and min(BLOCK_SIZE_WIDE[bsize],
                        BLOCK_SIZE_HIGH[bsize]) >= 8 \
                and self._has_overlappable(r, c, w4, h4):
            from svt_av1_psy_tpu_torch.inter import warp as warpmod
            pts, pts_ref = warpmod.find_warp_samples(
                self.grid, r, c, bsize, ref, sb_mi=self.sb_mi)
            nsamp = len(pts)
            if self.force_integer_mv or nsamp == 0 or \
                    not self.allow_warped_motion:
                mm = self._sym("obmc", fc.obmc[bsize])
            else:
                mm = self._sym("motion_mode", fc.motion_mode[bsize])
            if mm == 2:                 # WARPED_CAUSAL
                if nsamp > 1:
                    pts, pts_ref = warpmod.select_samples(mv, pts,
                                                          pts_ref, bsize)
                # None = invalid params -> translational fallback
                warp_params = warpmod.find_projection(pts, pts_ref,
                                                      bsize, mv, r, c)
            elif mm == 1:               # OBMC_CAUSAL
                obmc_above, obmc_left = self._collect_obmc(r, c, bsize)
        if mm == 0 and not is_comp and not ii and mode == 2 and \
                warp_params is None and not self.force_integer_mv:
            # global warp (spec 7.11.3.2): GLOBALMV blocks under a
            # shear-valid ROTZOOM model predict through the warp filter
            # (>= 8x8 planes; smaller fall back in the reconstructor)
            warp_params = self.gm_warp[ref - 1]

        # read_compound_type (spec 5.11.29): average / dist-wtd when
        # comp_group_idx == 0, else wedge / diffwtd masked compound
        comp_group_idx = 0
        compound_idx = 1
        comp_type = 0                   # 0 avg, 1 wedge, 2 diffwtd
        comp_wedge_idx = 0
        comp_wedge_sign = 0
        comp_mask_type = 0
        if is_comp and not skip_mode:
            if self.enable_masked_compound:
                cg_ctx = self._comp_group_idx_ctx(r, c, have_above,
                                                  have_left)
                comp_group_idx = self._sym("comp_group_idx",
                                           fc.comp_group_idx[cg_ctx])
            if comp_group_idx == 0:
                if self.enable_jnt_comp:
                    ci_ctx = self._comp_index_ctx(r, c, ref, ref2,
                                                  have_above, have_left)
                    compound_idx = self._sym("compound_idx",
                                             fc.compound_idx[ci_ctx])
            else:
                from svt_av1_psy_tpu_torch.inter.masks import wedge_used
                if wedge_used(bsize):
                    comp_type = 1 + self._sym("compound_type",
                                              fc.compound_type[bsize])
                else:
                    comp_type = 2
                if comp_type == 1:
                    comp_wedge_idx = self._sym("wedge_idx",
                                               fc.wedge_idx[bsize])
                    comp_wedge_sign = self._lit("wedge_sign", 1)
                else:
                    comp_mask_type = self._lit("mask_type", 1)

        # read_mb_interp_filter (spec 5.11.27); not coded when interp is
        # not needed: skip_mode, WARPED_CAUSAL, or GLOBAL modes whose gm
        # type is non-TRANSLATION — including IDENTITY — => REGULAR
        # (libaom av1_is_interp_needed / is_nontrans_global_motion)
        nontrans_gm = False
        if ((is_comp and cmode == 6) or (not is_comp and mode == 2)) \
                and min(w4, h4) >= 2:
            gms = self.gm_trans or [None] * 7
            used = (ref, ref2) if is_comp else (ref,)
            nontrans_gm = all(gms[rf - 1] is None or
                              len(gms[rf - 1]) == 6 for rf in used)
        filters = (0, 0)
        if self.switchable_filter and not skip_mode and mm != 2 and \
                not nontrans_gm:
            g = self.grid
            fl = []
            ndirs = 2 if self.dual_filter else 1
            for d in range(ndirs):
                ctx = (d & 1) * 8 + 4 * is_comp
                def ref_filt(rr, cc2):
                    if int(g.ref0[rr, cc2]) == ref or \
                            int(g.ref1[rr, cc2]) == ref:
                        return int(g.filters[rr, cc2, d])
                    return 3
                lt = ref_filt(r, c - 1) if have_left else 3
                at = ref_filt(r - 1, c) if have_above else 3
                if lt == at:
                    ctx += lt
                elif lt == 3:
                    ctx += at
                elif at == 3:
                    ctx += lt
                else:
                    ctx += 3
                fl.append(self._sym("interp_filter",
                                    fc.switchable_interp[ctx]))
            filters = (fl[0], fl[-1]) if self.dual_filter \
                else (fl[0], fl[0])
        blk = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=0,
                          uv_mode=0, skip=skip,
                          tx_size=int(MAX_TX_SIZE_RECT[bsize]),
                          is_inter=True, ref_frame=ref, mv=mv,
                          inter_mode=mode, ref_mv_idx=ref_mv_idx,
                          interp_filters=filters,
                          ref_frame2=ref2, mv2=mv2, compound_mode=cmode,
                          compound_idx=compound_idx,
                          skip_mode=skip_mode,
                          motion_mode=mm, warp_params=warp_params,
                          obmc_above=obmc_above, obmc_left=obmc_left,
                          interintra=bool(ii), interintra_mode=ii_mode,
                          ii_wedge=bool(ii_wedge),
                          ii_wedge_idx=ii_wedge_idx,
                          comp_type=comp_type,
                          comp_wedge_idx=comp_wedge_idx,
                          comp_wedge_sign=comp_wedge_sign,
                          comp_mask_type=comp_mask_type,
                          qindex=self._block_qindex())
        if self.tx_mode_select and not skip:
            # read_var_tx_size over max-tx units (spec 5.11.16; write-side
            # mirror: ref entropy_coding.c:4389 write_tx_size_vartx)
            maxtx = int(MAX_TX_SIZE_RECT[bsize])
            splits, leaves = [], []
            mw4 = TX_SIZE_WIDE[maxtx] // 4
            mh4 = TX_SIZE_HIGH[maxtx] // 4
            for i in range(0, h4, mh4):
                for j in range(0, w4, mw4):
                    self._read_var_tx(blk, maxtx, 0, i, j, splits, leaves)
            blk.txfm_splits = splits
            blk.tx_leaves = leaves
        else:
            # fixed tx (or skip): ctx arrays get the max-tx/block dims
            # (ref entropy_coding.c:4443 set_txfm_ctxs)
            self.above_txw[c:c + w4] = TX_SIZE_WIDE[blk.tx_size]
            self.left_txh[r:r + h4] = TX_SIZE_HIGH[blk.tx_size]

        # neighbor state updates
        self.above_mode[c:c + w4] = int(PredMode.DC_PRED)
        self.left_mode[r:r + h4] = int(PredMode.DC_PRED)
        self.above_skip[c:c + w4] = int(skip)
        self.left_skip[r:r + h4] = int(skip)
        self.above_pal[c:c + w4] = [None] * w4
        self.left_pal[r:r + h4] = [None] * h4
        has_newmv = (mode == 3) if not is_comp else _COMP_HAS_NEWMV[cmode]
        # interintra stores ref1 = INTRA_FRAME (0): excluded from warp
        # samples (which require NONE) but still "no second ref" (> 0
        # tests) everywhere else (libaom semantics)
        self.grid.set_block(r, c, h4, w4, bsize, ref,
                            ref2 if is_comp else (0 if ii else -1), mv, mv2,
                            has_newmv, filters=filters,
                            comp_group=comp_group_idx,
                            cmp_idx=compound_idx,
                            is_gmv=int((mode == 2 or cmode == 6) and
                                       min(BLOCK_SIZE_WIDE[bsize],
                                           BLOCK_SIZE_HIGH[bsize]) >= 8))

        # sub-8x8 chroma group: the covered luma 4x4s' mv/ref/filters
        # (ref enc_inter_prediction.c:3944; libaom dec_build_inter_pred
        # sub8x8 path). Any intra member -> None (normal-path fallback).
        if has_chroma(r, c, bsize) and \
                (BLOCK_SIZE_WIDE[bsize] < 8 or BLOCK_SIZE_HIGH[bsize] < 8):
            g = self.grid
            rs = 1 if BLOCK_SIZE_HIGH[bsize] == 4 else 0
            cs = 1 if BLOCK_SIZE_WIDE[bsize] == 4 else 0
            ents = []
            for dy in range(-rs, 1):
                for dx in range(-cs, 1):
                    rr, cc = r + dy, c + dx
                    if int(g.ref0[rr, cc]) <= 0:
                        ents = None
                        break
                    ents.append((int(g.ref0[rr, cc]),
                                 (int(g.mv0[rr, cc, 0]),
                                  int(g.mv0[rr, cc, 1])),
                                 (int(g.filters[rr, cc, 0]),
                                  int(g.filters[rr, cc, 1]))))
                if ents is None:
                    break
            blk.chroma_sub8x8 = ents

        if skip:
            self.above_coef[0][c:c + w4] = 0
            self.left_coef[0][r:r + h4] = 0
            # chroma ctx reset only for chroma-bearing blocks
            # (ref entropy_coding.c:4111 resets uv only if blk_geom->has_uv)
            if has_chroma(r, c, bsize):
                cw4 = max(1, w4 >> 1)
                ch4 = max(1, h4 >> 1)
                for p in (1, 2):
                    self.above_coef[p][(c >> 1):(c >> 1) + cw4] = 0
                    self.left_coef[p][(r >> 1):(r >> 1) + ch4] = 0
        else:
            self._parse_residual(blk)
        self.blocks.append(blk)
        self.events.append(('block', blk))

    def _parse_intrabc_block(self, r, c, bsize, skip):
        """Intra block copy (spec 5.11.31): DV from the intrabc MV stack
        (default DV rule when empty), inter-style var-tx + residual,
        prediction from the current frame's recon with BILINEAR chroma
        taps."""
        from svt_av1_psy_tpu_torch.inter.mvref import setup_ref_mv_list
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        h4 = BLOCK_SIZE_HIGH[bsize] // 4
        refs = setup_ref_mv_list(self.grid, r, c, bsize, 0,
                                 sb_mi=self.sb_mi, ibc=True)
        pred = refs.stack[0] if refs.stack else (0, 0)
        if pred == (0, 0):
            # default DV (spec assign_mv intrabc branch)
            if r - self.sb_mi < self.r0:
                pred = (0, -(self.sb_mi * 4 + 256) * 8)
            else:
                pred = (-(self.sb_mi * 4 * 8), 0)
        dv = self._read_dv(pred)

        blk = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=0,
                          uv_mode=0, skip=skip,
                          tx_size=int(MAX_TX_SIZE_RECT[bsize]),
                          is_inter=True, ref_frame=0, mv=dv,
                          inter_mode=3, interp_filters=(3, 3),
                          use_intrabc=True,
                          qindex=self._block_qindex())
        if self.tx_mode_select and not skip:
            maxtx = int(MAX_TX_SIZE_RECT[bsize])
            splits, leaves = [], []
            mw4 = TX_SIZE_WIDE[maxtx] // 4
            mh4 = TX_SIZE_HIGH[maxtx] // 4
            for i in range(0, h4, mh4):
                for j in range(0, w4, mw4):
                    self._read_var_tx(blk, maxtx, 0, i, j, splits, leaves)
            blk.txfm_splits = splits
            blk.tx_leaves = leaves
        else:
            self.above_txw[c:c + w4] = TX_SIZE_WIDE[blk.tx_size]
            self.left_txh[r:r + h4] = TX_SIZE_HIGH[blk.tx_size]

        self.above_mode[c:c + w4] = int(PredMode.DC_PRED)
        self.left_mode[r:r + h4] = int(PredMode.DC_PRED)
        self.above_skip[c:c + w4] = int(skip)
        self.left_skip[r:r + h4] = int(skip)
        self.above_pal[c:c + w4] = [None] * w4
        self.left_pal[r:r + h4] = [None] * h4
        self.grid.set_block(r, c, h4, w4, bsize, 0, -1, dv, (0, 0), True)
        self.grid.ibc[r:r + h4, c:c + w4] = 1
        if skip:
            self.above_coef[0][c:c + w4] = 0
            self.left_coef[0][r:r + h4] = 0
            if has_chroma(r, c, bsize):
                cw4 = max(1, w4 >> 1)
                ch4 = max(1, h4 >> 1)
                for p in (1, 2):
                    self.above_coef[p][(c >> 1):(c >> 1) + cw4] = 0
                    self.left_coef[p][(r >> 1):(r >> 1) + ch4] = 0
        else:
            self._parse_residual(blk)
        self.blocks.append(blk)
        self.events.append(('block', blk))

    def _txfm_split_ctx(self, r, c, bsize, tx) -> int:
        """txfm_partition ctx (ref entropy_coding.c:4367)."""
        txw, txh = TX_SIZE_WIDE[tx], TX_SIZE_HIGH[tx]
        above = int(int(self.above_txw[c]) < txw)
        left = int(int(self.left_txh[r]) < txh)
        dim = max(BLOCK_SIZE_WIDE[bsize], BLOCK_SIZE_HIGH[bsize])
        max_tx = {64: 4, 32: 3, 16: 2, 8: 1}.get(dim, 0)
        cat = int(int(TX_SIZE_SQR_UP[tx]) != max_tx and max_tx > 1) + \
            (4 - max_tx) * 2
        return cat * 3 + above + left

    def _read_var_tx(self, blk, tx, depth, r_off, c_off, splits, leaves):
        """read_var_tx_size (spec 5.11.16): one node of the inter tx tree."""
        r = blk.mi_row + r_off
        c = blk.mi_col + c_off
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        w4 = TX_SIZE_WIDE[tx] // 4
        h4 = TX_SIZE_HIGH[tx] // 4
        if depth == 2 or tx == int(TxSize.TX_4X4):   # MAX_VARTX_DEPTH
            split = 0
        else:
            ctx = self._txfm_split_ctx(r, c, blk.bsize, tx)
            split = self._sym(f"txfm_split@{r},{c}",
                              self.fc.txfm_partition[ctx])
            splits.append(int(split))
        if split:
            sub = int(_SUB_TX[tx])
            if sub == int(TxSize.TX_4X4):
                # terminal split to 4x4: leaves over the parent, single
                # ctx update spanning the parent extent, no more flags
                for i in range(h4):
                    for j in range(w4):
                        if r + i < self.mi_rows and c + j < self.mi_cols:
                            leaves.append((r_off + i, c_off + j, sub))
                self.above_txw[c:c + w4] = 4
                self.left_txh[r:r + h4] = 4
                return
            sh4 = TX_SIZE_HIGH[sub] // 4
            sw4 = TX_SIZE_WIDE[sub] // 4
            for i in range(0, h4, sh4):
                for j in range(0, w4, sw4):
                    self._read_var_tx(blk, sub, depth + 1,
                                      r_off + i, c_off + j, splits, leaves)
        else:
            leaves.append((r_off, c_off, tx))
            self.above_txw[c:c + w4] = TX_SIZE_WIDE[tx]
            self.left_txh[r:r + h4] = TX_SIZE_HIGH[tx]

    # --- palette (spec 5.11.42-5.11.49) -----------------------------------
    def _read_palette_colors_y(self, r, c, n):
        """Luma palette colors: per-cache-entry reuse flags, then delta
        coding of the new colors (ref write_palette_colors_y inverse;
        cache = sorted dedupe merge of the above/left palettes,
        above only when not at a superblock top row)."""
        from svt_av1_psy_tpu_torch.entropy.palette import merge_color_cache
        above = self.above_pal[c] if ((r * 4) % 64) and r > self.r0 \
            else None
        left = self.left_pal[r] if c > self.c0 else None
        cache = merge_color_cache(above, left)
        got = []
        i = 0
        while i < len(cache) and len(got) < n:
            if self._lit("pal_cache_flag", 1):
                got.append(cache[i])
            i += 1
        n_out = n - len(got)
        new = []
        if n_out > 0:
            bd = self.bit_depth
            v = self._lit("pal_color0", bd)
            new.append(v)
            if n_out > 1:
                bits = (bd - 3) + self._lit("pal_bits", 2)
                rng = (1 << bd) - v - 1
                for _ in range(n_out - 1):
                    d = self._lit("pal_delta", bits) + 1
                    v = min(v + d, (1 << bd) - 1)
                    new.append(v)
                    rng -= d
                    bits = min(bits, _ceil_log2(rng))
        return tuple(sorted(got + new))

    def _pal_color_ctx(self, m, rr, cc, n):
        """get_palette_color_context (ref cabac_context_model.c:2458):
        returns (cdf ctx, color order)."""
        from svt_av1_psy_tpu_torch.entropy.palette import palette_color_ctx
        return palette_color_ctx(m, rr, cc, n)

    def _read_palette_map(self, r, c, bsize, n):
        """palette_tokens (spec 5.11.49): first index uniform-coded, the
        rest in anti-diagonal wavefront order with neighbor contexts;
        offscreen region replicated from the last onscreen column/row."""
        bw = BLOCK_SIZE_WIDE[bsize]
        bh = BLOCK_SIZE_HIGH[bsize]
        w_on = min(bw, (self.mi_cols - c) * 4)
        h_on = min(bh, (self.mi_rows - r) * 4)
        m = np.zeros((bh, bw), np.uint8)
        # read_uniform(n) inverse of write_uniform
        lbits = n.bit_length() - 1 if (n & (n - 1)) == 0 else \
            (n - 1).bit_length()
        mm = (1 << lbits) - n
        v = self._lit("pal_first", lbits - 1) if lbits > 1 else 0
        if v >= mm:
            v = (v << 1) - mm + self._lit("pal_first_b", 1)
        m[0, 0] = v
        cdf = self.fc.palette_y_color[n - 2]
        for i in range(1, h_on + w_on - 1):
            for j in range(min(i, w_on - 1), max(0, i - h_on + 1) - 1, -1):
                rr, cc = i - j, j
                ctx, order = self._pal_color_ctx(m, rr, cc, n)
                sym = self._sym("pal_color_idx", cdf[ctx], nsyms=n)
                m[rr, cc] = order[sym]
        if w_on < bw:
            m[:, w_on:] = m[:, w_on - 1:w_on]
        if h_on < bh:
            m[h_on:, :] = m[h_on - 1:h_on, :]
        return m

    # --- segmentation (spec 5.11.14 / 5.11.24) ---------------------------
    def _read_block_segment(self, r, c, w4, h4, skip, pre_skip) -> int:
        """intra_segment_id / inter_segment_id: spatial neg-interleave
        coding with optional temporal prediction (libaom
        read_inter_segment_id / read_segment_id)."""
        seg = self.seg
        if not seg["enabled"]:
            return 0
        prev = seg.get("prev_map")
        if not self.frame_is_intra:
            # predicted id: min over the block extent of the prev map
            pred_t = 0
            if prev is not None:
                r1 = min(r + h4, prev.shape[0])
                c1 = min(c + w4, prev.shape[1])
                pred_t = int(prev[r:r1, c:c1].min())
            if not seg["update_map"]:
                self.seg_map[r:r + h4, c:c + w4] = pred_t
                return pred_t
            if not pre_skip and skip:
                if seg["temporal"]:
                    self.above_seg_pred[c:c + w4] = 0
                    self.left_seg_pred[r:r + h4] = 0
                return self._read_segment_id(r, c, w4, h4, skip=True)
            if seg["temporal"]:
                ctx = int(self.above_seg_pred[c]) + \
                    int(self.left_seg_pred[r])
                flag = self._sym("seg_pred", self.fc.seg_pred[ctx])
                self.above_seg_pred[c:c + w4] = flag
                self.left_seg_pred[r:r + h4] = flag
                if flag:
                    self.seg_map[r:r + h4, c:c + w4] = pred_t
                    return pred_t
            return self._read_segment_id(r, c, w4, h4, skip=False)
        if not seg["update_map"]:
            return 0
        return self._read_segment_id(r, c, w4, h4, skip=skip)

    def _read_segment_id(self, r, c, w4, h4, skip) -> int:
        sm = self.seg_map
        au = r > self.r0
        al = c > self.c0
        prev_ul = int(sm[r - 1, c - 1]) if (au and al) else -1
        prev_u = int(sm[r - 1, c]) if au else -1
        prev_l = int(sm[r, c - 1]) if al else -1
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        if skip:
            seg_id = pred
        else:
            if prev_ul < 0:
                ctx = 0
            elif prev_ul == prev_u and prev_ul == prev_l:
                ctx = 2
            elif prev_ul == prev_u or prev_ul == prev_l or \
                    prev_u == prev_l:
                ctx = 1
            else:
                ctx = 0
            coded = self._sym("segment_id", self.fc.seg_id[ctx])
            seg_id = _neg_deinterleave(coded, pred,
                                       self.seg["last_active"] + 1)
            seg_id = max(0, min(7, seg_id))
        sm[r:r + h4, c:c + w4] = seg_id
        return seg_id

    def _block_qindex(self, seg_id=None):
        """get_qindex (spec 7.12.2): segment ALT_Q delta on top of the
        delta-q-evolved (or base) qindex."""
        if seg_id is None:
            seg_id = getattr(self, "cur_seg_id", 0)
        altq = None
        if self.seg is not None and self.seg["enabled"]:
            altq = self.seg["altq"][seg_id]
        dq = self.delta_q_present and self.base_q_idx is not None
        if altq is not None:
            base = self.cur_q if dq else (self.base_q_idx or 0)
            return max(0, min(255, base + altq))
        return self.cur_q if dq else None

    def _tx_size_ctx(self, r, c, bsize, have_above, have_left) -> int:
        """get_tx_size_context: INTER neighbors contribute their BLOCK
        dims, not the stored txfm-context dims (libaom
        get_tx_size_context is_inter_block override)."""
        max_tx = int(MAX_TX_SIZE_RECT[bsize])
        g = getattr(self, "grid", None)
        if g is None:
            aw = int(self.above_txw[c]) >= TX_SIZE_WIDE[max_tx]
            lh = int(self.left_txh[r]) >= TX_SIZE_HIGH[max_tx]
            if have_above and have_left:
                return int(aw) + int(lh)
            if have_above:
                return int(aw)
            if have_left:
                return int(lh)
            return 0
        if have_above and (int(g.ref0[r - 1, c]) > 0 or
                           g.ibc[r - 1, c]):
            aw = BLOCK_SIZE_WIDE[int(g.bsize[r - 1, c])] >= \
                TX_SIZE_WIDE[max_tx]
        else:
            aw = int(self.above_txw[c]) >= TX_SIZE_WIDE[max_tx]
        if have_left and (int(g.ref0[r, c - 1]) > 0 or g.ibc[r, c - 1]):
            lh = BLOCK_SIZE_HIGH[int(g.bsize[r, c - 1])] >= \
                TX_SIZE_HIGH[max_tx]
        else:
            lh = int(self.left_txh[r]) >= TX_SIZE_HIGH[max_tx]
        if have_above and have_left:
            return int(aw) + int(lh)
        if have_above:
            return int(aw)
        if have_left:
            return int(lh)
        return 0

    # --- residual --------------------------------------------------------
    def _parse_residual(self, blk: ParsedBlock):
        bsize = blk.bsize
        hc = has_chroma(blk.mi_row, blk.mi_col, bsize)
        for plane in range(3 if hc else 1):
            ss = 1 if plane else 0
            bw = BLOCK_SIZE_WIDE[bsize] >> ss
            bh = BLOCK_SIZE_HIGH[bsize] >> ss
            base_r = blk.mi_row >> ss
            base_c = blk.mi_col >> ss
            if plane == 0 and blk.tx_leaves is not None:
                # inter var-tx: luma txbs at the tree's leaf layout
                for (ly, lx, ts) in blk.tx_leaves:
                    self._parse_txb(blk, 0, ts, base_r + ly, base_c + lx,
                                    bw, bh)
                continue
            if plane == 0:
                tx = blk.tx_size
            else:
                tx = _chroma_tx_size(bsize)
            tw, th = TX_SIZE_WIDE[tx], TX_SIZE_HIGH[tx]
            for oy in range(0, bh, th):
                for ox in range(0, bw, tw):
                    self._parse_txb(blk, plane, tx,
                                    base_r + oy // 4, base_c + ox // 4,
                                    bw, bh)

    def _parse_txb(self, blk, plane, tx_size, u_row, u_col, bw, bh):
        fc = self.fc
        tw4 = TX_SIZE_WIDE[tx_size] // 4
        th4 = TX_SIZE_HIGH[tx_size] // 4
        above = self.above_coef[plane][u_col:u_col + tw4]
        left = self.left_coef[plane][u_row:u_row + th4]
        ptype = 1 if plane else 0
        txs_ctx = cc.txs_entropy_ctx(tx_size)
        covers = (TX_SIZE_WIDE[tx_size] >= bw and TX_SIZE_HIGH[tx_size] >= bh)
        larger = bw * bh > TX_SIZE_WIDE[tx_size] * TX_SIZE_HIGH[tx_size]
        sctx = cc.txb_skip_ctx(above, left, plane, covers, larger)
        all_zero = self._sym(f"txb_skip p{plane}@{u_row},{u_col}",
                             fc.txb_skip[txs_ctx][sctx])
        if all_zero:
            self.above_coef[plane][u_col:u_col + tw4] = 0
            self.left_coef[plane][u_row:u_row + th4] = 0
            if plane == 0 and not self.frame_is_intra:
                self.txtype_grid[u_row:u_row + th4, u_col:u_col + tw4] = 0
            blk.txbs.append((plane, u_row, u_col, tx_size,
                             int(TxType.DCT_DCT), None))
            return

        # tx type
        if plane == 0 and not blk.is_inter:
            from svt_av1_psy_tpu_torch.entropy.tx_sets import FIMODE_TO_INTRADIR
            tx_set = intra_tx_set(tx_size, self.reduced_tx_set)
            if tx_set == 0:
                tx_type = int(TxType.DCT_DCT)
            else:
                mode = (FIMODE_TO_INTRADIR[blk.filter_intra_mode]
                        if blk.use_filter_intra else blk.y_mode)
                s = self._sym(
                    "tx_type",
                    fc.intra_ext_tx[tx_set][TX_SIZE_SQR[tx_size]][mode],
                    nsyms=EXT_TX_SET_SIZES[tx_set])
                tx_type = EXT_TX_INV[tx_set][s]
        elif plane == 0:
            from svt_av1_psy_tpu_torch.entropy.tx_sets import (
                EXT_TX_SET_TYPE_INV, EXT_TX_SET_TYPE_SIZES,
                EXT_TX_SET_TYPE_TO_IDX_INTER, inter_tx_set_type)
            st = inter_tx_set_type(tx_size, self.reduced_tx_set)
            if st == 0:
                tx_type = int(TxType.DCT_DCT)
            else:
                sidx = EXT_TX_SET_TYPE_TO_IDX_INTER[st]
                sym = self._sym(
                    "tx_type_inter",
                    fc.inter_ext_tx[sidx][TX_SIZE_SQR[tx_size]],
                    nsyms=EXT_TX_SET_TYPE_SIZES[st])
                tx_type = EXT_TX_SET_TYPE_INV[st][sym]
        elif blk.is_inter:
            from svt_av1_psy_tpu_torch.entropy.tx_sets import (EXT_TX_USED,
                                                         inter_tx_set_type)
            ly = max(blk.mi_row, u_row << 1)
            lx = max(blk.mi_col, u_col << 1)
            tx_type = int(self.txtype_grid[ly, lx])
            st = inter_tx_set_type(tx_size, self.reduced_tx_set)
            if tx_type not in EXT_TX_USED[st]:
                tx_type = int(TxType.DCT_DCT)
        else:
            tx_type = uv_tx_type(blk.uv_mode, tx_size, self.reduced_tx_set)

        if plane == 0 and blk.is_inter:
            self.txtype_grid[u_row:u_row + th4, u_col:u_col + tw4] = tx_type

        qcoeff, cul = self._parse_coeffs(tx_size, tx_type, ptype, above, left)
        self.above_coef[plane][u_col:u_col + tw4] = cul
        self.left_coef[plane][u_row:u_row + th4] = cul
        blk.txbs.append((plane, u_row, u_col, tx_size, tx_type, qcoeff))

    def _parse_coeffs(self, tx_size, tx_type, ptype, above, left):
        from svt_av1_psy_tpu_torch.ops.quant import adjusted_tx_size

        fc = self.fc
        adj = adjusted_tx_size(tx_size)
        w, h = TX_SIZE_WIDE[adj], TX_SIZE_HIGH[adj]
        real_w, real_h = TX_SIZE_WIDE[tx_size], TX_SIZE_HIGH[tx_size]
        bwl = w.bit_length() - 1
        txs_ctx = cc.txs_entropy_ctx(tx_size)
        tx_class = cc.tx_class_of(tx_type)
        scan = get_scan(tx_size, tx_type)

        ems = cc.eob_multi_size(tx_size)
        eob_multi_ctx = 0 if tx_class == cc.TX_CLASS_2D else 1
        eob_pt = 1 + self._sym("eob_pt",
                               fc.eob_flag(ems)[ptype][eob_multi_ctx],
                               nsyms=ems + 5)
        _, _, nbits = cc.get_eob_pos_token_from_pt(eob_pt)
        if nbits > 0:
            hi = self._sym("eob_hi", fc.eob_extra[txs_ctx][ptype][eob_pt])
            extra = hi << (nbits - 1)
            for i in range(1, nbits):
                extra |= self._lit("eob_bit", 1) << (nbits - 1 - i)
        else:
            extra = 0
        group_start = 1 if eob_pt == 1 else (
            2 if eob_pt == 2 else (1 << (eob_pt - 2)) + 1)
        eob = group_start + extra

        qcoeff = np.zeros((h, w), np.int32)
        levels = np.zeros((h + 4, w + cc.TX_PAD_HOR), np.uint8)
        for ci in range(eob - 1, -1, -1):
            pos = int(scan[ci])
            row, col = pos >> bwl, pos & (w - 1)
            if ci == eob - 1:
                ctx = cc.base_eob_ctx(ci, w, h)
                level = 1 + self._sym(
                    "base_eob", fc.coeff_base_eob[txs_ctx][ptype][ctx])
            else:
                ctx = cc.base_ctx(levels, row, col, w, h, tx_class,
                                  real_w, real_h)
                level = self._sym("base",
                                  fc.coeff_base[txs_ctx][ptype][ctx])
            if level > cc.NUM_BASE_LEVELS:
                bctx = cc.br_ctx(levels, row, col, tx_class)
                cdf_br = fc.coeff_br[min(txs_ctx, cc.MAX_TX_32_CTX)][ptype][bctx]
                idx = 0
                while idx < cc.COEFF_BASE_RANGE:
                    k = self._sym("br", cdf_br, nsyms=cc.BR_CDF_SIZE)
                    level += k
                    if k < cc.BR_CDF_SIZE - 1:
                        break
                    idx += cc.BR_CDF_SIZE - 1
            levels[row, col] = min(level, 127)
            qcoeff[row, col] = level

        sctx = cc.dc_sign_ctx(above, left)
        cul = 0
        for ci in range(eob):
            pos = int(scan[ci])
            row, col = pos >> bwl, pos & (w - 1)
            level = int(qcoeff[row, col])
            if level:
                if ci == 0:
                    sign = self._sym("dc_sign", fc.dc_sign[ptype][sctx])
                else:
                    sign = self._lit("sign", 1)
                if level > cc.COEFF_BASE_RANGE + cc.NUM_BASE_LEVELS:
                    level += self._read_golomb()
                qcoeff[row, col] = -level if sign else level
                cul += level
        cul = min(cc.COEFF_CONTEXT_MASK, cul)
        dc = int(qcoeff[0, 0])
        if dc < 0:
            cul |= 1 << cc.COEFF_CONTEXT_BITS
        elif dc > 0:
            cul += 2 << cc.COEFF_CONTEXT_BITS
        return qcoeff, cul

    def _read_golomb(self) -> int:
        length = 1
        while self.dec.decode_literal(1) == 0:
            length += 1
            if length > 32:
                raise ValueError("golomb desync")
        v = 1
        for _ in range(length - 1):
            v = (v << 1) | self.dec.decode_literal(1)
        self.trace.append(("golomb", v - 1))
        return v - 1


def _subsize(bsize: int, part: int) -> int:
    """spec Partition_Subsize (all 10 partition types)."""
    B = BlockSize
    b = B(bsize)
    # (NONE, HORZ, VERT, SPLIT, HORZ_A, HORZ_B, VERT_A, VERT_B, H4, V4)
    table = {
        B.BLOCK_4X4: (B.BLOCK_4X4,) + (None,) * 9,
        B.BLOCK_8X8: (B.BLOCK_8X8, B.BLOCK_8X4, B.BLOCK_4X8, B.BLOCK_4X4,
                      B.BLOCK_8X4, B.BLOCK_8X4, B.BLOCK_4X8, B.BLOCK_4X8,
                      None, None),
        B.BLOCK_16X16: (B.BLOCK_16X16, B.BLOCK_16X8, B.BLOCK_8X16,
                        B.BLOCK_8X8, B.BLOCK_16X8, B.BLOCK_16X8,
                        B.BLOCK_8X16, B.BLOCK_8X16, B.BLOCK_16X4,
                        B.BLOCK_4X16),
        B.BLOCK_32X32: (B.BLOCK_32X32, B.BLOCK_32X16, B.BLOCK_16X32,
                        B.BLOCK_16X16, B.BLOCK_32X16, B.BLOCK_32X16,
                        B.BLOCK_16X32, B.BLOCK_16X32, B.BLOCK_32X8,
                        B.BLOCK_8X32),
        B.BLOCK_64X64: (B.BLOCK_64X64, B.BLOCK_64X32, B.BLOCK_32X64,
                        B.BLOCK_32X32, B.BLOCK_64X32, B.BLOCK_64X32,
                        B.BLOCK_32X64, B.BLOCK_32X64, B.BLOCK_64X16,
                        B.BLOCK_16X64),
        B.BLOCK_128X128: (B.BLOCK_128X128, B.BLOCK_128X64, B.BLOCK_64X128,
                          B.BLOCK_64X64, B.BLOCK_128X64, B.BLOCK_128X64,
                          B.BLOCK_64X128, B.BLOCK_64X128, None, None),
    }
    sub = table[b][part]
    assert sub is not None, (bsize, part)
    return int(sub)


_max_tx_depth = _max_tx_depth_fn
_tx_size_cat = _tx_size_cat_fn


def _chroma_tx_size(bsize: int) -> int:
    """Max chroma tx for a 4:2:0 block: max rect tx of the ss'd bsize,
    capped at 32x32."""
    w = max(4, BLOCK_SIZE_WIDE[bsize] >> 1)
    h = max(4, BLOCK_SIZE_HIGH[bsize] >> 1)
    for ts in range(19):
        if TX_SIZE_WIDE[ts] == min(w, 32) and TX_SIZE_HIGH[ts] == min(h, 32):
            return ts
    raise ValueError((w, h))
