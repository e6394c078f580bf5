"""Tile symbol writer: partition tree, mode info, residuals + neighbor state.

Encoder mirror of the reference's per-tile entropy coding kernel
(ref: Source/Lib/Codec/ec_process.c:208, entropy_coding.c write_modes /
write_modes_b) driven by block records the encoder model produced. Maintains
every normative neighbor-context array (partition ctx, mode/skip rows,
per-plane packed coefficient contexts) so the emitted symbol+CDF sequence is
exactly what a conforming decoder expects.

One TileWriter per tile; tiles are independent (the TPU shard axis, SURVEY.md
§2.2 P4).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from svt_av1_psy_tpu_torch.constants import (BLOCK_SIZE_HIGH, BLOCK_SIZE_WIDE,
                                       BlockSize, Partition, PredMode, TxSize)
from svt_av1_psy_tpu_torch.entropy import coeff_coder as cc
from svt_av1_psy_tpu_torch.entropy.frame_context import FrameContext
from svt_av1_psy_tpu_torch.entropy.range_coder import RangeEncoder

# intra_mode_context (libaom): mode -> kf_y cdf context bucket
_INTRA_MODE_CTX = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]
# size_group_lookup
# min(3, min(log2(w4), log2(h4))) (ref definitions.h:1608)
_SIZE_GROUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
               0, 0, 1, 1, 2, 2]


def _neg_interleave(x: int, ref: int, mx: int) -> int:
    """neg_interleave (spec segment-id coding; inverse of the parser's
    _neg_deinterleave)."""
    d = x - ref
    if not ref:
        return x
    if ref >= mx - 1:
        return -x + mx - 1
    lim = ref if 2 * ref < mx else mx - ref - 1
    if abs(d) <= lim:
        return (d << 1) - 1 if d > 0 else (-d) << 1
    return x if 2 * ref < mx else (mx - 1) - x
_WIENER_TAP_SPEC2 = ((-5, 10, 1), (-23, 8, 2), (-17, 46, 3))

# partition ctx byte per block dimension (above uses width, left height);
# 5-bit scheme, bit (log2(dim4)-1) == "neighbor smaller than this size"
# (ref: definitions.h:1574 partition_context_lookup)
_PART_CTX = {4: 31, 8: 30, 16: 28, 32: 24, 64: 16, 128: 0}

# max_txsize_rect_lookup: largest tx for a block size (spec Max_Tx_Size_Rect)
MAX_TX_SIZE_RECT = [
    TxSize.TX_4X4, TxSize.TX_4X8, TxSize.TX_8X4, TxSize.TX_8X8,
    TxSize.TX_8X16, TxSize.TX_16X8, TxSize.TX_16X16, TxSize.TX_16X32,
    TxSize.TX_32X16, TxSize.TX_32X32, TxSize.TX_32X64, TxSize.TX_64X32,
    TxSize.TX_64X64, TxSize.TX_64X64, TxSize.TX_64X64, TxSize.TX_64X64,
    TxSize.TX_4X16, TxSize.TX_16X4, TxSize.TX_8X32, TxSize.TX_32X8,
    TxSize.TX_16X64, TxSize.TX_64X16,
]


def is_directional(mode: int) -> bool:
    return PredMode.V_PRED <= mode <= PredMode.D67_PRED


def use_angle_delta(bsize: int) -> bool:
    # spec av1_use_angle_delta: enum comparison (16x4/4x16 DO use deltas)
    return bsize >= int(BlockSize.BLOCK_8X8)


def has_chroma(mi_row: int, mi_col: int, bsize: int,
               ss_x: int = 1, ss_y: int = 1) -> bool:
    """spec 5.11.5 HasChroma for sub-8x8 blocks (chroma rides the last
    sibling of each 8x8 region in 4:2:0)."""
    bw4 = BLOCK_SIZE_WIDE[bsize] // 4
    bh4 = BLOCK_SIZE_HIGH[bsize] // 4
    return (((mi_row & 1) or not (bh4 & 1) or not ss_y) and
            ((mi_col & 1) or not (bw4 & 1) or not ss_x))


def cfl_allowed(bsize: int) -> bool:
    return (BLOCK_SIZE_WIDE[bsize] <= 32 and BLOCK_SIZE_HIGH[bsize] <= 32)


@dataclass
class TxbData:
    """One coded transform block: compact qcoeff + signaling info."""
    qcoeff: np.ndarray        # (ch, cw) int32, compact for 64-side
    tx_size: int
    tx_type: int


@dataclass
class BlockRecord:
    """One coded block (mode decision output) in coding order."""
    mi_row: int
    mi_col: int
    bsize: int
    y_mode: int
    uv_mode: int
    angle_delta_y: int = 0
    angle_delta_uv: int = 0
    skip: bool = False
    tx_size: int = -1                             # -1: largest for bsize
    cfl_joint_sign: int = -1                      # >=0 when uv_mode is CFL
    cfl_idx_u: int = 0
    cfl_idx_v: int = 0
    use_filter_intra: bool = False
    filter_intra_mode: int = 0
    # luma palette (spec 5.11.42/5.11.49): sorted color tuple + index map
    palette: tuple = None
    palette_map: object = None
    # intra block copy (spec 5.11.31): mv carries the DV (1/8 px, integer)
    use_intrabc: bool = False
    is_inter: bool = False
    ref_frame: int = 0
    mv: tuple = (0, 0)
    inter_mode: int = 0          # 0 NEARESTMV 1 NEARMV 2 GLOBALMV 3 NEWMV
    ref_mv_idx: int = 0
    interp_filters: tuple = (0, 0)
    txbs_y: list = field(default_factory=list)    # list[TxbData]
    txbs_u: list = field(default_factory=list)
    txbs_v: list = field(default_factory=list)
    # inter var-tx: luma leaf layout + split flags (spec 5.11.16)
    tx_leaves: list = None       # [(r_off4, c_off4, TxSize)]
    txfm_splits: list = None     # [0/1, ...] DFS order


class TileWriter:
    def __init__(self, fc: FrameContext, mi_rows: int, mi_cols: int,
                 sb_size: int = 64, ss_x: int = 1, ss_y: int = 1,
                 reduced_tx_set: bool = False, tx_mode_select: bool = False,
                 enable_filter_intra: bool = False, backend: str = "python",
                 cdef_bits: int = -1, frame_is_intra: bool = True,
                 allow_hp: bool = False, force_integer_mv: bool = False,
                 reference_select: bool = False,
                 switchable_filter: bool = False, dual_filter: bool = False,
                 enable_interintra: bool = False,
                 motion_mode_switchable: bool = False,
                 allow_warped_motion: bool = False,
                 skip_mode_present: bool = False,
                 gm_mv=None, seg=None, allow_screen_content: bool = False,
                 bd: int = 8, allow_intrabc: bool = False):
        self.fc = fc
        # per-ref precision-lowered global MV for the stack fill
        # (index 0 = LAST_FRAME); identity when the frame codes no gm
        self.gm_mv = list(gm_mv) if gm_mv is not None else [(0, 0)] * 7
        self.reduced_tx_set = reduced_tx_set
        self.tx_mode_select = tx_mode_select
        self.enable_filter_intra = enable_filter_intra
        self.backend = backend
        if backend == "native":
            from svt_av1_psy_tpu_torch.native import (NativeRangeEncoder,
                                                make_txb_cdfs)

            self.enc = NativeRangeEncoder()
            self._txb_cdfs = make_txb_cdfs(fc)
        else:
            self.enc = RangeEncoder()
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.sb_mi = sb_size // 4
        # segmentation (aq-mode 1): dict(last_active, map (mi int8));
        # written-state map mirrors what the decoder reconstructs (skip
        # blocks store the prediction, not the intended id)
        self.seg = seg
        if seg is not None:
            import numpy as _np
            self.seg_written = _np.zeros((mi_rows, mi_cols), _np.int8)
        # write_cdef state (spec 5.11.56); grid set via set_cdef_grid
        self.cdef_bits = cdef_bits
        self.cdef_grid = None
        self._cdef_done = np.zeros(((mi_rows + 15) // 16,
                                    (mi_cols + 15) // 16), bool)
        self.ss_x, self.ss_y = ss_x, ss_y
        self.frame_is_intra = frame_is_intra
        self.allow_hp = allow_hp
        self.force_integer_mv = force_integer_mv
        self.reference_select = reference_select
        self.switchable_filter = switchable_filter
        self.dual_filter = dual_filter
        self.enable_interintra = enable_interintra
        self.motion_mode_switchable = motion_mode_switchable
        self.allow_warped_motion = allow_warped_motion
        self.skip_mode_present = skip_mode_present
        self.allow_intrabc = allow_intrabc
        if not frame_is_intra or allow_intrabc:
            from svt_av1_psy_tpu_torch.inter.mvref import MiGrid
            self.grid = MiGrid(mi_rows, mi_cols)
            self.txtype_grid = np.zeros((mi_rows, mi_cols), np.uint8)
            self.above_skip_mode = np.zeros(mi_cols, np.uint8)
            self.left_skip_mode = np.zeros(mi_rows, np.uint8)
        # palette neighbor state (spec 5.11.42): covering block's luma
        # palette (sorted colors tuple) or None, per mi column/row
        self.allow_screen_content = allow_screen_content
        self.bd = bd
        self.above_pal = [None] * mi_cols
        self.left_pal = [None] * mi_rows
        # neighbor state
        self.above_part = np.zeros(mi_cols, np.uint8)
        self.left_part = np.zeros(mi_rows, np.uint8)
        self.above_mode = np.full(mi_cols, int(PredMode.DC_PRED), np.uint8)
        self.left_mode = np.full(mi_rows, int(PredMode.DC_PRED), np.uint8)
        self.above_skip = np.zeros(mi_cols, np.uint8)
        self.left_skip = np.zeros(mi_rows, np.uint8)
        self.above_txw = np.full(mi_cols, 64, np.int32)
        self.left_txh = np.full(mi_rows, 64, np.int32)
        # per-plane packed coefficient contexts (4-px units, chroma subsampled)
        self.above_coef = [np.zeros(mi_cols, np.uint8),
                           np.zeros((mi_cols + ss_x) >> ss_x, np.uint8),
                           np.zeros((mi_cols + ss_x) >> ss_x, np.uint8)]
        self.left_coef = [np.zeros(mi_rows, np.uint8),
                          np.zeros((mi_rows + ss_y) >> ss_y, np.uint8),
                          np.zeros((mi_rows + ss_y) >> ss_y, np.uint8)]

    # --- partition ------------------------------------------------------
    def _partition_bounds(self, mi_row, mi_col, bsize):
        h4 = BLOCK_SIZE_HIGH[bsize] // 4
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        has_rows = mi_row + (h4 >> 1) < self.mi_rows
        has_cols = mi_col + (w4 >> 1) < self.mi_cols
        return has_rows, has_cols

    @staticmethod
    def _gather_bool_icdf(part_icdf, vert_alike: bool, bsize: int):
        """2-symbol icdf for boundary split_or_{horz,vert} bools
        (ref: cabac_context_model.h:720-746). Returns prob-of-0 in icdf form
        where symbol 1 == PARTITION_SPLIT."""
        def elem(i):
            prev = 32768 if i == 0 else int(part_icdf[i - 1])
            return prev - int(part_icdf[i])

        if vert_alike:   # !has_rows: SPLIT vs HORZ
            members = [Partition.VERT, Partition.SPLIT, Partition.HORZ_A,
                       Partition.VERT_A, Partition.VERT_B]
            if bsize != int(BlockSize.BLOCK_128X128):
                members.append(Partition.VERT_4)
        else:            # !has_cols: SPLIT vs VERT
            members = [Partition.HORZ, Partition.SPLIT, Partition.HORZ_A,
                       Partition.HORZ_B, Partition.VERT_A]
            if bsize != int(BlockSize.BLOCK_128X128):
                members.append(Partition.HORZ_4)
        p0 = 32768 - sum(elem(int(m)) for m in members)
        return np.array([32768 - p0, 0, 0], np.uint16)

    def write_partition(self, mi_row: int, mi_col: int, bsize: int,
                        part: int):
        """Code the partition symbol at a square size >= 8x8 (spec 5.11.4),
        including frame-boundary forms."""
        if bsize < int(BlockSize.BLOCK_8X8):
            return                           # 4x4: no partition syntax
        has_rows, has_cols = self._partition_bounds(mi_row, mi_col, bsize)
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        bsl = (w4).bit_length() - 1          # 8x8 -> 1 ... 128 -> 5
        # neighbor-smaller bit lives at (bsl - 1) in the 5-bit ctx bytes
        # (ref: entropy_coding.c:4085 bsl = mi_size_wide_log2 - log2(8x8))
        above = (int(self.above_part[mi_col]) >> (bsl - 1)) & 1
        left = (int(self.left_part[mi_row]) >> (bsl - 1)) & 1
        ctx = (bsl - 1) * 4 + left * 2 + above
        if not has_rows and not has_cols:
            assert part == int(Partition.SPLIT)
            return
        if has_rows and has_cols:
            nsyms = 4 if bsl == 1 else (8 if bsl == 5 else 10)
            self.enc.encode_symbol(part, self.fc.partition[ctx], nsyms=nsyms,
                                   adapt=True)
        elif has_cols:          # bottom boundary: SPLIT or HORZ
            assert part in (int(Partition.SPLIT), int(Partition.HORZ))
            icdf = self._gather_bool_icdf(self.fc.partition[ctx], True, bsize)
            self.enc.encode_symbol(int(part == int(Partition.SPLIT)), icdf,
                                   nsyms=2, adapt=False)
        else:                   # right boundary: SPLIT or VERT
            assert part in (int(Partition.SPLIT), int(Partition.VERT))
            icdf = self._gather_bool_icdf(self.fc.partition[ctx], False,
                                          bsize)
            self.enc.encode_symbol(int(part == int(Partition.SPLIT)), icdf,
                                   nsyms=2, adapt=False)

    def write_delta_q(self, abs_q: int, sign: int):
        """read_delta_qindex mirror (spec 5.11.12)."""
        self.enc.encode_symbol(min(abs_q, 3) if abs_q < 3 else 3,
                               self.fc.delta_q, adapt=True)
        if abs_q >= 3:
            v = abs_q - 1
            rem = v.bit_length() - 1
            self.enc.encode_literal(rem - 1, 3)
            self.enc.encode_literal(v - (1 << rem), rem)
        if abs_q:
            self.enc.encode_literal(sign, 1)

    def update_partition_ctx(self, mi_row, mi_col, bsize, subsize):
        """After coding a non-SPLIT partition's blocks: context bytes cover
        the full bsize extent with the subsize pattern."""
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        h4 = BLOCK_SIZE_HIGH[bsize] // 4
        self.above_part[mi_col:mi_col + w4] = \
            _PART_CTX[BLOCK_SIZE_WIDE[subsize]]
        self.left_part[mi_row:mi_row + h4] = \
            _PART_CTX[BLOCK_SIZE_HIGH[subsize]]

    # --- mode info ------------------------------------------------------
    def write_block(self, b: BlockRecord, delta_q=None):
        """Write mode info + residual for one block (KEY-frame intra).

        delta_q: optional (abs, sign) written after skip (spec order:
        read_skip -> read_cdef -> read_delta_qindex)."""
        enc, fc = self.enc, self.fc
        r, c = b.mi_row, b.mi_col
        w4 = BLOCK_SIZE_WIDE[b.bsize] // 4
        h4 = BLOCK_SIZE_HIGH[b.bsize] // 4
        have_above = r > 0
        have_left = c > 0

        if self.skip_mode_present and not self.frame_is_intra and \
                min(BLOCK_SIZE_WIDE[b.bsize], BLOCK_SIZE_HIGH[b.bsize]) >= 8:
            smctx = int(self.above_skip_mode[c]) + \
                int(self.left_skip_mode[r])
            enc.encode_symbol(0, fc.skip_mode[smctx], adapt=True)
            self.above_skip_mode[c:c + w4] = 0
            self.left_skip_mode[r:r + h4] = 0

        # skip (coded first in intra_frame_mode_info, spec 5.11.8)
        skip_ctx = int(self.above_skip[c]) + int(self.left_skip[r])
        enc.encode_symbol(int(b.skip), fc.skip[skip_ctx], adapt=True)

        # segment id (spec 5.11.14, SegIdPreSkip=0 shape): spatial
        # neg-interleave coding vs the UL/U/L prediction
        if self.seg is not None:
            sm = self.seg_written
            au, al = r > 0, c > 0
            p_ul = int(sm[r - 1, c - 1]) if (au and al) else -1
            p_u = int(sm[r - 1, c]) if au else -1
            p_l = int(sm[r, c - 1]) if al else -1
            if p_u == -1:
                pred = 0 if p_l == -1 else p_l
            elif p_l == -1:
                pred = p_u
            else:
                pred = p_u if p_ul == p_u else p_l
            if b.skip:
                sm[r:r + h4, c:c + w4] = pred
            else:
                if p_ul < 0:
                    ctx = 0
                elif p_ul == p_u and p_ul == p_l:
                    ctx = 2
                elif p_ul == p_u or p_ul == p_l or p_u == p_l:
                    ctx = 1
                else:
                    ctx = 0
                want = int(self.seg["map"][r, c])
                coded = _neg_interleave(want, pred,
                                        self.seg["last_active"] + 1)
                enc.encode_symbol(coded, fc.seg_id[ctx], adapt=True)
                sm[r:r + h4, c:c + w4] = want

        # write_cdef (spec 5.11.56): first non-skip block per 64x64
        if self.cdef_bits >= 0 and not b.skip:
            r64, c64 = r >> 4, c >> 4
            if not self._cdef_done[r64, c64]:
                v = 0 if self.cdef_grid is None else \
                    int(self.cdef_grid[r64, c64])
                enc.encode_literal(v, self.cdef_bits)
                self._cdef_done[r64:min((r + h4 + 15) >> 4,
                                        self._cdef_done.shape[0]),
                                c64:min((c + w4 + 15) >> 4,
                                        self._cdef_done.shape[1])] = True

        if delta_q is not None:
            self.write_delta_q(delta_q[0], delta_q[1])

        # use_intrabc (spec 5.11.31; mirror of the parser order: after
        # skip/seg/cdef/delta_q, before everything else)
        if self.frame_is_intra and self.allow_intrabc:
            enc.encode_symbol(int(b.use_intrabc), fc.intrabc, adapt=True)
            if b.use_intrabc:
                self._write_intrabc_info(b)
                return

        if not self.frame_is_intra:
            from svt_av1_psy_tpu_torch.inter import mvref as mvh
            ii_ctx = mvh.intra_inter_ctx(self.grid, r, c)
            enc.encode_symbol(int(b.is_inter), fc.intra_inter[ii_ctx],
                              adapt=True)
            if b.is_inter:
                self._write_inter_info(b)
                return

        # y mode (kf_y_cdf with above/left mode contexts on KEY frames,
        # size-group y_mode_cdf on inter frames)
        if self.frame_is_intra:
            am = int(self.above_mode[c]) if have_above \
                else int(PredMode.DC_PRED)
            lm = int(self.left_mode[r]) if have_left \
                else int(PredMode.DC_PRED)
            enc.encode_symbol(
                b.y_mode,
                fc.kf_y[_INTRA_MODE_CTX[am]][_INTRA_MODE_CTX[lm]],
                adapt=True)
        else:
            enc.encode_symbol(b.y_mode, fc.y_mode[_SIZE_GROUP[b.bsize]],
                              adapt=True)
        if is_directional(b.y_mode) and use_angle_delta(b.bsize):
            enc.encode_symbol(b.angle_delta_y + 3,
                              fc.angle_delta[b.y_mode - PredMode.V_PRED],
                              adapt=True)

        # uv mode (only when this block carries chroma, spec 5.11.5)
        hc = has_chroma(r, c, b.bsize, self.ss_x, self.ss_y)
        cfl_ok = cfl_allowed(b.bsize)
        if hc:
            enc.encode_symbol(b.uv_mode, fc.uv_mode[int(cfl_ok)][b.y_mode],
                              nsyms=14 if cfl_ok else 13, adapt=True)
        if not hc:
            pass
        elif b.uv_mode == PredMode.UV_CFL_PRED:
            js = b.cfl_joint_sign
            enc.encode_symbol(js, fc.cfl_sign, adapt=True)
            sign_u = ((js + 1) * 11) >> 5
            sign_v = (js + 1) - 3 * sign_u
            if sign_u != 0:
                enc.encode_symbol(b.cfl_idx_u, fc.cfl_alpha[js + 1 - 3],
                                  adapt=True)
            if sign_v != 0:
                enc.encode_symbol(b.cfl_idx_v,
                                  fc.cfl_alpha[sign_v * 3 + sign_u - 3],
                                  adapt=True)
        elif is_directional(b.uv_mode) and use_angle_delta(b.bsize):
            enc.encode_symbol(b.angle_delta_uv + 3,
                              fc.angle_delta[b.uv_mode - PredMode.V_PRED],
                              adapt=True)

        # palette_mode_info (spec 5.11.42; mirror of
        # TileParser._parse_intra_block): luma palette for DC blocks
        # 8x8..64x64 when screen content tools are on
        if self.allow_screen_content and b.bsize >= 3 \
                and BLOCK_SIZE_WIDE[b.bsize] <= 64 \
                and BLOCK_SIZE_HIGH[b.bsize] <= 64:
            bctx = (BLOCK_SIZE_WIDE[b.bsize].bit_length() +
                    BLOCK_SIZE_HIGH[b.bsize].bit_length() - 2) - 6
            if b.y_mode == int(PredMode.DC_PRED):
                pctx = int(have_above and
                           self.above_pal[c] is not None) + \
                    int(have_left and self.left_pal[r] is not None)
                enc.encode_symbol(int(b.palette is not None),
                                  fc.palette_y_mode[bctx][pctx], adapt=True)
                if b.palette is not None:
                    enc.encode_symbol(len(b.palette) - 2,
                                      fc.palette_y_size[bctx], adapt=True)
                    self._write_palette_colors_y(r, c, b.palette)
            if hc and b.uv_mode == int(PredMode.DC_PRED):
                enc.encode_symbol(
                    0, fc.palette_uv_mode[int(b.palette is not None)],
                    adapt=True)

        # filter intra flag (seq-gated; only DC blocks <= 32x32)
        if (self.enable_filter_intra and b.y_mode == int(PredMode.DC_PRED)
                and b.palette is None
                and BLOCK_SIZE_WIDE[b.bsize] <= 32
                and BLOCK_SIZE_HIGH[b.bsize] <= 32):
            enc.encode_symbol(int(b.use_filter_intra),
                              fc.filter_intra[b.bsize], adapt=True)
            if b.use_filter_intra:
                enc.encode_symbol(b.filter_intra_mode, fc.filter_intra_mode,
                                  adapt=True)

        # palette_tokens (spec 5.11.49): color index map, coded after
        # mode info and before the tx-size symbols (spec decode_block)
        if b.palette is not None:
            self._write_palette_map(b)

        # tx size (TX_MODE_SELECT intra depth coding, spec 5.11.15)
        tx_size = b.tx_size if b.tx_size >= 0 else int(MAX_TX_SIZE_RECT[b.bsize])
        # intra blocks read tx depth even when skip (spec read_tx_size:
        # allowSelect = !skip || !is_inter)
        if self.tx_mode_select and b.bsize > int(BlockSize.BLOCK_4X4):
            from svt_av1_psy_tpu_torch.entropy.tx_trees import (SUB_TX, max_tx_depth,
                                                          tx_size_cat)
            max_d = max_tx_depth(b.bsize)
            if max_d > 0:
                depth = 0
                t = int(MAX_TX_SIZE_RECT[b.bsize])
                while t != tx_size:
                    t = int(SUB_TX[t])
                    depth += 1
                    assert depth <= max_d, (b.bsize, tx_size)
                cat = tx_size_cat(b.bsize)
                ctx = self._tx_size_ctx(r, c, b.bsize)
                enc.encode_symbol(depth, fc.tx_size[cat][ctx],
                                  nsyms=max_d + 1, adapt=True)

        # neighbor updates for mode/skip/txfm
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        self.above_txw[c:c + w4] = TX_SIZE_WIDE[tx_size]
        self.left_txh[r:r + h4] = TX_SIZE_HIGH[tx_size]
        self.above_mode[c:c + w4] = b.y_mode
        self.left_mode[r:r + h4] = b.y_mode
        self.above_skip[c:c + w4] = int(b.skip)
        self.left_skip[r:r + h4] = int(b.skip)
        if self.allow_screen_content:
            self.above_pal[c:c + w4] = [b.palette] * w4
            self.left_pal[r:r + h4] = [b.palette] * h4

        if not self.frame_is_intra:
            self.grid.set_block(b.mi_row, b.mi_col, h4, w4, b.bsize, 0, -1,
                                (0, 0), (0, 0), False)

        # residual
        if b.skip:
            self._reset_skip_context(b)
            return
        self._write_residual(b)

    def _write_mv_component(self, comp: int, val: int, tabs=None,
                            integer: bool = False):
        """encode_mv_component (spec 5.11.32 mirror). tabs/integer select
        the intrabc DV context instance at MV_SUBPEL_NONE precision."""
        enc, fc = self.enc, self.fc
        if tabs is None:
            tabs = fc.nmv_comp
        pre = f"comp{comp}_"
        sign = 1 if val < 0 else 0
        mag = -val if sign else val
        enc.encode_symbol(sign, tabs[pre + "sign_cdf"], adapt=True)
        off = mag - 1
        cls = 0
        while cls < 10:
            base = 0 if cls == 0 else (2 << (cls + 2))
            size = 16 if cls == 0 else (2 << (cls + 2))
            if base <= off < base + size:
                break
            cls += 1
        enc.encode_symbol(cls, tabs[pre + "classes_cdf"], adapt=True)
        rem = off if cls == 0 else off - (2 << (cls + 2))
        hp = rem & 1
        fr = (rem >> 1) & 3
        d = rem >> 3
        if cls == 0:
            enc.encode_symbol(d, tabs[pre + "class0_cdf"], adapt=True)
        else:
            for bpos in range(cls):
                enc.encode_symbol((d >> bpos) & 1,
                                  tabs[pre + "bits_cdf"][bpos],
                                  adapt=True)
        if not integer and not self.force_integer_mv:
            if cls == 0:
                enc.encode_symbol(fr, tabs[pre + "class0_fp_cdf"][d],
                                  adapt=True)
            else:
                enc.encode_symbol(fr, tabs[pre + "fp_cdf"],
                                  adapt=True)
            if self.allow_hp:
                enc.encode_symbol(hp, tabs[
                    pre + ("class0_hp_cdf" if cls == 0 else "hp_cdf")],
                    adapt=True)

    def _write_mv(self, mv, pred):
        dr = mv[0] - pred[0]
        dc = mv[1] - pred[1]
        joint = (2 if dr else 0) | (1 if dc else 0)
        self.enc.encode_symbol(joint, self.fc.nmv_joints, adapt=True)
        if dr:
            self._write_mv_component(0, dr)
        if dc:
            self._write_mv_component(1, dc)

    def _write_dv(self, dv, pred):
        """write_mv for intrabc (mirror of TileParser._read_dv): the DV
        coder uses its own NMV context at integer precision."""
        fc = self.fc
        dr = dv[0] - pred[0]
        dc = dv[1] - pred[1]
        joint = (2 if dr else 0) | (1 if dc else 0)
        self.enc.encode_symbol(joint, fc.dv_joints, adapt=True)
        if dr:
            self._write_mv_component(0, dr, tabs=fc.dv_comp, integer=True)
        if dc:
            self._write_mv_component(1, dc, tabs=fc.dv_comp, integer=True)

    def dv_pred(self, r: int, c: int, bsize: int):
        """The DV predictor the parser will derive at this block (spec
        assign_mv intrabc branch incl. the default-DV rule)."""
        from svt_av1_psy_tpu_torch.inter.mvref import setup_ref_mv_list
        refs = setup_ref_mv_list(self.grid, r, c, bsize, 0,
                                 sb_mi=self.sb_mi, ibc=True)
        pred = refs.stack[0] if refs.stack else (0, 0)
        if pred == (0, 0):
            if r - self.sb_mi < 0:
                pred = (0, -(self.sb_mi * 4 + 256) * 8)
            else:
                pred = (-(self.sb_mi * 4 * 8), 0)
        return pred

    def _write_intrabc_info(self, b: BlockRecord):
        """Mode info + residual of a use_intrabc block (mirror of
        TileParser._parse_intrabc_block)."""
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        r, c = b.mi_row, b.mi_col
        w4 = BLOCK_SIZE_WIDE[b.bsize] // 4
        h4 = BLOCK_SIZE_HIGH[b.bsize] // 4
        self._write_dv(b.mv, self.dv_pred(r, c, b.bsize))

        tx_size = int(MAX_TX_SIZE_RECT[b.bsize])
        if self.tx_mode_select and not b.skip:
            splits = iter(b.txfm_splits or ())
            mw4 = TX_SIZE_WIDE[tx_size] // 4
            mh4 = TX_SIZE_HIGH[tx_size] // 4
            for i in range(0, h4, mh4):
                for j in range(0, w4, mw4):
                    self._write_var_tx(b, tx_size, 0, i, j, splits)
        else:
            self.above_txw[c:c + w4] = TX_SIZE_WIDE[tx_size]
            self.left_txh[r:r + h4] = TX_SIZE_HIGH[tx_size]
        self.above_mode[c:c + w4] = int(PredMode.DC_PRED)
        self.left_mode[r:r + h4] = int(PredMode.DC_PRED)
        self.above_skip[c:c + w4] = int(b.skip)
        self.left_skip[r:r + h4] = int(b.skip)
        if self.allow_screen_content:
            self.above_pal[c:c + w4] = [None] * w4
            self.left_pal[r:r + h4] = [None] * h4
        self.grid.set_block(r, c, h4, w4, b.bsize, 0, -1, b.mv, (0, 0),
                            True)
        self.grid.ibc[r:r + h4, c:c + w4] = 1
        if b.skip:
            self._reset_skip_context(b)
            return
        self._write_residual(b)

    def rate_intrabc_flag(self, on: bool) -> float:
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        return sym_cost(self.fc.intrabc, int(on))

    def rate_dv(self, dv, pred) -> float:
        """Approximate DV rate (joint + per-component class/offset bits
        from the live DV CDFs; fractional bits absent at integer
        precision)."""
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        fc = self.fc
        dr = dv[0] - pred[0]
        dc = dv[1] - pred[1]
        joint = (2 if dr else 0) | (1 if dc else 0)
        bits = sym_cost(fc.dv_joints, joint)
        for comp, val in ((0, dr), (1, dc)):
            if not val:
                continue
            pre = f"comp{comp}_"
            mag = abs(val)
            off = mag - 1
            cls = 0
            while cls < 10:
                base = 0 if cls == 0 else (2 << (cls + 2))
                size = 16 if cls == 0 else (2 << (cls + 2))
                if base <= off < base + size:
                    break
                cls += 1
            bits += sym_cost(fc.dv_comp[pre + "sign_cdf"], int(val < 0))
            bits += sym_cost(fc.dv_comp[pre + "classes_cdf"], cls)
            d = (off if cls == 0 else off - (2 << (cls + 2))) >> 3
            if cls == 0:
                bits += sym_cost(fc.dv_comp[pre + "class0_cdf"], d)
            else:
                for bpos in range(cls):
                    bits += sym_cost(fc.dv_comp[pre + "bits_cdf"][bpos],
                                     (d >> bpos) & 1)
        return bits

    def _write_inter_info(self, b: BlockRecord):
        from svt_av1_psy_tpu_torch.inter import mvref as mvh
        enc, fc = self.enc, self.fc
        r, c = b.mi_row, b.mi_col
        w4 = BLOCK_SIZE_WIDE[b.bsize] // 4
        h4 = BLOCK_SIZE_HIGH[b.bsize] // 4
        ref = b.ref_frame
        g = self.grid

        if self.reference_select and min(BLOCK_SIZE_WIDE[b.bsize],
                                         BLOCK_SIZE_HIGH[b.bsize]) >= 8:
            enc.encode_symbol(0, fc.comp_inter[
                mvh.reference_mode_ctx(g, r, c)], adapt=True)
        # single ref tree (LAST..ALTREF), contexts from neighbor counts
        cnt = mvh.neighbor_ref_counts(g, r, c)
        fwd = cnt[1] + cnt[2] + cnt[3] + cnt[4]
        bwd = cnt[5] + cnt[6] + cnt[7]
        enc.encode_symbol(int(ref >= 5),
                          fc.single_ref[mvh.ctx3(fwd, bwd)][0], adapt=True)
        if ref >= 5:
            enc.encode_symbol(int(ref == 7),
                              fc.single_ref[mvh.ctx3(cnt[5] + cnt[6],
                                                     cnt[7])][1], adapt=True)
            if ref != 7:
                enc.encode_symbol(int(ref == 6),
                                  fc.single_ref[mvh.ctx3(cnt[5],
                                                         cnt[6])][5],
                                  adapt=True)
        else:
            enc.encode_symbol(int(ref >= 3),
                              fc.single_ref[mvh.ctx3(cnt[1] + cnt[2],
                                                     cnt[3] + cnt[4])][2],
                              adapt=True)
            if ref >= 3:
                enc.encode_symbol(int(ref == 4),
                                  fc.single_ref[mvh.ctx3(cnt[3],
                                                         cnt[4])][4],
                                  adapt=True)
            else:
                enc.encode_symbol(int(ref == 2),
                                  fc.single_ref[mvh.ctx3(cnt[1],
                                                         cnt[2])][3],
                                  adapt=True)

        refs = mvh.setup_ref_mv_list(g, r, c, b.bsize, ref,
                                     sb_mi=self.sb_mi,
                                     gm_mv=self.gm_mv[ref - 1])
        mode = b.inter_mode
        enc.encode_symbol(int(mode != 3), fc.newmv[refs.newmv_ctx],
                          adapt=True)
        if mode != 3:
            enc.encode_symbol(int(mode != 2), fc.zeromv[refs.zeromv_ctx],
                              adapt=True)
            if mode != 2:
                enc.encode_symbol(int(mode != 0), fc.refmv[refs.refmv_ctx],
                                  adapt=True)
        # DRL
        if mode == 3:
            for idx in range(2):
                if refs.count > idx + 1:
                    bit = int(b.ref_mv_idx != idx)
                    enc.encode_symbol(
                        bit, fc.drl[mvh.drl_ctx(refs.weights, idx)],
                        adapt=True)
                    if not bit:
                        break
        elif mode == 1:
            for idx in range(1, 3):
                if refs.count > idx + 1:
                    bit = int(b.ref_mv_idx != idx)
                    enc.encode_symbol(
                        bit, fc.drl[mvh.drl_ctx(refs.weights, idx)],
                        adapt=True)
                    if not bit:
                        break
        if mode == 3:
            pos = b.ref_mv_idx if refs.count > 1 else 0
            pred = mvh.lower_mv_precision(refs.stack[pos], self.allow_hp,
                                          self.force_integer_mv)
            self._write_mv(b.mv, pred)

        # interintra (always off in our streams; symbol still coded when
        # the sequence enables the tool)
        if self.enable_interintra and \
                8 <= BLOCK_SIZE_WIDE[b.bsize] <= 32 and \
                8 <= BLOCK_SIZE_HIGH[b.bsize] <= 32:
            enc.encode_symbol(0, fc.interintra[_SIZE_GROUP[b.bsize]],
                              adapt=True)
        # motion mode
        if self.motion_mode_switchable and \
                min(BLOCK_SIZE_WIDE[b.bsize],
                    BLOCK_SIZE_HIGH[b.bsize]) >= 8 and \
                mvh.has_overlappable(g, r, c, w4, h4):
            nsamp = mvh.count_warp_samples(g, r, c, b.bsize, ref, b.mv)
            if self.force_integer_mv or nsamp == 0 or \
                    not self.allow_warped_motion:
                enc.encode_symbol(0, fc.obmc[b.bsize], adapt=True)
            else:
                enc.encode_symbol(0, fc.motion_mode[b.bsize], adapt=True)
        # interp filter
        if self.switchable_filter:
            ndirs = 2 if self.dual_filter else 1
            for d in range(ndirs):
                ctx = mvh.interp_filter_ctx(g, r, c, ref, d)
                enc.encode_symbol(b.interp_filters[d],
                                  fc.switchable_interp[ctx], adapt=True)

        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        tx_size = int(MAX_TX_SIZE_RECT[b.bsize])
        if self.tx_mode_select and not b.skip:
            # write_tx_size_vartx (ref entropy_coding.c:4389): replay the
            # recorded split flags over max-tx units
            splits = iter(b.txfm_splits or ())
            mw4 = TX_SIZE_WIDE[tx_size] // 4
            mh4 = TX_SIZE_HIGH[tx_size] // 4
            for i in range(0, h4, mh4):
                for j in range(0, w4, mw4):
                    self._write_var_tx(b, tx_size, 0, i, j, splits)
        else:
            self.above_txw[c:c + w4] = TX_SIZE_WIDE[tx_size]
            self.left_txh[r:r + h4] = TX_SIZE_HIGH[tx_size]
        self.above_mode[c:c + w4] = int(PredMode.DC_PRED)
        self.left_mode[r:r + h4] = int(PredMode.DC_PRED)
        self.above_skip[c:c + w4] = int(b.skip)
        self.left_skip[r:r + h4] = int(b.skip)
        if self.allow_screen_content:
            self.above_pal[c:c + w4] = [None] * w4
            self.left_pal[r:r + h4] = [None] * h4
        g.set_block(r, c, h4, w4, b.bsize, ref, -1, b.mv, (0, 0),
                    b.inter_mode == 3, filters=b.interp_filters)

        if b.skip:
            self._reset_skip_context(b)
            return
        self._write_residual(b)

    def _reset_skip_context(self, b: BlockRecord):
        r, c = b.mi_row, b.mi_col
        w4 = BLOCK_SIZE_WIDE[b.bsize] // 4
        h4 = BLOCK_SIZE_HIGH[b.bsize] // 4
        self.above_coef[0][c:c + w4] = 0
        self.left_coef[0][r:r + h4] = 0
        # chroma ctx reset only for chroma-bearing blocks
        # (ref entropy_coding.c:4111 resets uv only if blk_geom->has_uv)
        if has_chroma(r, c, b.bsize, self.ss_x, self.ss_y):
            cw4 = max(1, w4 >> self.ss_x)
            ch4 = max(1, h4 >> self.ss_y)
            for p in (1, 2):
                self.above_coef[p][(c >> self.ss_x):(c >> self.ss_x) + cw4] = 0
                self.left_coef[p][(r >> self.ss_y):(r >> self.ss_y) + ch4] = 0

    def _txfm_split_ctx(self, r, c, bsize, tx) -> int:
        """txfm_partition ctx (ref entropy_coding.c:4367)."""
        from svt_av1_psy_tpu_torch.constants import (TX_SIZE_HIGH, TX_SIZE_SQR_UP,
                                               TX_SIZE_WIDE)
        txw, txh = TX_SIZE_WIDE[tx], TX_SIZE_HIGH[tx]
        above = int(int(self.above_txw[c]) < txw)
        left = int(int(self.left_txh[r]) < txh)
        dim = max(BLOCK_SIZE_WIDE[bsize], BLOCK_SIZE_HIGH[bsize])
        max_tx = {64: 4, 32: 3, 16: 2, 8: 1}.get(dim, 0)
        cat = int(int(TX_SIZE_SQR_UP[tx]) != max_tx and max_tx > 1) + \
            (4 - max_tx) * 2
        return cat * 3 + above + left

    def _write_var_tx(self, b, tx, depth, r_off, c_off, splits):
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        from svt_av1_psy_tpu_torch.entropy.tx_trees import SUB_TX
        r = b.mi_row + r_off
        c = b.mi_col + c_off
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        w4 = TX_SIZE_WIDE[tx] // 4
        h4 = TX_SIZE_HIGH[tx] // 4
        if depth == 2 or tx == 0:                 # MAX_VARTX_DEPTH / 4x4
            split = 0
        else:
            ctx = self._txfm_split_ctx(r, c, b.bsize, tx)
            split = next(splits)
            self.enc.encode_symbol(split, self.fc.txfm_partition[ctx],
                                   adapt=True)
        if split:
            sub = int(SUB_TX[tx])
            if sub == 0:                          # terminal 4x4 split
                self.above_txw[c:c + w4] = 4
                self.left_txh[r:r + h4] = 4
                return
            sh4 = TX_SIZE_HIGH[sub] // 4
            sw4 = TX_SIZE_WIDE[sub] // 4
            for i in range(0, h4, sh4):
                for j in range(0, w4, sw4):
                    self._write_var_tx(b, sub, depth + 1,
                                       r_off + i, c_off + j, splits)
        else:
            self.above_txw[c:c + w4] = TX_SIZE_WIDE[tx]
            self.left_txh[r:r + h4] = TX_SIZE_HIGH[tx]

    # --- residual -------------------------------------------------------
    def _write_residual(self, b: BlockRecord):
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE

        hc = has_chroma(b.mi_row, b.mi_col, b.bsize, self.ss_x, self.ss_y)
        planes = ((0, b.txbs_y), (1, b.txbs_u), (2, b.txbs_v)) if hc \
            else ((0, b.txbs_y),)
        for plane, txbs in planes:
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            base_c = b.mi_col >> ss_x
            base_r = b.mi_row >> ss_y
            if plane == 0 and b.tx_leaves is not None:
                # inter var-tx: txbs_y follow the tree's leaf layout
                for (ly, lx, _), txb in zip(b.tx_leaves, txbs):
                    self._write_txb(0, b, txb, base_r + ly, base_c + lx)
                continue
            # raster order of tx blocks within the plane block
            off_c = 0
            off_r = 0
            plane_w4 = max(1, (BLOCK_SIZE_WIDE[b.bsize] // 4) >> ss_x)
            for txb in txbs:
                tw4 = TX_SIZE_WIDE[txb.tx_size] // 4
                th4 = TX_SIZE_HIGH[txb.tx_size] // 4
                self._write_txb(plane, b, txb, base_r + off_r, base_c + off_c)
                off_c += tw4
                if off_c >= plane_w4:
                    off_c = 0
                    off_r += th4

    def _write_txb(self, plane: int, b: BlockRecord, txb: TxbData,
                   u_row: int, u_col: int):
        """u_row/u_col: position in the plane's 4-px unit grid."""
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE

        enc, fc = self.enc, self.fc
        tw4 = TX_SIZE_WIDE[txb.tx_size] // 4
        th4 = TX_SIZE_HIGH[txb.tx_size] // 4
        above = self.above_coef[plane][u_col:u_col + tw4]
        left = self.left_coef[plane][u_row:u_row + th4]
        ptype = 1 if plane else 0
        txs_ctx = cc.txs_entropy_ctx(txb.tx_size)

        bw = BLOCK_SIZE_WIDE[b.bsize] >> (self.ss_x if plane else 0)
        bh = BLOCK_SIZE_HIGH[b.bsize] >> (self.ss_y if plane else 0)
        covers = (TX_SIZE_WIDE[txb.tx_size] >= bw and
                  TX_SIZE_HIGH[txb.tx_size] >= bh)
        larger = (bw * bh >
                  TX_SIZE_WIDE[txb.tx_size] * TX_SIZE_HIGH[txb.tx_size])
        sctx = cc.txb_skip_ctx(above, left, plane, covers, larger)

        all_zero = not np.any(txb.qcoeff)
        enc.encode_symbol(int(all_zero), fc.txb_skip[txs_ctx][sctx],
                          adapt=True)
        tw4_u = TX_SIZE_WIDE[txb.tx_size] // 4
        th4_u = TX_SIZE_HIGH[txb.tx_size] // 4
        if all_zero:
            if plane == 0 and not self.frame_is_intra:
                self.txtype_grid[u_row:u_row + th4_u,
                                 u_col:u_col + tw4_u] = 0
            cul = 0
        else:
            if plane == 0 and not b.is_inter:
                from svt_av1_psy_tpu_torch.entropy.tx_sets import (
                    EXT_TX_FWD, EXT_TX_SET_SIZES, FIMODE_TO_INTRADIR,
                    intra_tx_set)
                from svt_av1_psy_tpu_torch.constants import TX_SIZE_SQR
                tx_set = intra_tx_set(txb.tx_size, self.reduced_tx_set)
                if tx_set > 0:
                    sym = EXT_TX_FWD[tx_set][txb.tx_type]
                    mode = (FIMODE_TO_INTRADIR[b.filter_intra_mode]
                            if b.use_filter_intra else b.y_mode)
                    enc.encode_symbol(
                        sym,
                        fc.intra_ext_tx[tx_set][TX_SIZE_SQR[txb.tx_size]]
                        [mode],
                        nsyms=EXT_TX_SET_SIZES[tx_set], adapt=True)
                else:
                    assert txb.tx_type == 0, "DCT-only set"
            elif plane == 0:
                from svt_av1_psy_tpu_torch.entropy.tx_sets import (
                    EXT_TX_SET_TYPE_FWD, EXT_TX_SET_TYPE_SIZES,
                    EXT_TX_SET_TYPE_TO_IDX_INTER, inter_tx_set_type)
                from svt_av1_psy_tpu_torch.constants import TX_SIZE_SQR
                st = inter_tx_set_type(txb.tx_size, self.reduced_tx_set)
                if st > 0:
                    sidx = EXT_TX_SET_TYPE_TO_IDX_INTER[st]
                    enc.encode_symbol(
                        EXT_TX_SET_TYPE_FWD[st][txb.tx_type],
                        fc.inter_ext_tx[sidx][TX_SIZE_SQR[txb.tx_size]],
                        nsyms=EXT_TX_SET_TYPE_SIZES[st], adapt=True)
                else:
                    assert txb.tx_type == 0, "DCT-only inter set"
            if plane == 0 and not self.frame_is_intra:
                self.txtype_grid[u_row:u_row + th4_u,
                                 u_col:u_col + tw4_u] = txb.tx_type
            sgn_ctx = cc.dc_sign_ctx(above, left)
            if self.backend == "native":
                from svt_av1_psy_tpu_torch.constants import get_scan
                from svt_av1_psy_tpu_torch.ops.quant import adjusted_tx_size
                adj = adjusted_tx_size(txb.tx_size)
                w_, h_ = TX_SIZE_WIDE[adj], TX_SIZE_HIGH[adj]
                cul = enc.encode_txb(
                    self._txb_cdfs, txb.qcoeff, get_scan(txb.tx_size,
                                                         txb.tx_type),
                    w_, h_, TX_SIZE_WIDE[txb.tx_size],
                    TX_SIZE_HIGH[txb.tx_size],
                    cc.eob_multi_size(txb.tx_size), txs_ctx,
                    cc.tx_class_of(txb.tx_type), ptype, sgn_ctx)
            else:
                cul = cc.encode_txb(enc, fc, txb.qcoeff, txb.tx_size,
                                    txb.tx_type, ptype, sctx, sgn_ctx)
        self.above_coef[plane][u_col:u_col + tw4] = cul
        self.left_coef[plane][u_row:u_row + th4] = cul

    # --- rate estimation (encoder RD; bits, exact from live CDFs) --------
    def rate_partition(self, mi_row: int, mi_col: int, bsize: int,
                       part: int) -> float:
        """Partition symbol rate; 0 for forced (boundary) splits."""
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        if bsize < int(BlockSize.BLOCK_8X8):
            return 0.0
        has_rows, has_cols = self._partition_bounds(mi_row, mi_col, bsize)
        if not (has_rows and has_cols):
            return 0.0
        w4 = BLOCK_SIZE_WIDE[bsize] // 4
        bsl = (w4).bit_length() - 1
        above = (int(self.above_part[mi_col]) >> (bsl - 1)) & 1
        left = (int(self.left_part[mi_row]) >> (bsl - 1)) & 1
        ctx = (bsl - 1) * 4 + left * 2 + above
        return sym_cost(self.fc.partition[ctx], part)

    def rate_skip(self, r: int, c: int, skip: bool) -> float:
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        ctx = int(self.above_skip[c]) + int(self.left_skip[r])
        return sym_cost(self.fc.skip[ctx], int(skip))

    def rate_y_mode(self, r: int, c: int, mode: int) -> float:
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        am = int(self.above_mode[c]) if r > 0 else int(PredMode.DC_PRED)
        lm = int(self.left_mode[r]) if c > 0 else int(PredMode.DC_PRED)
        return sym_cost(
            self.fc.kf_y[_INTRA_MODE_CTX[am]][_INTRA_MODE_CTX[lm]], mode)

    def rate_angle_delta(self, mode: int, delta: int) -> float:
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        return sym_cost(self.fc.angle_delta[mode - int(PredMode.V_PRED)],
                        delta + 3)

    def rate_uv_mode(self, bsize: int, y_mode: int, uv_mode: int) -> float:
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        return sym_cost(self.fc.uv_mode[int(cfl_allowed(bsize))][y_mode],
                        uv_mode)

    def rate_cfl_alphas(self, joint_sign: int, idx_u: int,
                        idx_v: int) -> float:
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        bits = sym_cost(self.fc.cfl_sign, joint_sign)
        sign_u = ((joint_sign + 1) * 11) >> 5
        sign_v = (joint_sign + 1) - 3 * sign_u
        if sign_u != 0:
            bits += sym_cost(self.fc.cfl_alpha[joint_sign + 1 - 3], idx_u)
        if sign_v != 0:
            bits += sym_cost(self.fc.cfl_alpha[sign_v * 3 + sign_u - 3],
                             idx_v)
        return bits

    # --- palette (spec 5.11.42 / 5.11.49; mirror of the parser) -----------
    def _pal_cache(self, r: int, c: int):
        from svt_av1_psy_tpu_torch.entropy.palette import merge_color_cache
        above = self.above_pal[c] if ((r * 4) % 64) and r > 0 else None
        left = self.left_pal[r] if c > 0 else None
        return merge_color_cache(above, left)

    def _write_palette_colors_y(self, r: int, c: int, colors):
        """write_palette_colors_y: cache reuse flags + delta coding of
        the new colors (inverse of TileParser._read_palette_colors_y)."""
        from svt_av1_psy_tpu_torch.entropy.palette import (ceil_log2,
                                                     plan_color_coding)
        enc = self.enc
        plan = plan_color_coding(colors, self._pal_cache(r, c), self.bd)
        assert plan is not None, "palette colors not representable"
        flags, new, bits_extra, _ = plan
        for f in flags:
            enc.encode_literal(f, 1)
        if new:
            bd = self.bd
            enc.encode_literal(new[0], bd)
            if len(new) > 1:
                enc.encode_literal(bits_extra, 2)
                bits = (bd - 3) + bits_extra
                v = new[0]
                rng = (1 << bd) - v - 1
                for nxt in new[1:]:
                    d = nxt - v
                    enc.encode_literal(d - 1, bits)
                    v = nxt
                    rng -= d
                    bits = min(bits, ceil_log2(rng))

    def _write_palette_map(self, b: BlockRecord):
        """palette_tokens (spec 5.11.49): first index uniform-coded, the
        rest in anti-diagonal wavefront order with neighbor contexts."""
        from svt_av1_psy_tpu_torch.entropy.palette import (palette_color_ctx,
                                                     uniform_bits,
                                                     wavefront_cells)
        enc, fc = self.enc, self.fc
        r, c = b.mi_row, b.mi_col
        n = len(b.palette)
        m = b.palette_map
        bw = BLOCK_SIZE_WIDE[b.bsize]
        bh = BLOCK_SIZE_HIGH[b.bsize]
        w_on = min(bw, (self.mi_cols - c) * 4)
        h_on = min(bh, (self.mi_rows - r) * 4)
        # write_uniform(n, m[0,0])
        lbits = uniform_bits(n)
        mm = (1 << lbits) - n
        v0 = int(m[0, 0])
        if lbits > 1:
            if v0 < mm:
                enc.encode_literal(v0, lbits - 1)
            else:
                t = v0 + mm
                enc.encode_literal(t >> 1, lbits - 1)
                enc.encode_literal(t & 1, 1)
        else:                       # n == 2: single bit (v >= mm == 0)
            enc.encode_literal(v0, 1)
        cdf = fc.palette_y_color[n - 2]
        for rr, cc in wavefront_cells(h_on, w_on):
            ctx, order = palette_color_ctx(m, rr, cc, n)
            enc.encode_symbol(order.index(int(m[rr, cc])), cdf[ctx],
                              nsyms=n, adapt=True)

    def rate_palette_y(self, r: int, c: int, bsize: int, colors) -> float:
        """Bits for palette_y_mode=1 + size + colors (header part)."""
        from svt_av1_psy_tpu_torch.entropy.palette import plan_color_coding
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        bctx = (BLOCK_SIZE_WIDE[bsize].bit_length() +
                BLOCK_SIZE_HIGH[bsize].bit_length() - 2) - 6
        pctx = int(r > 0 and self.above_pal[c] is not None) + \
            int(c > 0 and self.left_pal[r] is not None)
        plan = plan_color_coding(colors, self._pal_cache(r, c), self.bd)
        if plan is None:
            return 1e9
        bits = sym_cost(self.fc.palette_y_mode[bctx][pctx], 1)
        bits += sym_cost(self.fc.palette_y_size[bctx], len(colors) - 2)
        return bits + plan[3]

    def rate_palette_flag(self, r: int, c: int, bsize: int,
                          on: bool) -> float:
        """Bits of the palette_y_mode flag alone (0 for non-palette DC
        blocks once screen content tools are on)."""
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        if not (self.allow_screen_content and bsize >= 3
                and BLOCK_SIZE_WIDE[bsize] <= 64
                and BLOCK_SIZE_HIGH[bsize] <= 64):
            return 0.0
        bctx = (BLOCK_SIZE_WIDE[bsize].bit_length() +
                BLOCK_SIZE_HIGH[bsize].bit_length() - 2) - 6
        pctx = int(r > 0 and self.above_pal[c] is not None) + \
            int(c > 0 and self.left_pal[r] is not None)
        return sym_cost(self.fc.palette_y_mode[bctx][pctx], int(on))

    def rate_palette_map(self, bsize: int, r: int, c: int, pal_map,
                         n: int) -> float:
        """Bits of the color index map (wavefront, live CDFs, no
        adaptation during estimation)."""
        from svt_av1_psy_tpu_torch.entropy.palette import (palette_color_ctx,
                                                     uniform_bits,
                                                     wavefront_cells)
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        bw = BLOCK_SIZE_WIDE[bsize]
        bh = BLOCK_SIZE_HIGH[bsize]
        w_on = min(bw, (self.mi_cols - c) * 4)
        h_on = min(bh, (self.mi_rows - r) * 4)
        bits = float(max(uniform_bits(n) - 1, 0))
        if int(pal_map[0, 0]) >= (1 << uniform_bits(n)) - n:
            bits += 1.0
        cdf = self.fc.palette_y_color[n - 2]
        for rr, cc in wavefront_cells(h_on, w_on):
            ctx, order = palette_color_ctx(pal_map, rr, cc, n)
            bits += sym_cost(cdf[ctx], order.index(int(pal_map[rr, cc])))
        return bits

    def rate_tx_depth(self, r: int, c: int, bsize: int,
                      tx_size: int) -> float:
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        from svt_av1_psy_tpu_torch.entropy.tx_trees import (SUB_TX, max_tx_depth,
                                                      tx_size_cat)
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        if not self.tx_mode_select or bsize <= int(BlockSize.BLOCK_4X4):
            return 0.0
        max_d = max_tx_depth(bsize)
        if max_d == 0:
            return 0.0
        depth = 0
        t = int(MAX_TX_SIZE_RECT[bsize])
        while t != tx_size:
            t = int(SUB_TX[t])
            depth += 1
        cat = tx_size_cat(bsize)
        ctx = self._tx_size_ctx(r, c, bsize)
        return sym_cost(self.fc.tx_size[cat][ctx], depth)

    def _tx_size_ctx(self, r: int, c: int, bsize: int) -> int:
        """get_tx_size_context incl. the INTER-neighbor block-dims
        override (mirrors TileParser._tx_size_ctx)."""
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        max_tx = int(MAX_TX_SIZE_RECT[bsize])
        g = getattr(self, "grid", None)
        if g is not None and r > 0 and int(g.ref0[r - 1, c]) > 0:
            aw_ok = BLOCK_SIZE_WIDE[int(g.bsize[r - 1, c])] >= \
                TX_SIZE_WIDE[max_tx]
        else:
            aw_ok = int(self.above_txw[c]) >= TX_SIZE_WIDE[max_tx]
        if g is not None and c > 0 and int(g.ref0[r, c - 1]) > 0:
            lh_ok = BLOCK_SIZE_HIGH[int(g.bsize[r, c - 1])] >= \
                TX_SIZE_HIGH[max_tx]
        else:
            lh_ok = int(self.left_txh[r]) >= TX_SIZE_HIGH[max_tx]
        if r > 0 and c > 0:
            return int(aw_ok) + int(lh_ok)
        if r > 0:
            return int(aw_ok)
        if c > 0:
            return int(lh_ok)
        return 0

    def rate_txb(self, plane: int, bsize: int, qcoeff, tx_size: int,
                 tx_type: int, u_row: int, u_col: int,
                 y_mode: int = 0, is_inter: bool = False) -> float:
        """Rate in bits of coding this txb (txb_skip + tx type + coeffs),
        using current neighbor contexts (ref av1_cost_coeffs semantics)."""
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        from svt_av1_psy_tpu_torch.constants import (TX_SIZE_HIGH, TX_SIZE_SQR,
                                               TX_SIZE_WIDE, get_scan)
        from svt_av1_psy_tpu_torch.ops.quant import adjusted_tx_size
        from svt_av1_psy_tpu_torch.entropy.tx_sets import (EXT_TX_FWD,
                                                     EXT_TX_SET_SIZES,
                                                     intra_tx_set)
        import math
        fc = self.fc
        tw4 = TX_SIZE_WIDE[tx_size] // 4
        th4 = TX_SIZE_HIGH[tx_size] // 4
        above = self.above_coef[plane][u_col:u_col + tw4]
        left = self.left_coef[plane][u_row:u_row + th4]
        ptype = 1 if plane else 0
        txs_ctx = cc.txs_entropy_ctx(tx_size)
        bw = BLOCK_SIZE_WIDE[bsize] >> (self.ss_x if plane else 0)
        bh = BLOCK_SIZE_HIGH[bsize] >> (self.ss_y if plane else 0)
        covers = (TX_SIZE_WIDE[tx_size] >= bw and
                  TX_SIZE_HIGH[tx_size] >= bh)
        larger = (bw * bh > TX_SIZE_WIDE[tx_size] * TX_SIZE_HIGH[tx_size])
        sctx = cc.txb_skip_ctx(above, left, plane, covers, larger)
        all_zero = not np.any(qcoeff)
        bits = sym_cost(fc.txb_skip[txs_ctx][sctx], int(all_zero))
        if all_zero:
            return bits
        if plane == 0 and not is_inter:
            tx_set = intra_tx_set(tx_size, self.reduced_tx_set)
            if tx_set > 0:
                bits += sym_cost(
                    fc.intra_ext_tx[tx_set][TX_SIZE_SQR[tx_size]][y_mode],
                    EXT_TX_FWD[tx_set][tx_type])
        elif plane == 0:
            from svt_av1_psy_tpu_torch.entropy.tx_sets import (
                EXT_TX_SET_TYPE_FWD, EXT_TX_SET_TYPE_TO_IDX_INTER,
                inter_tx_set_type)
            st = inter_tx_set_type(tx_size, self.reduced_tx_set)
            if st > 0:
                bits += sym_cost(
                    fc.inter_ext_tx[EXT_TX_SET_TYPE_TO_IDX_INTER[st]]
                    [TX_SIZE_SQR[tx_size]],
                    EXT_TX_SET_TYPE_FWD[st][tx_type])
        sgn_ctx = cc.dc_sign_ctx(above, left)
        from svt_av1_psy_tpu_torch import native
        adj = adjusted_tx_size(tx_size)
        w_, h_ = TX_SIZE_WIDE[adj], TX_SIZE_HIGH[adj]
        if not hasattr(self, "_txb_cdfs"):
            from svt_av1_psy_tpu_torch.native import make_txb_cdfs
            self._txb_cdfs = make_txb_cdfs(fc)
        cost512 = native.cost_txb(
            self._txb_cdfs, qcoeff, get_scan(tx_size, tx_type),
            w_, h_, TX_SIZE_WIDE[tx_size], TX_SIZE_HIGH[tx_size],
            cc.eob_multi_size(tx_size), txs_ctx,
            cc.tx_class_of(tx_type), ptype, sgn_ctx)
        return bits + cost512 / 512.0

    def rd_txb(self, plane: int, bsize: int, resid, tx_size: int,
               tx_type: int, u_row: int, u_col: int, pq,
               y_mode: int = 0, is_inter: bool = False, bd: int = 8):
        """Fused trial: fwd+quant+inv+SSE (native) + exact rate incl.
        txb_skip and tx-type signaling. Returns (sse, qcoeff, rate_bits)."""
        from svt_av1_psy_tpu_torch.entropy.range_coder import sym_cost
        from svt_av1_psy_tpu_torch.constants import (TX_SIZE_HIGH, TX_SIZE_SQR,
                                               TX_SIZE_WIDE, get_scan)
        from svt_av1_psy_tpu_torch.ops.quant import adjusted_tx_size
        from svt_av1_psy_tpu_torch import native
        fc = self.fc
        tw4 = TX_SIZE_WIDE[tx_size] // 4
        th4 = TX_SIZE_HIGH[tx_size] // 4
        above = self.above_coef[plane][u_col:u_col + tw4]
        left = self.left_coef[plane][u_row:u_row + th4]
        ptype = 1 if plane else 0
        txs_ctx = cc.txs_entropy_ctx(tx_size)
        bw = BLOCK_SIZE_WIDE[bsize] >> (self.ss_x if plane else 0)
        bh = BLOCK_SIZE_HIGH[bsize] >> (self.ss_y if plane else 0)
        covers = (TX_SIZE_WIDE[tx_size] >= bw and
                  TX_SIZE_HIGH[tx_size] >= bh)
        larger = (bw * bh > TX_SIZE_WIDE[tx_size] * TX_SIZE_HIGH[tx_size])
        sctx = cc.txb_skip_ctx(above, left, plane, covers, larger)
        sgn_ctx = cc.dc_sign_ctx(above, left)
        if not hasattr(self, "_txb_cdfs"):
            from svt_av1_psy_tpu_torch.native import make_txb_cdfs
            self._txb_cdfs = make_txb_cdfs(fc)
        adj = adjusted_tx_size(tx_size)
        cw, ch = TX_SIZE_WIDE[adj], TX_SIZE_HIGH[adj]
        sse, qc, rate512 = native.rd_txb(
            resid, tx_size, tx_type, pq, get_scan(tx_size, tx_type),
            cw, ch, TX_SIZE_WIDE[tx_size], TX_SIZE_HIGH[tx_size],
            cc.eob_multi_size(tx_size), txs_ctx, cc.tx_class_of(tx_type),
            ptype, sgn_ctx, self._txb_cdfs, bd)
        all_zero = rate512 == 0
        bits = sym_cost(fc.txb_skip[txs_ctx][sctx], int(all_zero))
        if not all_zero:
            if plane == 0 and not is_inter:
                from svt_av1_psy_tpu_torch.entropy.tx_sets import (
                    EXT_TX_FWD, intra_tx_set)
                tx_set = intra_tx_set(tx_size, self.reduced_tx_set)
                if tx_set > 0:
                    bits += sym_cost(
                        fc.intra_ext_tx[tx_set][TX_SIZE_SQR[tx_size]]
                        [y_mode], EXT_TX_FWD[tx_set][tx_type])
            elif plane == 0:
                from svt_av1_psy_tpu_torch.entropy.tx_sets import (
                    EXT_TX_SET_TYPE_FWD, EXT_TX_SET_TYPE_TO_IDX_INTER,
                    inter_tx_set_type)
                st = inter_tx_set_type(tx_size, self.reduced_tx_set)
                if st > 0:
                    bits += sym_cost(
                        fc.inter_ext_tx[EXT_TX_SET_TYPE_TO_IDX_INTER[st]]
                        [TX_SIZE_SQR[tx_size]],
                        EXT_TX_SET_TYPE_FWD[st][tx_type])
            bits += rate512 / 512.0
        return sse, qc, bits

    # --- loop restoration write (spec 5.11.57 mirror) --------------------
    def _enc_quniform(self, n, v):
        if n <= 1:
            return
        ln = (n - 1).bit_length()
        m = (1 << ln) - n
        if v < m:
            self.enc.encode_literal(v, ln - 1)
        else:
            self.enc.encode_literal(m + ((v - m) >> 1), ln - 1)
            self.enc.encode_literal((v - m) & 1, 1)

    def _enc_subexp(self, n, k, v):
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if n <= mk + 3 * a:
                self._enc_quniform(n - mk, v - mk)
                return
            t = int(v >= mk + a)
            self.enc.encode_literal(t, 1)
            if t:
                i += 1
                mk += a
            else:
                self.enc.encode_literal(v - mk, b2)
                return

    def _enc_signed_subexp(self, low, high, k, ref, v):
        def recenter(r, x):
            if x > (r << 1):
                return x
            if x >= r:
                return (x - r) << 1
            return ((r - x) << 1) - 1
        n = high - low
        rr = ref - low
        x = v - low
        if (rr << 1) <= n:
            self._enc_subexp(n, k, recenter(rr, x))
        else:
            self._enc_subexp(n, k, recenter(n - 1 - rr, n - 1 - x))

    def init_lr(self, lr_type, lr_unit_size, lr_units, frame_w, frame_h):
        """Arm loop-restoration syntax for the final write pass."""
        self.lr_type = lr_type
        self.lr_unit_size = lr_unit_size
        self.lr_units = lr_units
        self.lr_frame_w = frame_w
        self.lr_frame_h = frame_h
        self.lr_ref_wiener = [[[3, -7, 15], [3, -7, 15]] for _ in range(3)]
        self.lr_ref_sgr = [[-32, 31] for _ in range(3)]

    def write_lr(self, sbr, sbc):
        from svt_av1_psy_tpu_torch.entropy.tile_writer import _WIENER_TAP_SPEC2
        if not getattr(self, "lr_type", None) or not any(self.lr_type):
            return
        fc = self.fc
        for plane in range(3):
            if not self.lr_type[plane]:
                continue
            sub = 1 if plane else 0
            usize = self.lr_unit_size[plane]
            pw = (self.lr_frame_w + sub) >> sub
            ph = (self.lr_frame_h + sub) >> sub
            ucols = max((pw + (usize >> 1)) // usize, 1)
            urows = max((ph + (usize >> 1)) // usize, 1)
            px = 4 >> sub
            r0 = (sbr * px + usize - 1) // usize
            r1 = min(urows, ((sbr + self.sb_mi) * px + usize - 1) // usize)
            c0 = (sbc * px + usize - 1) // usize
            c1 = min(ucols, ((sbc + self.sb_mi) * px + usize - 1) // usize)
            for ur in range(r0, r1):
                for uc in range(c0, c1):
                    self._write_lr_unit(plane, ur, uc)

    def _write_lr_unit(self, plane, ur, uc):
        fc = self.fc
        info = self.lr_units[plane].get((ur, uc), {"type": 0})
        rtype = info["type"]
        ftype = self.lr_type[plane]
        if ftype == 3:
            self.enc.encode_symbol(rtype, fc.switchable_restore, adapt=True)
        elif ftype == 1:
            self.enc.encode_symbol(int(rtype == 1), fc.wiener_restore,
                                   adapt=True)
        else:
            self.enc.encode_symbol(int(rtype == 2), fc.sgrproj_restore,
                                   adapt=True)
        if rtype == 1:
            for p2, key in ((0, "vfilter"), (1, "hfilter")):
                first = 1 if plane else 0
                for j in range(3):
                    if j < first:
                        continue
                    mn, mx, k = _WIENER_TAP_SPEC2[j]
                    v = info[key][j]
                    self._enc_signed_subexp(
                        mn, mx + 1, k, self.lr_ref_wiener[plane][p2][j], v)
                    self.lr_ref_wiener[plane][p2][j] = v
        elif rtype == 2:
            from svt_av1_psy_tpu_torch.ops.restoration import SGR_PARAMS
            ep = info["ep"]
            x0, x1 = info["xqd"]
            self.enc.encode_literal(ep, 4)
            rr0, _, rr1, _ = SGR_PARAMS[ep]
            if rr0:
                self._enc_signed_subexp(-96, 32, 4,
                                        self.lr_ref_sgr[plane][0], x0)
            if rr1:
                self._enc_signed_subexp(-32, 96, 4,
                                        self.lr_ref_sgr[plane][1], x1)
            self.lr_ref_sgr[plane][0] = x0
            self.lr_ref_sgr[plane][1] = x1

    def finish(self) -> bytes:
        return self.enc.done()
