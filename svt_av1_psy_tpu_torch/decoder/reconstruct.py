"""Intra-frame reconstruction for parsed tiles (spec 7.11 + 7.12 + 7.13).

Completes the in-repo conformance decoder: TileParser produces block records
+ quantized coefficients; this module performs normative prediction (incl.
directional with edge filter/upsample, CfL, filter-intra), dequantization
(incl. quantizer matrices) and inverse transforms, yielding frame planes that
must equal dav1d's output bit-exactly.

Neighbor-pixel availability follows the spec's BlockDecoded bitmap scheme
(5.11.31 clear_block_decoded_flags / 5.11.37 transform_block), which is
equivalent to the reference's has_top_right/has_bottom_left order tables
(ref: Source/Lib/Codec/intra_prediction.c:494-760) but simpler to get right.
"""

from __future__ import annotations

import numpy as np

from svt_av1_psy_tpu_torch.constants import (BLOCK_SIZE_HIGH, BLOCK_SIZE_WIDE,
                                       TX_SIZE_HIGH, TX_SIZE_WIDE, PredMode)
from svt_av1_psy_tpu_torch.entropy.tile_writer import has_chroma
from svt_av1_psy_tpu_torch.ops import intra as ip
from svt_av1_psy_tpu_torch.ops.quant import (PlaneQuant, build_plane_quant,
                                       dequant_coeffs, iqm_matrix)
from svt_av1_psy_tpu_torch.ops.transforms import inverse_transform_add as _inv_py

_NATIVE = None


def inverse_transform_add(dq, pred, ts, tt, bd):
    """Native inverse transform when available (bit-identical to the
    python stage machine), falling back to pure python."""
    global _NATIVE
    if _NATIVE is None:
        try:
            from svt_av1_psy_tpu_torch import native
            native.ensure_txfms()
            _NATIVE = native
        except Exception:
            _NATIVE = False
    if _NATIVE:
        hi = (1 << bd) - 1
        resid = _NATIVE.inv_txfm2d(dq, ts, tt, bd)
        out = pred + resid
        import numpy as _np
        return _np.clip(out, 0, hi)
    return _inv_py(dq, pred, ts, tt, bd)

SMOOTH_MODES = (int(PredMode.SMOOTH_PRED), int(PredMode.SMOOTH_V_PRED),
                int(PredMode.SMOOTH_H_PRED))


class FrameReconstructor:
    def __init__(self, width: int, height: int, fi, *, bd: int = 8,
                 sb_size: int = 64, enable_intra_edge_filter: bool = True):
        self.bd = bd
        self.sb4 = sb_size // 4
        self.edge_filter = enable_intra_edge_filter
        self.mi_cols = 2 * ((width + 7) >> 3)
        self.mi_rows = 2 * ((height + 7) >> 3)
        self.aw = self.mi_cols * 4
        self.ah = self.mi_rows * 4
        dtype = np.uint8 if bd == 8 else np.uint16
        # planes padded generously so edge reads never leave the array
        self.planes = [np.zeros((self.ah + 160, self.aw + 160), dtype),
                       np.zeros((self.ah // 2 + 160, self.aw // 2 + 160),
                                dtype),
                       np.zeros((self.ah // 2 + 160, self.aw // 2 + 160),
                                dtype)]
        self.fi = fi
        self.pq = [
            build_plane_quant(fi.base_q_idx, fi.delta_q_y_dc, 0, bd),
            build_plane_quant(fi.base_q_idx, fi.delta_q_u_dc,
                              fi.delta_q_u_ac, bd),
            build_plane_quant(fi.base_q_idx, fi.delta_q_v_dc,
                              fi.delta_q_v_ac, bd),
        ]
        self.qm_levels = [fi.qm_y, fi.qm_u, fi.qm_v] if fi.using_qmatrix \
            else None
        self._pq_cache = {}
        # encoder-side per-SB qindex override (variance-boost AQ); the
        # decode path carries qindex on each ParsedBlock instead
        self.q_override = None
        # inter state (set by the driver for inter frames)
        self.ref_planes = None
        self.ref_frame_idx = None
        self.interp_filter = 0
        self.ref_hints = [0] * 7        # order hints per ref (dist-wtd)
        self.cur_order_hint = 0
        self.order_hint_bits = 0
        # BlockDecoded bitmaps, one per plane, rebuilt per superblock.
        # Indexed [y4 + 1][x4 + 1] with the -1 border.
        self._bd_maps = None
        self._sb_rc = (-1, -1)
        # active tile bounds in mi units (r0, r1, c0, c1): neighbor-pixel
        # availability never crosses them (spec intra prediction uses
        # tile-relative AvailU/AvailL). Default = whole frame.
        self._tile = (0, self.mi_rows, 0, self.mi_cols)
        # loop-filter maps: per-plane-unit tx dims + block dims (px),
        # filled in finish_block, consumed by apply_dlf (spec 7.14)
        cmw = (self.mi_cols + 1) >> 1
        cmh = (self.mi_rows + 1) >> 1
        self.lf_txw = [np.zeros((self.mi_rows, self.mi_cols), np.int32),
                       np.zeros((cmh, cmw), np.int32),
                       np.zeros((cmh, cmw), np.int32)]
        self.lf_txh = [a.copy() for a in self.lf_txw]
        self.lf_skip_inter = [a.copy().astype(np.uint8) for a in self.lf_txw]
        self.lf_ox = [a.copy() for a in self.lf_txw]   # block origin (units)
        self.lf_oy = [a.copy() for a in self.lf_txw]
        self.skip_map = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.width, self.height = width, height
        # per-plane is-smooth neighbor rows for the edge filter type
        self.above_smooth = [np.zeros(self.mi_cols, np.uint8) for _ in
                             range(2)]
        self.left_smooth = [np.zeros(self.mi_rows, np.uint8) for _ in
                            range(2)]

    def set_tile(self, r0: int, r1: int, c0: int, c1: int):
        """Restrict reconstruction availability to one tile (mi units).
        Call before decode_blocks for each tile of a multi-tile frame."""
        self._tile = (r0, r1, c0, c1)
        self._sb_rc = (-1, -1)      # force BlockDecoded rebuild
        # the smooth-flag neighbor rows are TILE-scoped contexts (the
        # reference keeps them per tile): a fresh tile must not read
        # another tile's flags through its interior edges
        for a in self.above_smooth:
            a[c0:c1] = 0
        for a in self.left_smooth:
            a[r0:r1] = 0

    # --- BlockDecoded ----------------------------------------------------
    def _reset_sb(self, sbr4: int, sbc4: int):
        """clear_block_decoded_flags (spec 5.11.31)."""
        self._sb_rc = (sbr4, sbc4)
        self._bd_maps = []
        t_r0, t_r1, t_c0, t_c1 = self._tile
        for plane in range(3):
            sub = 1 if plane else 0
            n = (self.sb4 >> sub)
            m = np.zeros((n + 2, n + 2), np.uint8)
            sb_w4 = (t_c1 - sbc4) >> sub             # to tile end
            sb_h4 = (t_r1 - sbr4) >> sub
            # above row: x in [-1, n] available while x < sbWidth4
            xs = np.arange(-1, n + 1)
            m[0, :] = (xs < sb_w4).astype(np.uint8)
            # left col: y in [0, n] available while y < sbHeight4
            ys = np.arange(0, n + 1)
            m[1:, 0] = (ys < sb_h4).astype(np.uint8)
            m[n + 1, 0] = 0                          # bottom-left cleared
            # interior tile edges: nothing left/above is available (frame
            # edges keep the legacy maps — the x>0/y>0 checks gate those)
            if sbc4 == t_c0 and t_c0 > 0:
                m[:, 0] = 0
            if sbr4 == t_r0 and t_r0 > 0:
                m[0, :] = 0
            self._bd_maps.append(m)

    def _bdget(self, plane, y4, x4) -> bool:
        sub = 1 if plane else 0
        sbr4, sbc4 = self._sb_rc
        ry = y4 - (self._sb_rc[0] >> sub)
        rx = x4 - (self._sb_rc[1] >> sub)
        n = self.sb4 >> sub
        if ry < -1 or rx < -1 or ry > n or rx > n:
            return False
        return bool(self._bd_maps[plane][ry + 1, rx + 1])

    def _bdset(self, plane, y4, x4, h4, w4):
        sub = 1 if plane else 0
        ry = y4 - (self._sb_rc[0] >> sub)
        rx = x4 - (self._sb_rc[1] >> sub)
        self._bd_maps[plane][ry + 1:ry + 1 + h4, rx + 1:rx + 1 + w4] = 1

    # --- top level -------------------------------------------------------
    def decode_blocks(self, blocks) -> tuple:
        """Reconstruct all parsed blocks (decode order). Returns (y, u, v)
        display-cropped planes... caller crops."""
        for b in blocks:
            sbr4 = b.mi_row - (b.mi_row % self.sb4)
            sbc4 = b.mi_col - (b.mi_col % self.sb4)
            if (sbr4, sbc4) != self._sb_rc:
                self._reset_sb(sbr4, sbc4)
            self._decode_block(b)
        return (self.planes[0][:self.ah, :self.aw],
                self.planes[1][:self.ah // 2, :self.aw // 2],
                self.planes[2][:self.ah // 2, :self.aw // 2])

    def snapshot(self, plane: int, u_row: int, u_col: int, h4: int,
                 w4: int):
        """Encoder trial support: capture recon region + decoded-map state
        for rollback (region in the plane's 4-px units)."""
        sub = 1 if plane else 0
        x, y = u_col * 4, u_row * 4
        region = self.planes[plane][y:y + h4 * 4, x:x + w4 * 4].copy()
        ry = u_row - (self._sb_rc[0] >> sub)
        rx = u_col - (self._sb_rc[1] >> sub)
        bd = self._bd_maps[plane][ry + 1:ry + 1 + h4,
                                  rx + 1:rx + 1 + w4].copy()
        return (plane, u_row, u_col, region, bd)

    def restore(self, snap):
        plane, u_row, u_col, region, bdm = snap
        sub = 1 if plane else 0
        x, y = u_col * 4, u_row * 4
        self.planes[plane][y:y + region.shape[0],
                           x:x + region.shape[1]] = region
        ry = u_row - (self._sb_rc[0] >> sub)
        rx = u_col - (self._sb_rc[1] >> sub)
        self._bd_maps[plane][ry + 1:ry + 1 + bdm.shape[0],
                             rx + 1:rx + 1 + bdm.shape[1]] = bdm

    def snapshot_area(self, r: int, c: int, h4: int, w4: int):
        """Full-state snapshot of a square region (all planes + decode maps +
        smooth-neighbor arrays) for encoder partition trials."""
        snaps = [self.snapshot(0, r, c, h4, w4)]
        cr, cc = r >> 1, c >> 1
        ch = max(1, h4 >> 1)
        cw = max(1, w4 >> 1)
        snaps.append(self.snapshot(1, cr, cc, ch, cw))
        snaps.append(self.snapshot(2, cr, cc, ch, cw))
        sm = (tuple(a[c:c + w4].copy() for a in self.above_smooth),
              tuple(a[r:r + h4].copy() for a in self.left_smooth))
        return (snaps, sm, (r, c, h4, w4))

    def restore_area(self, snap):
        snaps, (asm, lsm), (r, c, h4, w4) = snap
        for s in snaps:
            self.restore(s)
        for a, sv in zip(self.above_smooth, asm):
            a[c:c + w4] = sv
        for a, sv in zip(self.left_smooth, lsm):
            a[r:r + h4] = sv

    def start_block(self, mi_row: int, mi_col: int):
        """Encoder hook: ensure the BlockDecoded maps track this block's
        superblock (decode order assumed)."""
        sbr4 = mi_row - (mi_row % self.sb4)
        sbc4 = mi_col - (mi_col % self.sb4)
        if (sbr4, sbc4) != self._sb_rc:
            self._reset_sb(sbr4, sbc4)

    def finish_block(self, b, hc: bool):
        """Neighbor smooth-ness updates + loop-filter maps after a block
        (both decode and encoder-commit paths)."""
        w4 = BLOCK_SIZE_WIDE[b.bsize] // 4
        h4 = BLOCK_SIZE_HIGH[b.bsize] // 4
        from svt_av1_psy_tpu_torch.entropy.tile_writer import MAX_TX_SIZE_RECT
        r, c = b.mi_row, b.mi_col
        ts = b.tx_size if getattr(b, "tx_size", -1) >= 0 \
            else int(MAX_TX_SIZE_RECT[b.bsize])
        self.lf_txw[0][r:r + h4, c:c + w4] = TX_SIZE_WIDE[ts]
        self.lf_txh[0][r:r + h4, c:c + w4] = TX_SIZE_HIGH[ts]
        if getattr(b, "tx_leaves", None) is not None:
            # inter var-tx: per-leaf tx dims drive the deblock filter maps
            for (ly, lx, lts) in b.tx_leaves:
                lh4 = max(1, TX_SIZE_HIGH[lts] // 4)
                lw4 = max(1, TX_SIZE_WIDE[lts] // 4)
                self.lf_txw[0][r + ly:r + ly + lh4,
                               c + lx:c + lx + lw4] = TX_SIZE_WIDE[lts]
                self.lf_txh[0][r + ly:r + ly + lh4,
                               c + lx:c + lx + lw4] = TX_SIZE_HIGH[lts]
        ski = int(getattr(b, "skip", False) and
                  getattr(b, "is_inter", False))
        self.lf_skip_inter[0][r:r + h4, c:c + w4] = ski
        self.lf_ox[0][r:r + h4, c:c + w4] = c
        self.lf_oy[0][r:r + h4, c:c + w4] = r
        self.skip_map[r:r + h4, c:c + w4] = int(getattr(b, "skip", False))
        if hc:
            from svt_av1_psy_tpu_torch.entropy.tx_trees import max_uv_tx_size
            uts = max_uv_tx_size(b.bsize)
            cr, cc2 = r >> 1, c >> 1
            ch4 = max(1, h4 >> 1)
            cw4 = max(1, w4 >> 1)
            for pl in (1, 2):
                self.lf_txw[pl][cr:cr + ch4, cc2:cc2 + cw4] = \
                    TX_SIZE_WIDE[uts]
                self.lf_txh[pl][cr:cr + ch4, cc2:cc2 + cw4] = \
                    TX_SIZE_HIGH[uts]
                self.lf_skip_inter[pl][cr:cr + ch4, cc2:cc2 + cw4] = ski
                self.lf_ox[pl][cr:cr + ch4, cc2:cc2 + cw4] = cc2
                self.lf_oy[pl][cr:cr + ch4, cc2:cc2 + cw4] = cr
        ysm = int(b.y_mode in SMOOTH_MODES)
        self.above_smooth[0][b.mi_col:b.mi_col + w4] = ysm
        self.left_smooth[0][b.mi_row:b.mi_row + h4] = ysm
        if hc:
            usm = int(b.uv_mode in SMOOTH_MODES)
            self.above_smooth[1][b.mi_col:b.mi_col + w4] = usm
            self.left_smooth[1][b.mi_row:b.mi_row + h4] = usm

    # obmc_mask_N (spec 7.11.3.10 Obmc_Mask; ref inter_prediction.c:2407)
    _OBMC_MASK = {
        1: (64,), 2: (45, 64), 4: (39, 50, 59, 64),
        8: (36, 42, 48, 53, 57, 61, 64, 64),
        16: (34, 37, 40, 43, 46, 49, 52, 54, 56, 58, 60, 61, 64, 64, 64,
             64),
        32: (33, 35, 36, 38, 40, 41, 43, 44, 45, 47, 48, 50, 51, 52, 53,
             55, 56, 57, 58, 59, 60, 60, 61, 62, 64, 64, 64, 64, 64, 64,
             64, 64)}

    def _apply_obmc(self, b, hc):
        """Overlapped block MC (spec 7.11.3.9; ref
        enc_inter_prediction.c build_obmc_inter_pred_above/left):
        re-predict the overlap strip from each neighbor's ref/MV/filters
        and blend with the smooth obmc mask (above pass then left)."""
        from svt_av1_psy_tpu_torch.ops.mc import mc_block
        bw = BLOCK_SIZE_WIDE[b.bsize]
        bh = BLOCK_SIZE_HIGH[b.bsize]

        def plane_skip(dir_, ss):
            # svt_av1_skip_u4x4_pred_in_obmc: chroma plane blocks
            # 4x4 / 8x4 / 4x8 skip the ABOVE pass only
            if ss == 0:
                return False
            pw, ph = bw >> ss, bh >> ss
            return dir_ == 0 and min(pw, ph) == 4 and max(pw, ph) <= 8

        def blend(nbs, dir_):
            for (rel4, n4, nref, nmv, nfil) in nbs:
                slot = self.ref_frame_idx[nref - 1]
                refp = self.ref_planes[slot]
                for plane in range(3 if hc else 1):
                    ss = 1 if plane else 0
                    if plane and plane_skip(dir_, ss):
                        continue
                    if dir_ == 0:       # above strip
                        ov = min(bh, 64) >> 1
                        ph = ov >> ss
                        pw = (n4 * 4) >> ss
                        x = ((b.mi_col + rel4) * 4) >> ss
                        y = (b.mi_row * 4) >> ss
                        mask = np.array(self._OBMC_MASK[ph],
                                        np.int32)[:, None]
                    else:               # left strip
                        ov = min(bw, 64) >> 1
                        pw = ov >> ss
                        ph = (n4 * 4) >> ss
                        x = (b.mi_col * 4) >> ss
                        y = ((b.mi_row + rel4) * 4) >> ss
                        mask = np.array(self._OBMC_MASK[pw],
                                        np.int32)[None, :]
                    mvx = int(nmv[1]) << (1 - ss)
                    mvy = int(nmv[0]) << (1 - ss)
                    tmp = mc_block(np.asarray(refp[plane]), x, y, pw, ph,
                                   mvx, mvy, nfil[0], nfil[1],
                                   bd=self.bd)
                    dst = self.planes[plane][y:y + ph, x:x + pw] \
                        .astype(np.int32)
                    out = (mask * dst + (64 - mask) * tmp + 32) >> 6
                    self.planes[plane][y:y + ph, x:x + pw] = \
                        out.astype(self.planes[plane].dtype)

        if b.obmc_above:
            blend(b.obmc_above, 0)
        if b.obmc_left:
            blend(b.obmc_left, 1)

    # II_DC/V/H/SMOOTH -> DC_PRED/V_PRED/H_PRED/SMOOTH_PRED
    _II_TO_INTRA = (0, 1, 2, 9)

    def _blend_interintra(self, b, plane, ss, x, y, w, h, inter_pred):
        """Inter-intra prediction (spec 7.11.3.13): whole-block intra
        prediction of the mapped mode blended with the MC prediction via
        the smooth II mask or a wedge mask (ref inter_prediction.c
        svt_aom_combine_interintra_highbd)."""
        from svt_av1_psy_tpu_torch.inter import masks as mk
        tr0, _, tc0, _ = self._tile
        have_above = b.mi_row > tr0
        have_left = b.mi_col > tc0
        max_x = (self.mi_cols * 4 >> ss) - 1
        max_y = (self.mi_rows * 4 >> ss) - 1
        intra = self._predict(b, plane, self._II_TO_INTRA[b.interintra_mode],
                              0, x, y, w, h, have_above, have_left,
                              False, False, max_x, max_y)
        if b.ii_wedge:
            mask = mk.get_wedge_mask(b.bsize, b.ii_wedge_idx, 0)
            if ss:
                mask = mk.subsample_mask(mask, 1, 1)
        else:
            mask = mk.smooth_interintra_mask(b.interintra_mode, w, h)
        return mk.blend_a64(mask, intra, inter_pred)

    def _rel_dist(self, a: int, b: int) -> int:
        ohb = getattr(self, "order_hint_bits", 0)
        if ohb <= 0:
            return 0
        d = a - b
        m = 1 << (ohb - 1)
        return (d & (m - 1)) - (d & m)

    def _predict_inter_block(self, b, hc):
        """Whole-block MC prediction per plane written as base recon
        (spec 7.11.3); residual txbs then add on top. Compound blocks
        (ref_frame2 > 0) blend two intermediate-precision components,
        average or dist-wtd (spec 7.11.3.15)."""
        from svt_av1_psy_tpu_torch.ops.mc import (blend_compound,
                                            dist_wtd_weights, mc_block,
                                            mc_block_compound_part)
        if getattr(b, "use_intrabc", False):
            # intra block copy (spec 7.11.3): prediction from the current
            # frame's recon, integer luma DV, BILINEAR chroma taps
            bw = BLOCK_SIZE_WIDE[b.bsize]
            bh = BLOCK_SIZE_HIGH[b.bsize]
            for plane in range(3 if hc else 1):
                ss = 1 if plane else 0
                x = (b.mi_col * 4) >> ss
                y = (b.mi_row * 4) >> ss
                w = max(4, bw >> ss)
                h = max(4, bh >> ss)
                if ss and (bw < 8 or bh < 8):
                    # sub-8x8 chroma: intrabc always takes the normal
                    # path over the aligned pair area (libaom forces
                    # sub8x8_inter = 0 for intrabc)
                    cs = 1 if bw == 4 else 0
                    rs = 1 if bh == 4 else 0
                    x = ((b.mi_col - cs) * 4) >> 1
                    y = ((b.mi_row - rs) * 4) >> 1
                    w = (bw + 4 * cs) >> 1
                    h = (bh + 4 * rs) >> 1
                mvx = int(b.mv[1]) << (1 - ss)
                mvy = int(b.mv[0]) << (1 - ss)
                src = self.planes[plane]
                pred = mc_block(np.asarray(src), x, y, w, h, mvx, mvy,
                                3, 3, bd=self.bd)
                maxw = (self.mi_cols * 4) >> ss
                maxh = (self.mi_rows * 4) >> ss
                wx = min(w, maxw - x)
                wy = min(h, maxh - y)
                self.planes[plane][y:y + wy, x:x + wx] = \
                    pred[:wy, :wx].astype(self.planes[plane].dtype)
                self._bdset(plane, y >> 2, x >> 2, (h + 3) >> 2,
                            (w + 3) >> 2)
            return
        slot = self.ref_frame_idx[b.ref_frame - 1]
        ref = self.ref_planes[slot]
        ref2b = getattr(b, "ref_frame2", -1)
        is_comp = ref2b > 0
        ref2 = None
        fwd_off = bck_off = 0
        if is_comp:
            ref2 = self.ref_planes[self.ref_frame_idx[ref2b - 1]]
            if getattr(b, "compound_idx", 1) == 0:
                hints = self.ref_hints
                cur = self.cur_order_hint
                d0 = min(31, abs(self._rel_dist(hints[ref2b - 1], cur)))
                d1 = min(31, abs(self._rel_dist(cur,
                                                hints[b.ref_frame - 1])))
                fwd_off, bck_off = dist_wtd_weights(d0, d1)
        bw = BLOCK_SIZE_WIDE[b.bsize]
        bh = BLOCK_SIZE_HIGH[b.bsize]
        for plane in range(3 if hc else 1):
            ss = 1 if plane else 0
            x = (b.mi_col * 4) >> ss
            y = (b.mi_row * 4) >> ss
            w = max(4, bw >> ss)
            h = max(4, bh >> ss)
            mvx = int(b.mv[1]) << (1 - ss)
            mvy = int(b.mv[0]) << (1 - ss)
            filters = getattr(b, "interp_filters", None)
            fx, fy = filters if filters else (self.interp_filter,
                                              self.interp_filter)
            if plane and (bw < 8 or bh < 8):
                # sub-8x8 chroma: the chroma block covers the 8-aligned
                # luma pair/quad area (ref enc_inter_prediction.c:3903)
                cs = 1 if bw == 4 else 0
                rs = 1 if bh == 4 else 0
                x = ((b.mi_col - cs) * 4) >> 1
                y = ((b.mi_row - rs) * 4) >> 1
                sub = getattr(b, "chroma_sub8x8", None)
                if sub:
                    # mosaic: each covered luma 4x4's mv/ref/filters
                    b4w, b4h = bw >> 1, bh >> 1
                    pred = np.zeros((b4h * (rs + 1), b4w * (cs + 1)),
                                    np.int32)
                    for k, (refk, mvk, filk) in enumerate(sub):
                        dy, dx = divmod(k, cs + 1)
                        rp = self.ref_planes[
                            self.ref_frame_idx[refk - 1]][plane]
                        px = x + dx * b4w
                        py = y + dy * b4h
                        pred[dy * b4h:(dy + 1) * b4h,
                             dx * b4w:(dx + 1) * b4w] = mc_block(
                            np.asarray(rp), px, py, b4w, b4h,
                            int(mvk[1]), int(mvk[0]), filk[0], filk[1],
                            bd=self.bd)
                else:
                    # mixed-intra fallback: whole aligned chroma block
                    # from this block's MV, single-ref
                    w = (bw + 4 * cs) >> 1
                    h = (bh + 4 * rs) >> 1
                    pred = mc_block(np.asarray(ref[plane]), x, y, w, h,
                                    mvx, mvy, fx, fy, bd=self.bd)
                w, h = pred.shape[1], pred.shape[0]
                maxw = (self.mi_cols * 4) >> ss
                maxh = (self.mi_rows * 4) >> ss
                wx = min(w, maxw - x)
                wy = min(h, maxh - y)
                self.planes[plane][y:y + wy, x:x + wx] = \
                    pred[:wy, :wx].astype(self.planes[plane].dtype)
                self._bdset(plane, y >> 2, x >> 2, (h + 3) >> 2,
                            (w + 3) >> 2)
                continue
            if is_comp:
                p0 = mc_block_compound_part(np.asarray(ref[plane]), x, y,
                                            w, h, mvx, mvy, fx, fy,
                                            bd=self.bd)
                mvx2 = int(b.mv2[1]) << (1 - ss)
                mvy2 = int(b.mv2[0]) << (1 - ss)
                p1 = mc_block_compound_part(np.asarray(ref2[plane]), x, y,
                                            w, h, mvx2, mvy2, fx, fy,
                                            bd=self.bd)
                ctype = getattr(b, "comp_type", 0)
                if ctype == 0:
                    pred = blend_compound(p0, p1, bd=self.bd,
                                          fwd_offset=fwd_off,
                                          bck_offset=bck_off)
                else:
                    # masked compound (spec 7.11.3.14): wedge from the
                    # luma-bsize table, diffwtd built once from the luma
                    # CONV_BUF preds and subsampled for chroma
                    from svt_av1_psy_tpu_torch.inter import masks as mk
                    if ctype == 1:
                        mask = mk.get_wedge_mask(b.bsize,
                                                 b.comp_wedge_idx,
                                                 b.comp_wedge_sign)
                    else:
                        if plane == 0:
                            self._dw_mask = mk.diffwtd_mask_d16(
                                p0, p1, b.comp_mask_type, bd=self.bd)
                        mask = self._dw_mask
                    subw = int(w << ss == bw and ss == 1)
                    subh = int(h << ss == bh and ss == 1)
                    if ss:
                        mask = mk.subsample_mask(mask, subw, subh)
                    pred = mk.blend_masked_d16(mask, p0, p1, bd=self.bd)
            elif (getattr(b, "motion_mode", 0) == 2 or
                  getattr(b, "inter_mode", -1) == 2) and \
                    getattr(b, "warp_params", None) is not None and \
                    w >= 8 and h >= 8:
                # warped motion, local OR global rotzoom (spec 7.11.3.5);
                # planes smaller than 8x8 fall back to translation
                # (do_warp plane-dims gate)
                from svt_av1_psy_tpu_torch.inter.warp import warp_plane
                rp = np.asarray(ref[plane])
                pred = warp_plane(b.warp_params, rp,
                                  (self.width + ss) >> ss,
                                  (self.height + ss) >> ss,
                                  x, y, w, h, ss, ss, bd=self.bd)
            else:
                pred = mc_block(np.asarray(ref[plane]), x, y, w, h, mvx,
                                mvy, fx, fy, bd=self.bd)
                if getattr(b, "interintra", False):
                    pred = self._blend_interintra(b, plane, ss, x, y, w, h,
                                                  pred)
            maxw = (self.mi_cols * 4) >> ss
            maxh = (self.mi_rows * 4) >> ss
            wx = min(w, maxw - x)
            wy = min(h, maxh - y)
            self.planes[plane][y:y + wy, x:x + wx] = \
                pred[:wy, :wx].astype(self.planes[plane].dtype)
            self._bdset(plane, y >> 2, x >> 2, (h + 3) >> 2, (w + 3) >> 2)

    def _decode_inter_block(self, b, hc):
        self._predict_inter_block(b, hc)
        if getattr(b, "motion_mode", 0) == 1:
            self._apply_obmc(b, hc)
        for (pl, u_row, u_col, ts, tt, q) in b.txbs:
            if q is None or not np.any(q):
                continue
            sub = 1 if pl else 0
            x = u_col * 4
            y = u_row * 4
            w, h = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
            pred = self.planes[pl][y:y + h, x:x + w].astype(np.int32)
            self.commit_txb(b, pl, u_row, u_col, ts, tt, q, pred)
        self.finish_block(b, hc)

    def _decode_block(self, b):
        hc = has_chroma(b.mi_row, b.mi_col, b.bsize)
        if getattr(b, "is_inter", False):
            self._decode_inter_block(b, hc)
            return
        self.max_luma_w = 0
        self.max_luma_h = 0
        txbs_by_plane = {0: [], 1: [], 2: []}
        for t in b.txbs:
            txbs_by_plane[t[0]].append(t)
        for plane in range(3):
            if plane > 0 and not hc:
                # chroma not carried by this block, but mark decoded later
                continue
            for (pl, u_row, u_col, ts, tt, q) in txbs_by_plane[plane]:
                self._decode_txb(b, plane, u_row, u_col, ts, tt, q)
            if plane == 0 and b.skip:
                # skip blocks: prediction IS recon; predict per max tx unit
                pass
        if b.skip:
            assert not b.txbs, "skip blocks carry no txbs"
            self._reconstruct_skip(b, hc)
        self.finish_block(b, hc)

    def _reconstruct_skip(self, b, hc):
        """Skip blocks still produce prediction as recon (spec: residual
        coded as zero; prediction happens per max-tx unit)."""
        from svt_av1_psy_tpu_torch.decoder.tile_parser import _chroma_tx_size

        bw = BLOCK_SIZE_WIDE[b.bsize]
        bh = BLOCK_SIZE_HIGH[b.bsize]
        # luma per tx unit
        ts = b.tx_size
        tw, th = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
        for oy in range(0, bh, th):
            for ox in range(0, bw, tw):
                self._decode_txb(b, 0, b.mi_row + oy // 4,
                                 b.mi_col + ox // 4, ts, 0, None)
        if hc:
            cts = _chroma_tx_size(b.bsize)
            ctw, cth = TX_SIZE_WIDE[cts], TX_SIZE_HIGH[cts]
            cw = max(4, bw >> 1)
            chh = max(4, bh >> 1)
            for oy in range(0, chh, cth):
                for ox in range(0, cw, ctw):
                    self._decode_txb(b, 1, (b.mi_row >> 1) + oy // 4,
                                     (b.mi_col >> 1) + ox // 4, cts, 0, None)
                    self._decode_txb(b, 2, (b.mi_row >> 1) + oy // 4,
                                     (b.mi_col >> 1) + ox // 4, cts, 0, None)

    # --- per-txb ---------------------------------------------------------
    def predict_txb(self, b, plane, u_row, u_col, ts):
        """Normative prediction for a txb given current recon state.
        Returns pred (h, w) int32, or None if the txb is out of frame.
        Safe to call repeatedly (read-only) — the encoder's mode search
        uses this so search and commit share one prediction path."""
        sub = 1 if plane else 0
        w, h = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
        x = u_col * 4
        y = u_row * 4
        # edge availability + extension clamp at TILE boundaries (the
        # reference clamps intra edge reads to the tile, not the frame)
        _, t_r1, _, t_c1 = self._tile
        max_x = ((min(t_c1, self.mi_cols) * 4) >> sub) - 1
        max_y = ((min(t_r1, self.mi_rows) * 4) >> sub) - 1
        if x > max_x or y > max_y:
            return None
        step_x = w // 4
        step_y = h // 4
        have_left = x > 0 and self._bdget(plane, u_row, u_col - 1)
        have_above = y > 0 and self._bdget(plane, u_row - 1, u_col)
        have_ar = self._bdget(plane, u_row - 1, u_col + step_x)
        have_bl = self._bdget(plane, u_row + step_y, u_col - 1)

        if plane == 0 and getattr(b, "palette", None) is not None:
            # palette prediction (spec 5.11.49 -> predict): map indices
            # into the block's color list
            oy = y - b.mi_row * 4
            ox = x - b.mi_col * 4
            colors = np.array(b.palette, np.int32)
            return colors[b.palette_map[oy:oy + h, ox:ox + w]]
        if plane == 0:
            mode = b.y_mode
        else:
            mode = int(PredMode.DC_PRED) \
                if b.uv_mode == int(PredMode.UV_CFL_PRED) else b.uv_mode
        ad = b.angle_delta_y if plane == 0 else b.angle_delta_uv

        pred = self._predict(b, plane, mode, ad, x, y, w, h, have_above,
                             have_left, have_ar, have_bl, max_x, max_y)
        if plane > 0 and b.uv_mode == int(PredMode.UV_CFL_PRED):
            pred = self._apply_cfl(b, plane, x, y, w, h, pred, sub)
        return pred

    def _decode_txb(self, b, plane, u_row, u_col, ts, tt, qcoeff):
        pred = self.predict_txb(b, plane, u_row, u_col, ts)
        if pred is None:
            return
        self.commit_txb(b, plane, u_row, u_col, ts, tt, qcoeff, pred)

    def commit_txb(self, b, plane, u_row, u_col, ts, tt, qcoeff, pred):
        """Dequant + inverse + recon write + decoded-map update."""
        sub = 1 if plane else 0
        w, h = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
        x = u_col * 4
        y = u_row * 4
        max_x = (self.mi_cols * 4 >> sub) - 1
        max_y = (self.mi_rows * 4 >> sub) - 1
        step_x = w // 4
        step_y = h // 4
        rec_plane = self.planes[plane]
        if qcoeff is None or not np.any(qcoeff):
            rec = pred
        else:
            iqm = None
            # QM applies only to 2-D transform types (tx_type < IDTX;
            # libaom IS_2D_TRANSFORM) — identity-dimension types use flat
            if self.qm_levels is not None and self.qm_levels[plane] < 15 \
                    and tt < 9:
                iqm = iqm_matrix(self.qm_levels[plane], plane, ts)
            bq = self.q_override if self.q_override is not None \
                else getattr(b, "qindex", None)
            if bq is None or bq == self.fi.base_q_idx:
                pq = self.pq[plane]
            else:
                key = (bq, plane)
                if key not in self._pq_cache:
                    fi = self.fi
                    deltas = [(fi.delta_q_y_dc, 0),
                              (fi.delta_q_u_dc, fi.delta_q_u_ac),
                              (fi.delta_q_v_dc, fi.delta_q_v_ac)][plane]
                    self._pq_cache[key] = build_plane_quant(
                        bq, deltas[0], deltas[1], self.bd)
                pq = self._pq_cache[key]
            dq = dequant_coeffs(qcoeff, ts, pq, iqm=iqm)
            rec = inverse_transform_add(dq, pred, ts, tt, self.bd)
        # clamped write (spec writes within maxX/maxY)
        wx = min(w, max_x + 1 - x)
        wy = min(h, max_y + 1 - y)
        rec_plane[y:y + wy, x:x + wx] = \
            np.asarray(rec[:wy, :wx], rec_plane.dtype)
        if plane == 0:
            self.max_luma_w = x + step_x * 4
            self.max_luma_h = y + step_y * 4
        self._bdset(plane, u_row, u_col, step_y, step_x)

    def _predict(self, b, plane, mode, angle_delta, x, y, w, h, have_above,
                 have_left, have_ar, have_bl, max_x, max_y):
        bd = self.bd
        plane_arr = self.planes[plane]
        base = 1 << (bd - 1)
        # edge construction (spec 7.11.2 steps 1-3)
        above = np.zeros(w + h, np.int32)
        left = np.zeros(w + h, np.int32)
        if not have_above and have_left:
            above[:] = int(plane_arr[y, x - 1])
        elif not have_above:
            above[:] = base - 1
        else:
            lim = min(max_x, x + (2 * w if have_ar else w) - 1)
            xs = np.minimum(np.arange(x, x + w + h), lim)
            above[:] = plane_arr[y - 1, xs]
        if not have_left and have_above:
            left[:] = int(plane_arr[y - 1, x])
        elif not have_left:
            left[:] = base + 1
        else:
            lim = min(max_y, y + (2 * h if have_bl else h) - 1)
            ys = np.minimum(np.arange(y, y + h + w), lim)
            left[:] = plane_arr[ys, x - 1]
        if have_above and have_left:
            al = int(plane_arr[y - 1, x - 1])
        elif have_above:
            al = int(plane_arr[y - 1, x])
        elif have_left:
            al = int(plane_arr[y, x - 1])
        else:
            al = base

        if plane == 0 and b.use_filter_intra:
            return ip.filter_intra_pred(b.filter_intra_mode, above, left, al,
                                        w, h, bd)
        m = PredMode(mode)
        if ip.PredMode.V_PRED <= m <= ip.PredMode.D67_PRED:
            pidx = 0 if plane == 0 else 1
            c = b.mi_col >> (1 if plane else 0)
            r = b.mi_row >> (1 if plane else 0)
            ab_sm = int(self.above_smooth[pidx][min(b.mi_col, self.mi_cols - 1)]) \
                if have_above else 0
            le_sm = int(self.left_smooth[pidx][min(b.mi_row, self.mi_rows - 1)]) \
                if have_left else 0
            ftype = 1 if (ab_sm or le_sm) else 0
            return ip.directional_pred(
                mode, angle_delta, above, left, al, w, h, have_above,
                have_left, enable_edge_filter=self.edge_filter,
                filter_type=ftype, n_top_px=max_x - x + 1,
                n_left_px=max_y - y + 1, bd=bd)
        return ip.predict(mode, above, left, al, w, h, have_above, have_left,
                          bd)

    def _apply_cfl(self, b, plane, x, y, w, h, dc_pred, sub):
        # alpha from joint sign + idx (spec 5.11.45 semantics)
        js = b.cfl_joint_sign
        sign_u = ((js + 1) * 11) >> 5
        sign_v = (js + 1) - 3 * sign_u
        sign = sign_u if plane == 1 else sign_v
        if sign == 0:
            return dc_pred
        idx = b.cfl_idx_u if plane == 1 else b.cfl_idx_v
        alpha = (idx + 1) * (1 if sign == 2 else -1)
        # subsampled luma from recon, clamped to decoded luma extent
        lx = x << sub
        ly = y << sub
        lw = w << sub
        lh = h << sub
        luma = self.planes[0]
        xs = np.minimum(np.arange(lx, lx + lw), self.max_luma_w - 1)
        ys = np.minimum(np.arange(ly, ly + lh), self.max_luma_h - 1)
        lbuf = luma[np.ix_(ys, xs)]
        ac = ip.cfl_luma_ac(lbuf, w, h)
        return ip.cfl_pred(dc_pred, ac, alpha, self.bd)

    def apply_dlf(self, levels, sharpness: int = 0) -> None:
        """In-place deblocking of the reconstruction (spec 7.14); levels =
        (y_vert, y_horz, u, v)."""
        from svt_av1_psy_tpu_torch.ops.loopfilter import (LoopFilterMaps,
                                                    apply_loop_filter)
        maps = LoopFilterMaps(txw=self.lf_txw, txh=self.lf_txh,
                              skip_inter=self.lf_skip_inter,
                              ox=self.lf_ox, oy=self.lf_oy)
        dims = [(self.width, self.height),
                ((self.width + 1) >> 1, (self.height + 1) >> 1),
                ((self.width + 1) >> 1, (self.height + 1) >> 1)]
        apply_loop_filter(self.planes, maps, levels, sharpness, dims,
                          bd=self.bd)

    def apply_cdef(self, levels, damping: int, cdef_idx=None) -> None:
        """In-place CDEF (spec 7.15); levels = one (y_pri, y_sec, uv_pri,
        uv_sec) tuple or a list of them indexed by the per-64x64 cdef_idx
        grid. sec values already 3->4 mapped."""
        from svt_av1_psy_tpu_torch.ops.cdef import cdef_frame
        dims = [(self.width, self.height),
                ((self.width + 1) >> 1, (self.height + 1) >> 1),
                ((self.width + 1) >> 1, (self.height + 1) >> 1)]
        cdef_frame(self.planes, self.skip_map, levels, damping, dims,
                   bd=self.bd, cdef_idx=cdef_idx)
