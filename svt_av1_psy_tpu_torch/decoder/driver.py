"""Stateful AV1 decode driver: OBU walk + DPB + CDF slot management.

Ties together header parsing, tile parsing, reconstruction and the in-loop
filters for multi-frame streams (KEY + INTER), maintaining the 8-slot
reference state: decoded planes, order hints, and end-of-frame CDF contexts
(primary_ref_frame inheritance, disable_frame_end_update_cdf semantics).
Mirrors the reference decode loop structure; conformance oracle is dav1d.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from svt_av1_psy_tpu_torch.bitstream.ivf import read_ivf
from svt_av1_psy_tpu_torch.bitstream.obu import ObuType, parse_obus
from svt_av1_psy_tpu_torch.decoder.header_parser import (parse_frame_header,
                                                   parse_sequence_header)
from svt_av1_psy_tpu_torch.decoder.reconstruct import FrameReconstructor
from svt_av1_psy_tpu_torch.decoder.tile_parser import TileParser
from svt_av1_psy_tpu_torch.entropy.frame_context import FrameContext


@dataclass
class DecodedPlanes:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    order_hint: int = 0


class Decoder:
    def __init__(self):
        self.seq = None
        self.slots: List[Optional[DecodedPlanes]] = [None] * 8
        self.slot_cdfs: List[Optional[FrameContext]] = [None] * 8
        self.slot_hints = [0] * 8
        # saved motion fields per slot (spec 7.20; MFMV input)
        self.slot_mf = [None] * 8
        # saved segmentation per slot: ((feat_en, feat_data, last_active,
        # pre_skip), seg_map) — spec 7.20 SegmentIds / feature persistence
        self.slot_seg = [None] * 8
        # SavedGmParams per slot (spec 7.20): 7x (wm0, wm1), identity=0
        self.slot_gm = [((0, 0),) * 7 for _ in range(8)]
        self.frames: List[DecodedPlanes] = []

    def decode_temporal_unit(self, payload: bytes):
        for t, _, _, p in parse_obus(payload):
            if t == ObuType.SEQUENCE_HEADER:
                self.seq = parse_sequence_header(p)
            elif t == ObuType.FRAME:
                self._decode_frame(p)
            elif t == ObuType.FRAME_HEADER:
                fi = parse_frame_header(p, self.seq,
                                        ref_order_hints=self.slot_hints)
                assert fi.show_existing_frame, \
                    "redundant frame headers unsupported"
                self.frames.append(self.slots[fi.frame_to_show_map_idx])

    def _decode_frame(self, payload: bytes):
        seq = self.seq
        fi = parse_frame_header(payload, seq, ref_order_hints=self.slot_hints,
                                ref_gm=self.slot_gm)
        # superres: the frame codes at the downscaled width and is
        # upscaled back to seq.width after CDEF (spec 7.16)
        W = fi.frame_width or seq.width
        H = seq.height
        up_w = seq.width
        mi_rows = 2 * ((H + 7) >> 3)
        mi_cols = 2 * ((W + 7) >> 3)
        is_inter = fi.frame_type == 1

        if fi.primary_ref_frame == 7 or not is_inter:
            fc0 = FrameContext(fi.base_q_idx)
        else:
            fc0 = self.slot_cdfs[
                fi.ref_frame_idx[fi.primary_ref_frame]].inherit_copy()
        start_cdf = fc0.copy() if fi.disable_frame_end_update_cdf else None

        # tile grid (spec 5.11.1 tile_group_obu): column/row starts in SB
        # units from the uniform tile info; each tile parses independently
        # with its own CDF context starting from the frame-initial one
        col_starts = fi.tile_col_starts or [0, (mi_cols + 15) // 16]
        row_starts = fi.tile_row_starts or [0, (mi_rows + 15) // 16]
        n_tile_cols = len(col_starts) - 1
        n_tile_rows = len(row_starts) - 1
        n_tiles = n_tile_cols * n_tile_rows
        data = payload[fi.header_bytes:]
        tile_data = []
        if n_tiles == 1:
            tile_data = [data]
        else:
            # OBU_FRAME: tile_start_and_end_present_flag == 0 + alignment
            # -> one zero byte, then le(tile_size_bytes) sizes between
            # tiles (none for the last)
            pos = 1
            for ti in range(n_tiles - 1):
                sz = int.from_bytes(
                    data[pos:pos + fi.tile_size_bytes], "little") + 1
                pos += fi.tile_size_bytes
                tile_data.append(data[pos:pos + sz])
                pos += sz
            tile_data.append(data[pos:])

        fr = FrameReconstructor(
            W, H, fi, bd=seq.bit_depth,
            enable_intra_edge_filter=seq.enable_intra_edge_filter)
        ref_hints = [self.slot_hints[fi.ref_frame_idx[k]] for k in range(7)] \
            if is_inter else [0] * 7
        ohb = seq.order_hint_bits if seq.enable_order_hint else 0
        if is_inter:
            fr.ref_planes = [
                None if self.slots[i] is None else
                (self.slots[i].y, self.slots[i].u, self.slots[i].v)
                for i in range(8)]
            fr.ref_frame_idx = fi.ref_frame_idx
            fr.interp_filter = fi.interp_filter
            fr.ref_hints = ref_hints
            fr.cur_order_hint = fi.order_hint
            fr.order_hint_bits = ohb

        # segmentation wiring (spec 5.11.14): resolve inherited feature
        # data + the primary ref's segment map for prediction
        seg = None
        seg_store = None
        if fi.segmentation_enabled:
            feat_en = fi.seg_feature_enabled
            feat_data = fi.seg_feature_data
            last_active = fi.seg_last_active
            pre_skip = fi.seg_id_pre_skip
            prev_map = None
            if fi.primary_ref_frame != 7:
                ps = self.slot_seg[fi.ref_frame_idx[fi.primary_ref_frame]]
                if ps is not None:
                    if not fi.seg_update_data:
                        feat_en, feat_data, last_active, pre_skip = ps[0]
                    prev_map = ps[1]
            for i in range(8):
                for j in range(1, 8):
                    assert not feat_en[i][j], \
                        f"segmentation feature {j} unsupported"
            seg = dict(enabled=True, update_map=fi.seg_update_map,
                       temporal=fi.seg_temporal_update,
                       pre_skip=pre_skip, last_active=last_active,
                       altq=[feat_data[i][0] if feat_en[i][0] else None
                             for i in range(8)],
                       prev_map=prev_map)
            seg_store = (feat_en, feat_data, last_active, pre_skip)

        # motion field projection (spec 7.9) for the temporal MV stack
        tpl_mvs = None
        if is_inter and fi.use_ref_frame_mvs:
            from svt_av1_psy_tpu_torch.inter.mfmv import setup_motion_field
            tpl_mvs = setup_motion_field(self.slot_mf, fi.ref_frame_idx,
                                         fi.order_hint, ohb, mi_rows,
                                         mi_cols)

        tp = None                   # context_update_tile_id's parser
        cdef_idx = None
        lr_units = [{}, {}, {}]
        tile_grids = []
        seg_map = None
        for ti, td in enumerate(tile_data):
            tr, tc = ti // n_tile_cols, ti % n_tile_cols
            r0 = min(row_starts[tr] * 16, mi_rows)
            r1 = min(row_starts[tr + 1] * 16, mi_rows)
            c0 = min(col_starts[tc] * 16, mi_cols)
            c1 = min(col_starts[tc + 1] * 16, mi_cols)
            fc = fc0 if n_tiles == 1 else fc0.copy()
            tpi = TileParser(
                fc, td, mi_rows, mi_cols,
                tx_mode_select=fi.tx_mode_select,
                reduced_tx_set=fi.reduced_tx_set,
                delta_q_present=fi.delta_q_present,
                enable_filter_intra=seq.enable_filter_intra,
                cdef_bits=fi.cdef_bits if seq.enable_cdef else -1,
                frame_is_intra=not is_inter,
                allow_hp=fi.allow_high_precision_mv,
                force_integer_mv=fi.force_integer_mv,
                reference_select=fi.reference_select,
                switchable_filter=fi.is_filter_switchable,
                dual_filter=seq.enable_dual_filter,
                enable_interintra=seq.enable_interintra_compound,
                motion_mode_switchable=fi.is_motion_mode_switchable,
                allow_warped_motion=fi.allow_warped_motion,
                skip_mode_present=fi.skip_mode_present,
                skip_mode_frame=fi.skip_mode_frame,
                ref_order_hints=ref_hints,
                cur_order_hint=fi.order_hint,
                order_hint_bits=ohb,
                enable_jnt_comp=seq.enable_jnt_comp,
                enable_masked_compound=seq.enable_masked_compound,
                gm_trans=fi.gm_trans,
                lr_type=fi.lr_type, lr_unit_size=fi.lr_unit_size,
                frame_width=W, frame_height=H,
                base_q_idx=fi.base_q_idx,
                delta_q_res_log2=fi.delta_q_res_log2,
                allow_update_cdf=not fi.disable_cdf_update,
                mi_bounds=(r0, r1, c0, c1), tpl_mvs=tpl_mvs, seg=seg,
                allow_intrabc=fi.allow_intrabc,
                allow_screen_content=fi.allow_screen_content_tools,
                bit_depth=seq.bit_depth)
            blocks = tpi.parse_tile()
            if is_inter:
                tile_grids.append((tpi.grid, (r0, r1, c0, c1)))
            if seg is not None:
                if seg_map is None:
                    seg_map = np.zeros((mi_rows, mi_cols), np.int8)
                seg_map[r0:r1, c0:c1] = tpi.seg_map[r0:r1, c0:c1]
            fr.set_tile(r0, r1, c0, c1)
            fr.decode_blocks(blocks)
            if ti == fi.context_update_tile_id:
                tp = tpi
            cdef_idx = tpi.cdef_idx if cdef_idx is None else \
                np.where(tpi.cdef_idx >= 0, tpi.cdef_idx, cdef_idx)
            for pl in range(3):
                lr_units[pl].update(tpi.lr_units[pl])
        fc = tp.fc

        lf = (fi.filter_level[0], fi.filter_level[1],
              fi.filter_level_uv[0], fi.filter_level_uv[1])
        if any(lf):
            fr.apply_dlf(lf, fi.sharpness)
        lr_active = (seq.enable_restoration and fi.lr_type is not None and
                     any(fi.lr_type))
        deblock_copy = [p.copy() for p in fr.planes] if lr_active else None
        if seq.enable_cdef and fi.cdef_y_pri is not None:
            sets = [(yp, ys + (ys == 3), up, us + (us == 3))
                    for yp, ys, up, us in zip(fi.cdef_y_pri, fi.cdef_y_sec,
                                              fi.cdef_uv_pri,
                                              fi.cdef_uv_sec)]
            if any(any(sv) for sv in sets):
                fr.apply_cdef(sets, fi.cdef_damping, cdef_idx=cdef_idx)
        out_planes = fr.planes
        if fi.use_superres:
            # normative upscale (spec 7.16): after CDEF, before LR
            from svt_av1_psy_tpu_torch.ops.resize import superres_upscale_frame
            assert not lr_active, \
                "loop restoration on superres frames unsupported"
            aw = mi_cols * 4
            out_planes = list(superres_upscale_frame(
                (fr.planes[0][:H, :aw],
                 fr.planes[1][:(H + 1) // 2, :(aw + 1) // 2],
                 fr.planes[2][:(H + 1) // 2, :(aw + 1) // 2]),
                up_w, fi.superres_denom, seq.bit_depth,
                tile_mi_starts=[s * 16 for s in col_starts], coded_w=W))
        elif lr_active:
            from svt_av1_psy_tpu_torch.ops.restoration import apply_lr_frame
            dims = [(W, H), ((W + 1) >> 1, (H + 1) >> 1),
                    ((W + 1) >> 1, (H + 1) >> 1)]
            apply_lr_frame(fr.planes, deblock_copy, dims, fi.lr_type,
                           fi.lr_unit_size, lr_units, bd=seq.bit_depth)

        oW = up_w if fi.use_superres else W
        out = DecodedPlanes(
            y=out_planes[0][:H, :oW].copy(),
            u=out_planes[1][:(H + 1) // 2, :(oW + 1) // 2].copy(),
            v=out_planes[2][:(H + 1) // 2, :(oW + 1) // 2].copy(),
            order_hint=fi.order_hint)
        if fi.show_frame:
            self.frames.append(out)

        # with disable_frame_end_update_cdf the stored context is the
        # frame's STARTING context, not the adapted one
        store_cdf = start_cdf if fi.disable_frame_end_update_cdf else fc
        refresh = fi.refresh_frame_flags if is_inter or not fi.show_frame \
            else 0xFF
        cur_gm = tuple((wm if wm is not None else (0, 0))
                       for wm in (fi.gm_trans or [None] * 7))
        from svt_av1_psy_tpu_torch.inter.mfmv import save_motion_field
        mf = save_motion_field(tile_grids, mi_rows, mi_cols,
                               fi.order_hint, ref_hints, ref_hints, ohb,
                               is_intra=not is_inter)
        for i in range(8):
            if refresh & (1 << i):
                self.slots[i] = out
                self.slot_cdfs[i] = store_cdf
                self.slot_hints[i] = fi.order_hint
                self.slot_gm[i] = cur_gm
                self.slot_mf[i] = mf
                self.slot_seg[i] = (seg_store, seg_map) \
                    if seg_store is not None else None


def decode_ivf(data: bytes) -> List[DecodedPlanes]:
    if isinstance(data, str):
        data = open(data, "rb").read()
    _, frames = read_ivf(data)
    dec = Decoder()
    for _, payload in frames:
        dec.decode_temporal_unit(payload)
    return dec.frames
