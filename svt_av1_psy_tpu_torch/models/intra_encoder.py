"""All-intra encoder model — full mode set, shared normative recon path.

KEY-frame encoder: recursive square partitioning 64→8 seeded by a batched
device mode search (ops/jax_backend.block_mode_costs), then a host commit
pass where PREDICTION AND RECONSTRUCTION run through the conformance
decoder's FrameReconstructor — the same code dav1d-validated bit-exact — so
every intra tool it supports (directional modes with edge filter/upsample,
smooth family, Paeth) is available to the encoder for free and recon always
matches the decoder.

Mode decision: SAD preselect over the full candidate set with exact
predictions, then RD commit (distortion + lambda * estimated rate) over the
top candidates, angle-delta refinement for directional winners. The funnel
mirrors the reference's staged MD (ref: Source/Lib/Codec/mode_decision.c
md_stage_0/3) at a bring-up feature level.

The port's copy of svt_av1_psy_tpu/models/intra_encoder.py. Its one
device stage, _decide, runs the open-loop mode costs of every block size
on ``device`` ("cpu" or "cuda[:N]"; the port's block_mode_costs) and
brings each size's min over modes home through one HostCopy; the split
tree over those costs is the reference's. Everything else is the
reference's code; tests/test_torch_standalone.py lists what differs and
guards the rest against drift.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from svt_av1_psy_tpu_torch.bitstream.headers import (FrameParams, SequenceParams,
                                               key_frame_temporal_unit)
from svt_av1_psy_tpu_torch.constants import (BLOCK_SIZE_HIGH, BLOCK_SIZE_WIDE,
                                       BlockSize, Partition, PredMode, TxSize,
                                       TxType)
from svt_av1_psy_tpu_torch.decoder.reconstruct import FrameReconstructor
from svt_av1_psy_tpu_torch.decoder.tile_parser import ParsedBlock
from svt_av1_psy_tpu_torch.entropy.frame_context import FrameContext
from svt_av1_psy_tpu_torch.entropy.tile_writer import (BlockRecord, TileWriter,
                                                 TxbData, cfl_allowed,
                                                 has_chroma, use_angle_delta)
from svt_av1_psy_tpu_torch.entropy.tx_sets import (EXT_TX_INV, intra_tx_set,
                                             uv_tx_type)
from svt_av1_psy_tpu_torch.entropy.tx_trees import SUB_TX, max_tx_depth
from svt_av1_psy_tpu_torch.ops.quant import ac_q, dc_q, build_plane_quant, quantize_b
from svt_av1_psy_tpu_torch.ops.transforms import (forward_transform_2d,
                                            inverse_transform_add)
from svt_av1_psy_tpu_torch.ops.torch_backend import (block_mode_costs,
                                                     plane_tensor)
from svt_av1_psy_tpu_torch.utils.device import HostCopy, resolve_device

SB = 64
_SQ_BSIZE = {64: int(BlockSize.BLOCK_64X64), 32: int(BlockSize.BLOCK_32X32),
             16: int(BlockSize.BLOCK_16X16), 8: int(BlockSize.BLOCK_8X8)}
_SQ_TX = {64: int(TxSize.TX_64X64), 32: int(TxSize.TX_32X32),
          16: int(TxSize.TX_16X16), 8: int(TxSize.TX_8X8),
          4: int(TxSize.TX_4X4)}

ALL_Y_MODES = tuple(range(13))          # DC..PAETH incl. directional


class EncodedFrame:
    """One coded packet + its reconstruction.

    The reconstruction may be produced asynchronously (the fast path
    defers in-loop filter application off the critical path in all-intra
    mode, SURVEY §2.2 P1); accessing any recon plane joins that work.
    """

    __slots__ = ("payload", "_ry", "_ru", "_rv", "_resolve")

    def __init__(self, payload: bytes, recon_y=None, recon_u=None,
                 recon_v=None, resolve=None):
        self.payload = payload
        self._ry, self._ru, self._rv = recon_y, recon_u, recon_v
        self._resolve = resolve

    def _fin(self):
        if self._resolve is not None:
            self._ry, self._ru, self._rv = self._resolve()
            self._resolve = None

    @property
    def recon_y(self):
        self._fin()
        return self._ry

    @property
    def recon_u(self):
        self._fin()
        return self._ru

    @property
    def recon_v(self):
        self._fin()
        return self._rv


def _pad_to(plane: np.ndarray, H: int, W: int) -> np.ndarray:
    h, w = plane.shape
    return np.pad(plane, ((0, H - h), (0, W - w)), mode="edge")


class IntraEncoder:
    """Fixed-QP all-intra encoder (KEY frames only), arbitrary resolution."""

    def __init__(self, width: int, height: int, qindex: int, bd: int = 8,
                 min_block: int = 8, use_device_search: bool = True,
                 backend: str = "native", search_top_k: int = 3, *,
                 device):
        if backend == "native":
            try:
                from svt_av1_psy_tpu_torch import native
                native.ensure_txfms()
            except Exception:
                backend = "python"
        self.backend = backend
        # where the mode search runs ("cpu" or "cuda[:N]")
        self.device = resolve_device(device)
        assert width % 2 == 0 and height % 2 == 0
        self.width, self.height = width, height
        self.qindex = qindex
        self.bd = bd
        self.min_block = min_block
        self.use_device_search = use_device_search
        self.top_k = search_top_k
        self.mi_cols = 2 * ((width + 7) >> 3)
        self.mi_rows = 2 * ((height + 7) >> 3)
        self.aw = self.mi_cols * 4
        self.ah = self.mi_rows * 4
        self.paw = (self.aw + SB - 1) // SB * SB
        self.pah = (self.ah + SB - 1) // SB * SB
        self.seq = SequenceParams(width=width, height=height, bit_depth=bd,
                                  enable_cdef=True, enable_restoration=False)
        self.pq = build_plane_quant(qindex, bd=bd)
        # lambda for D + lambda*R (D in SSE, R in bits); dc_q is Q3
        qstep = dc_q(qindex, bd) / 8.0
        self.rdmult = 0.12 * qstep * qstep
        self.frame_index = 0
        self.gop_size = 1          # 1 = all-intra; 0 = single key then P
        self.p_qindex = None       # qindex for P frames (default: qindex)
        self.rc = None             # optional RateControl
        self.dpb = None            # (y, u, v) padded recon of last frame
        self.records = []  # BlockRecords of the last encoded frame (debug)
        self.force_y_mode = None   # debug: force luma mode for all blocks
        self.force_ady = 0         # debug: forced angle delta
        self.force_types = None    # debug: force luma tx-type candidates
        self.enable_rect = True    # HORZ/VERT partition candidates
        # screen content tools (--scm): luma palette search on key frames
        self.screen_content = False
        # intra block copy (spec 5.11.31; needs screen_content): DV search
        # on key frames; disables in-loop filters for the frame (spec 5.9.11)
        self.enable_intrabc = False
        # --scm 2: per-key-frame screen-content detection (the
        # pic_analysis_process.c sc detector role)
        self.scm_auto = False
        # variance-boost AQ (ref rc_process.c:1516; PSY flagship feature)
        self.enable_variance_boost = False
        self.vb_strength = 2
        self.vb_octile = 6
        self._vb_pq_cache = {}

    # --- open-loop split decisions (device) ------------------------------
    def _decide(self, yp: np.ndarray):
        """Per size: the cheapest mode's cost and the first cheapest mode
        of every block (block_mode_costs on the device, its min over
        modes taken there), then the reference's bottom-up split tree on
        the host."""
        sizes = [s for s in (64, 32, 16, 8) if s >= self.min_block]
        costs = {}
        bests = {}
        arr = plane_tensor(yp, self.device)
        copies = {}
        for s in sizes:
            c, b = block_mode_costs(arr, s, self.bd)
            copies[s] = HostCopy(torch.stack([c.amin(dim=2), b]))
        for s in sizes:
            cost_best = copies[s].numpy()
            costs[s] = cost_best[0].astype(np.int64)
            bests[s] = cost_best[1]
        bias = 8 * ac_q(self.qindex, self.bd)
        split = {}
        eff = {sizes[-1]: costs[sizes[-1]]}
        for s in sizes[-2::-1]:
            child = eff[s // 2]
            agg = (child[0::2, 0::2] + child[0::2, 1::2] +
                   child[1::2, 0::2] + child[1::2, 1::2])
            do_split = agg + bias < costs[s]
            split[s] = do_split
            eff[s] = np.where(do_split, agg + bias, costs[s])
        return bests, split

    # --- frame ------------------------------------------------------------
    def encode_frame(self, y, u, v) -> EncodedFrame:
        is_p = self.frame_index > 0 and self.gop_size != 1 and \
            (self.frame_index % max(self.gop_size, 1) != 0 or
             self.gop_size == 0)
        if self.rc is not None:
            q = self.rc.frame_qindex(self.frame_index, not is_p)
            if is_p:
                self.p_qindex = q
            else:
                self.qindex = q
                self.pq = build_plane_quant(q, bd=self.bd)
                qstep = dc_q(q, self.bd) / 8.0
                self.rdmult = 0.12 * qstep * qstep
        out = self._encode_p_frame(y, u, v) if is_p \
            else self._encode_key_frame(y, u, v)
        if self.rc is not None:
            self.rc.update(self.p_qindex if is_p else self.qindex,
                           len(out.payload) * 8)
        return out

    def _set_block_q(self, q: int) -> None:
        """Point trials/recon at a per-SB qindex (variance-boost AQ)."""
        if q not in self._vb_pq_cache:
            self._vb_pq_cache[q] = build_plane_quant(q, bd=self.bd)
        self.pq = self._vb_pq_cache[q]
        qstep = dc_q(q, self.bd) / 8.0
        self.rdmult = 0.12 * qstep * qstep

    def _encode_key_frame(self, y, u, v) -> EncodedFrame:
        bd = self.bd
        yp = _pad_to(np.asarray(y), self.pah, self.paw)
        up = _pad_to(np.asarray(u), self.pah // 2, self.paw // 2)
        vp = _pad_to(np.asarray(v), self.pah // 2, self.paw // 2)
        self._src = (yp, up, vp)
        self.records = []

        if self.use_device_search:
            self.bests, self.split = self._decide(yp)
        else:
            self.bests, self.split = None, None

        if self.scm_auto:
            sc = self._detect_screen_content(yp)
            self.screen_content = sc
            self.enable_intrabc = sc

        cfg_q = self.qindex
        vb = None
        dq_res_log2 = 0
        if self.enable_variance_boost:
            from svt_av1_psy_tpu_torch.models.variance_boost import (
                adjust_sb_qindex, sb_8x8_variances)
            self.qindex, dq_res_log2, vb = adjust_sb_qindex(
                cfg_q, sb_8x8_variances(yp), self.vb_strength,
                self.vb_octile, bd)
        # aq-mode 1: variance-based AV1 segments instead of delta-q
        # (ref segmentation.c svt_aom_setup_segmentation /
        # find_segment_qps + apply_segmentation_based_quantization)
        seg_info = None
        if getattr(self, "aq_mode", 0) == 1 and vb is None:
            seg_info = self._setup_segmentation_aq(yp)

        ibc = self.screen_content and self.enable_intrabc
        fr_params = FrameParams(base_q_idx=self.qindex,
                                order_hint=self.frame_index & 0x7F,
                                tx_mode_select=True,
                                delta_q_present=vb is not None,
                                delta_q_res_log2=dq_res_log2,
                                allow_screen_content_tools=
                                self.screen_content,
                                allow_intrabc=ibc)
        if seg_info is not None:
            fr_params.seg_enabled = True
            fr_params.seg_altq = tuple(seg_info["altq"])
        self.fr = FrameReconstructor(
            self.width, self.height, fr_params, bd=bd,
            enable_intra_edge_filter=self.seq.enable_intra_edge_filter)
        fc = FrameContext(self.qindex)
        self.tw = TileWriter(fc, self.mi_rows, self.mi_cols, sb_size=SB,
                             backend=self.backend, tx_mode_select=True,
                             cdef_bits=-1 if ibc else 0,
                             allow_screen_content=self.screen_content,
                             bd=bd, allow_intrabc=ibc,
                             # the seq may be shared with a fast-path
                             # stream that armed filter-intra: the
                             # writer must code the (always-0) flags
                             # the decoder will parse
                             enable_filter_intra=bool(
                                 getattr(self.seq, "enable_filter_intra",
                                         False)),
                             seg=(None if seg_info is None else
                                  dict(last_active=seg_info["last_active"],
                                       map=seg_info["map"])))
        self._ibc_index = self._build_ibc_index(yp) if ibc else None
        self._seg_info = seg_info
        self._sb_ops = []
        prev_q = self.qindex
        for sby in range(0, self.ah, SB):
            for sbx in range(0, self.aw, SB):
                sbq = None
                if vb is not None:
                    sbq = int(vb[sby // SB, sbx // SB])
                    self._set_block_q(sbq)
                    self.fr.q_override = sbq
                elif seg_info is not None:
                    sbq = seg_info["sbq"][sby // SB, sbx // SB]
                    self._set_block_q(int(sbq))
                    self.fr.q_override = int(sbq)
                self.fr.start_block(sby // 4, sbx // 4)
                _, ops = self._search_partition(sby // 4, sbx // 4, 64)
                dq = None
                if vb is not None:
                    # delta vs previously-coded q; not coded for a skipped
                    # sb-sized block (ref entropy_coding.c:4853)
                    first = next(op[1] for op in ops if op[0] == "B")
                    sb_skip = (first.bsize == int(BlockSize.BLOCK_64X64)
                               and first.skip)
                    if not sb_skip:
                        delta = (sbq - prev_q) >> dq_res_log2
                        dq = (abs(delta), 1 if delta < 0 else 0)
                        prev_q = sbq
                self._sb_ops.append((sby // 4, sbx // 4, ops, dq))
                self._write_ops(ops, dq=dq)
        if vb is not None or seg_info is not None:
            self._set_block_q(self.qindex)
            self.fr.q_override = None

        tile = self.tw.finish()
        if ibc:
            # allow_intrabc disables every in-loop filter for the frame
            # (spec 5.9.11/5.9.19/5.9.20: params not coded, inferred off)
            fr_params.cdef_bits = 0
        else:
            lf = self._pick_dlf_levels(yp, up, vp)
            fr_params.filter_level = (lf[0], lf[1])
            fr_params.filter_level_uv = (lf[2], lf[3])
            if any(lf):
                self.fr.apply_dlf(lf, sharpness=0)
            deblock_copy = [pl.copy() for pl in self.fr.planes]
            cdef_grid = self._cdef_stage(fr_params, yp, up, vp, self.qindex)
            tile = self._apply_and_sign_lr(fr_params, tile, deblock_copy,
                                           yp, up, vp, self.qindex,
                                           cdef_grid=cdef_grid)
        payload = key_frame_temporal_unit(
            self.seq, fr_params, tile, with_seq_header=(self.frame_index == 0))
        self.frame_index += 1
        H, W = self.height, self.width
        out = EncodedFrame(
            payload=payload,
            recon_y=self.fr.planes[0][:H, :W].copy(),
            recon_u=self.fr.planes[1][:(H + 1) // 2, :(W + 1) // 2].copy(),
            recon_v=self.fr.planes[2][:(H + 1) // 2, :(W + 1) // 2].copy())
        self.dpb = (out.recon_y, out.recon_u, out.recon_v)
        if vb is not None:          # frame-local AQ base; undo for next frame
            self.qindex = cfg_q
            self._set_block_q(cfg_q)
        return out

    # --- partition walk ---------------------------------------------------
    def _want_split(self, r, c, size) -> bool:
        if size <= self.min_block or self.split is None:
            return False
        return bool(self.split[size][(r * 4) // size, (c * 4) // size])

    def _split_children(self, r, c, size):
        half4 = size // 8
        cost = 0.0
        ops = []
        for (rr, cc2) in ((r, c), (r, c + half4),
                          (r + half4, c), (r + half4, c + half4)):
            cst, o = self._search_partition(rr, cc2, size // 2)
            cost += cst
            ops += o
        return cost, ops

    def _search_partition(self, r, c, size):
        """RD partition search: returns (cost, write-ops). Reconstruction
        of the winning layout is left committed (ref md walk,
        product_coding_loop.c)."""
        if r >= self.mi_rows or c >= self.mi_cols:
            return 0.0, []
        from svt_av1_psy_tpu_torch.decoder.tile_parser import _subsize
        tw = self.tw
        bsize = _SQ_BSIZE[size]
        has_rows, has_cols = tw._partition_bounds(r, c, bsize)
        if not (has_rows and has_cols) and size > 8:
            cost, ops = self._split_children(r, c, size)
            return cost, [("P", r, c, bsize, int(Partition.SPLIT))] + ops
        can_split = size > self.min_block
        half4 = size // 8
        w4 = size // 4

        # candidate layouts: NONE, then HORZ/VERT when partitionable
        cands = [(int(Partition.NONE), bsize, [(r, c, bsize)])]
        if can_split and self.enable_rect:
            hb = _subsize(bsize, int(Partition.HORZ))
            vb = _subsize(bsize, int(Partition.VERT))
            cands.append((int(Partition.HORZ), hb,
                          [(r, c, hb), (r + half4, c, hb)]))
            cands.append((int(Partition.VERT), vb,
                          [(r, c, vb), (r, c + half4, vb)]))
        multi = can_split or len(cands) > 1
        pre = self.fr.snapshot_area(r, c, w4, w4) if multi else None
        best = None        # (cost, part, sub, [(rec, replay)...])
        for part, sub, blocks in cands:
            cost = self.rdmult * tw.rate_partition(r, c, bsize, part)
            items = []
            for (br, bc, bb) in blocks:
                cb, rec, replay = self._search_block(br, bc, bb)
                cost += cb
                items.append((rec, replay))
            if best is None or cost < best[0]:
                best = (cost, part, sub, items)
            if multi:
                self.fr.restore_area(pre)
        if can_split:
            cost_c, ops_c = self._split_children(r, c, size)
            cost_s = cost_c + self.rdmult * tw.rate_partition(
                r, c, bsize, int(Partition.SPLIT))
            if cost_s <= best[0]:
                return cost_s, [("P", r, c, bsize,
                                 int(Partition.SPLIT))] + ops_c
            self.fr.restore_area(pre)
        if multi:
            for (_, replay) in best[3]:
                self._replay_block(replay)
        ops = [("P", r, c, bsize, best[1])]
        ops += [("B", rec) for (rec, _) in best[3]]
        ops.append(("PC", r, c, bsize, best[2]))
        return best[0], ops

    def _write_ops(self, ops, dq=None):
        tw = self.tw
        for op in ops:
            if op[0] == "P":
                _, r, c, bsize, part = op
                tw.write_partition(r, c, bsize, part)
            elif op[0] == "PC":
                _, r, c, bsize, sub = op
                tw.update_partition_ctx(r, c, bsize, sub)
            else:
                rec = op[1]
                self.records.append(rec)
                tw.write_block(rec, delta_q=dq)
                dq = None          # only the SB's first block codes it

    # --- in-loop deblocking (ref av1_pick_filter_level) -------------------
    def _pick_dlf_levels(self, yp, up, vp):
        """Per-plane filter level by direct distortion search: filter a
        copy of the recon at candidate levels, keep the min-SSE one."""
        from svt_av1_psy_tpu_torch.ops.loopfilter import (LoopFilterMaps,
                                                    apply_loop_filter)
        fr = self.fr
        maps = LoopFilterMaps(txw=fr.lf_txw, txh=fr.lf_txh)
        H, W = self.height, self.width
        srcs = [yp[:H, :W], up[:(H + 1) // 2, :(W + 1) // 2],
                vp[:(H + 1) // 2, :(W + 1) // 2]]
        dims = [(W, H), ((W + 1) // 2, (H + 1) // 2),
                ((W + 1) // 2, (H + 1) // 2)]

        def sse(plane, lvl):
            img = fr.planes[plane].copy()
            levels = [0, 0, 0, 0]
            if plane == 0:
                levels[0] = levels[1] = lvl
            else:
                levels[1 + plane] = lvl
            apply_loop_filter([img if p == plane else fr.planes[p]
                               for p in range(3)] if plane == 0 else
                              [fr.planes[0], img, img],
                              maps, levels, 0, dims)
            h, w = srcs[plane].shape
            d = img[:h, :w].astype(np.int64) - srcs[plane].astype(np.int64)
            return float((d * d).sum())

        out = []
        for plane, cands in ((0, (0, 2, 4, 8, 12, 16, 24, 32)),
                             (1, (0, 2, 4, 8, 16)),
                             (2, (0, 2, 4, 8, 16))):
            best = min(cands, key=lambda lv: sse(plane, lv))
            if plane == 0 and best > 0:
                ref = {lv: sse(plane, lv) for lv in
                       (max(0, best - 2), best, best + 2)}
                best = min(ref, key=ref.get)
            out.append(best)
        if out[0] == 0:
            # chroma levels are only coded when a luma level is nonzero
            # (spec 5.9.11) - zero them to keep signal and recon in sync
            out[1] = out[2] = 0
        return (out[0], out[0], out[1], out[2])

    # --- CDEF strength search (ref enc_cdef.c) ---------------------------
    def _pick_cdef(self, yp, up, vp):
        from svt_av1_psy_tpu_torch.ops.cdef import CdefSearch
        H, W = self.height, self.width
        dims = [(W, H), ((W + 1) >> 1, (H + 1) >> 1),
                ((W + 1) >> 1, (H + 1) >> 1)]
        srcs = [yp, up, vp]
        cs = CdefSearch(self.fr.planes, self.fr.skip_map, dims, bd=self.bd)
        if not cs.blocks:
            return (0, 0, 0, 0)
        return cs.search(srcs, 3 + (self.qindex >> 6))

    def _setup_segmentation_aq(self, yp):
        """aq-mode 1: bucket 64x64 SBs into AV1 segments by variance and
        assign per-segment ALT_Q deltas (ref segmentation.c
        find_segment_qps; the per-SB assignment plays the
        apply_segmentation_based_quantization role at SB granularity)."""
        sbr = (self.ah + 63) // 64
        sbc = (self.aw + 63) // 64
        var = np.zeros((sbr, sbc))
        for i in range(sbr):
            for j in range(sbc):
                blk = yp[i * 64:(i + 1) * 64,
                         j * 64:(j + 1) * 64].astype(np.float64)
                var[i, j] = blk.var()
        lo, hi = float(var.min()), float(var.max())
        if hi - lo < 1e-6:
            return None
        edges = lo + (hi - lo) * (np.arange(1, 8) / 8.0)
        seg_sb = np.digitize(var, edges).astype(np.int8)     # 0..7
        avg_seg = int(np.digitize([var.mean()], edges)[0])
        strength = int(getattr(self, "aq_strength", 4))
        # keep base+altq >= 1 so the decode-side Clip3(0,255) agrees
        altq = [max(1 - self.qindex, max(-48, min(48,
                                                  (i - avg_seg) * strength)))
                for i in range(8)]
        # per-mi segment map + per-SB effective qindex
        seg_map = np.repeat(np.repeat(seg_sb, 16, 0), 16, 1)
        seg_map = seg_map[:self.mi_rows, :self.mi_cols]
        sbq = np.clip(self.qindex +
                      np.array(altq, np.int32)[seg_sb], 1, 255)
        return dict(map=seg_map, sbq=sbq,
                    altq=[int(a) for a in altq], last_active=7)

    def _cdef_stage(self, fr_params, yp, up, vp, q):
        """CDEF search + apply + header signalling. Per-64x64 search
        (cdef_bits up to 2) when cdef_unit_search is on, else the
        frame-level single-strength ladder. Returns the per-unit index
        grid for the tile rewrite (None when cdef_bits == 0)."""
        damping = 3 + (q >> 6)
        fr_params.cdef_damping = damping
        if getattr(self, "cdef_unit_search", True):
            bits, ylist, clist, idx_map = self._pick_cdef_units(yp, up, vp)
            fr_params.cdef_bits = bits
            fr_params.cdef_y_pri = tuple(p for p, _ in ylist)
            fr_params.cdef_y_sec = tuple(s - (s == 4) for _, s in ylist)
            fr_params.cdef_uv_pri = tuple(p for p, _ in clist)
            fr_params.cdef_uv_sec = tuple(s - (s == 4) for _, s in clist)
            return idx_map if bits > 0 else None
        cdef = self._pick_cdef(yp, up, vp)
        fr_params.cdef_bits = 0
        fr_params.cdef_y_pri = (cdef[0],)
        fr_params.cdef_y_sec = (cdef[1] - (cdef[1] == 4),)
        fr_params.cdef_uv_pri = (cdef[2],)
        fr_params.cdef_uv_sec = (cdef[3] - (cdef[3] == 4),)
        if any(cdef):
            self.fr.apply_cdef(cdef, damping)
        return None

    # candidate (pri, sec) pairs for the per-unit search; sec 3 is not
    # representable in the header (coded 3 decodes as 4), so sec in
    # {0, 1, 2, 4}
    _CDEF_YCANDS = ((0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (3, 1),
                    (4, 0), (4, 2), (6, 2), (8, 2), (12, 2), (15, 4))
    _CDEF_CCANDS = ((0, 0), (1, 0), (2, 0), (2, 1), (4, 1), (6, 2))

    def _pick_cdef_units(self, yp, up, vp):
        """Per-64x64 CDEF strength search with greedy joint list
        selection over luma x chroma candidate pairs (ref enc_cdef.c:728
        per-fb mse + joint_strength_search_dual), then per-unit apply.
        Returns (cdef_bits, ylist, clist, idx_map) — idx_map feeds the
        tile rewrite's cdef_grid."""
        from svt_av1_psy_tpu_torch import native
        H, W = self.height, self.width
        damping = 3 + (self.qindex >> 6)
        pl16 = [np.ascontiguousarray(p, np.uint16) for p in self.fr.planes]
        sr16 = [np.ascontiguousarray(s, np.uint16) for s in (yp, up, vp)]
        YC, CC = self._CDEF_YCANDS, self._CDEF_CCANDS
        ssey, ssec, has = native.cdef_unit_sse(
            pl16, sr16, self.fr.skip_map, W, H, self.bd, damping, YC, CC)
        n64r, n64c = has.shape
        units = has.reshape(-1)
        if not units.any():
            return 0, [(0, 0)], [(0, 0)], np.zeros((n64r, n64c), np.uint8)
        sy = ssey.reshape(-1, len(YC))[units]
        sc = ssec.reshape(-1, len(CC))[units]
        # quadruple cost matrix: (U, ky*kc), index q = iy * kc + ic
        tot = (sy[:, :, None] + sc[:, None, :]).reshape(len(sy), -1)
        lam_bit = self.rdmult * 4.0          # filter-search rate scale

        def greedy(nb):
            sel = [int(tot.sum(axis=0).argmin())]
            cur = tot[:, sel[0]].copy()
            while len(sel) < nb:
                gains = np.minimum(cur[:, None], tot).sum(axis=0)
                gains[sel] = np.inf
                nxt = int(gains.argmin())
                sel.append(nxt)
                cur = np.minimum(cur, tot[:, nxt])
            return sel, cur.sum()

        best = None
        for bits in (0, 1, 2):
            sel, dist = greedy(1 << bits)
            cost = dist + lam_bit * bits * len(sy)
            if best is None or cost < best[0]:
                best = (cost, bits, sel)
        _, bits, sel = best
        idxq = tot[:, sel].argmin(axis=1).astype(np.uint8)
        idx_map = np.zeros(n64r * n64c, np.uint8)
        idx_map[units] = idxq
        idx_map = idx_map.reshape(n64r, n64c)
        ylist = [YC[s // len(CC)] for s in sel]
        clist = [CC[s % len(CC)] for s in sel]
        if any(any(q) for q in ylist) or any(any(q) for q in clist):
            native.cdef_apply_idx(pl16, self.fr.skip_map, W, H, self.bd,
                                  damping, ylist, clist, idx_map)
            for p, p16 in zip(self.fr.planes, pl16):
                p[:] = p16
        return bits, ylist, clist, idx_map

    # --- transforms (native or python) ------------------------------------
    def _tq(self, resid, ts, tt):
        if self.backend == "native":
            from svt_av1_psy_tpu_torch import native
            coeff = native.fwd_txfm2d(resid, ts, tt, self.bd)
            return native.quantize_b(coeff, ts, self.pq)
        coeff = forward_transform_2d(resid, ts, tt, self.bd)
        return quantize_b(coeff, ts, self.pq)

    # --- block coding ------------------------------------------------------
    def _search_block(self, r, c, bsize):
        from svt_av1_psy_tpu_torch.entropy.tile_writer import MAX_TX_SIZE_RECT
        from svt_av1_psy_tpu_torch.entropy.tx_trees import max_uv_tx_size
        yp, up, vp = self._src
        fr = self.fr
        fr.start_block(r, c)
        bw = BLOCK_SIZE_WIDE[bsize]
        bh = BLOCK_SIZE_HIGH[bsize]
        size = max(bw, bh)
        ts_y = int(MAX_TX_SIZE_RECT[bsize])
        ts_uv = max_uv_tx_size(bsize)
        x, y0 = c * 4, r * 4
        src_y = yp[y0:y0 + bh, x:x + bw].astype(np.int32)
        hc = has_chroma(r, c, bsize)

        # IBC competes with intra on full RD; snapshot now, trial at the
        # end (its source area never overlaps the current superblock)
        ibc_snap = None
        if getattr(self, "_ibc_index", None) is not None \
                and bw >= 8 and bh >= 8 and self.force_y_mode is None:
            ibc_snap = fr.snapshot_area(r, c, bh // 4, bw // 4)

        trial = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=0,
                            uv_mode=0, tx_size=ts_y)

        # stage 0: SAD over all modes (exact predictions)
        sads = []
        preds = {}
        for m in ALL_Y_MODES:
            trial.y_mode = m
            trial.angle_delta_y = 0
            p = fr.predict_txb(trial, 0, r, c, ts_y)
            preds[(m, 0)] = p
            sads.append((int(np.abs(src_y - p).sum()), m))
        sads.sort()
        cand = [m for _, m in sads[:self.top_k]]
        if self.force_y_mode is not None:
            cand = [self.force_y_mode]
            trial.y_mode = self.force_y_mode
            trial.angle_delta_y = self.force_ady
            preds[(self.force_y_mode, self.force_ady)] = \
                fr.predict_txb(trial, 0, r, c, ts_y)

        # angle-delta refinement for the best directional candidate
        best_dir = next((m for _, m in sads
                         if 1 <= m <= 8), None)
        deltas = {m: 0 for m in cand}
        if self.force_y_mode is not None:
            best_dir = None
            deltas = {self.force_y_mode: self.force_ady}
        if best_dir is not None and use_angle_delta(bsize):
            if best_dir not in cand:
                cand.append(best_dir)
            best_sad, best_d = None, 0
            for d in (-3, -2, -1, 0, 1, 2, 3):
                trial.y_mode = best_dir
                trial.angle_delta_y = d
                p = fr.predict_txb(trial, 0, r, c, ts_y)
                preds[(best_dir, d)] = p
                sad = int(np.abs(src_y - p).sum())
                if best_sad is None or sad < best_sad:
                    best_sad, best_d = sad, d
            deltas[best_dir] = best_d

        # stage 1: mode RD at block-level tx (full T/Q/recon distortion)
        best = None
        for m in cand:
            d = deltas.get(m, 0)
            p = preds[(m, d)]
            dist, qc, rtx = self.tw.rd_txb(0, bsize, src_y - p, ts_y,
                                           int(TxType.DCT_DCT), r, c,
                                           self.pq, y_mode=m, bd=self.bd)
            rate = rtx + self.tw.rate_y_mode(r, c, m)
            if 1 <= m <= 8 and use_angle_delta(bsize):
                rate += self.tw.rate_angle_delta(m, d)
            cost = dist + self.rdmult * rate
            if best is None or cost < best[0]:
                best = (cost, m, d)
        _, y_mode, ad_y = best

        # stage 2: tx depth + per-txb tx-type search with recon rollback
        blk = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=y_mode,
                          uv_mode=0, angle_delta_y=ad_y, tx_size=ts_y)
        best_trial = None
        depths = list(range(min(max_tx_depth(bsize), 2) + 1))
        for depth in depths:
            ts = ts_y
            for _ in range(depth):
                ts = int(SUB_TX[ts])
            snap = fr.snapshot(0, r, c, bh // 4, bw // 4)
            cost, txbs = self._trial_luma(blk, r, c, (bw, bh), ts, src_y)
            fr.restore(snap)
            cost += self.rdmult * self.tw.rate_tx_depth(r, c, bsize, ts)
            if best_trial is None or cost < best_trial[0]:
                best_trial = (cost, ts, txbs)
        # palette candidate (spec 5.11.42; ref palette.c search): competes
        # with the chosen intra mode on full luma RD + exact syntax rates
        pal_pick = None
        if getattr(self, "screen_content", False) and bsize >= 3 \
                and bw <= 64 and bh <= 64 and self.force_y_mode is None:
            pal_pick = self._palette_trial(r, c, bsize, (bw, bh), src_y,
                                           depths)
            if pal_pick is not None:
                hdr_n = self.tw.rate_y_mode(r, c, y_mode)
                if y_mode == 0:
                    hdr_n += self.tw.rate_palette_flag(r, c, bsize, False)
                if 1 <= y_mode <= 8 and use_angle_delta(bsize):
                    hdr_n += self.tw.rate_angle_delta(y_mode, ad_y)
                if pal_pick[0] >= best_trial[0] + self.rdmult * hdr_n:
                    pal_pick = None
        if pal_pick is not None:
            _, pal_colors, pal_map, ts_sel, txbs_y, pal_cost, pal_hdr = \
                pal_pick
            y_mode, ad_y = 0, 0
            blk = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=0,
                              uv_mode=0, tx_size=ts_sel,
                              palette=pal_colors, palette_map=pal_map)
            best_trial = (pal_cost, ts_sel, txbs_y)
        else:
            _, ts_sel, txbs_y = best_trial
            blk.tx_size = ts_sel
        for (u_row, u_col, tt, qc, pred) in txbs_y:
            fr.commit_txb(blk, 0, u_row, u_col, ts_sel, tt, qc, pred)

        qu = qv = None
        uv_mode, ad_uv, tt_uv = 0, 0, 0
        if hc:
            cr, cc_ = r >> 1, c >> 1
            cx, cy = cc_ * 4, cr * 4
            cw = max(bw >> 1, 4)
            ch = max(bh >> 1, 4)
            src_u = up[cy:cy + ch, cx:cx + cw].astype(np.int32)
            src_v = vp[cy:cy + ch, cx:cx + cw].astype(np.int32)
            ubest = None
            for m in dict.fromkeys((0, 1, 2, 9, 12, y_mode)):
                trial_uv = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize,
                                       y_mode=y_mode, uv_mode=m,
                                       angle_delta_uv=0, tx_size=ts_y)
                pu = fr.predict_txb(trial_uv, 1, cr, cc_, ts_uv)
                pv = fr.predict_txb(trial_uv, 2, cr, cc_, ts_uv)
                tt = uv_tx_type(m, ts_uv, False)
                qu_t, dqu_t = self._tq(src_u - pu, ts_uv, tt)
                qv_t, dqv_t = self._tq(src_v - pv, ts_uv, tt)
                ru = np.clip(pu + self._inv(dqu_t, ts_uv, tt), 0,
                             (1 << self.bd) - 1)
                rv = np.clip(pv + self._inv(dqv_t, ts_uv, tt), 0,
                             (1 << self.bd) - 1)
                dist = float(((src_u - ru) ** 2).sum() +
                             ((src_v - rv) ** 2).sum())
                rate = (self.tw.rate_uv_mode(bsize, y_mode, m) +
                        self.tw.rate_txb(1, bsize, qu_t, ts_uv, tt,
                                         cr, cc_) +
                        self.tw.rate_txb(2, bsize, qv_t, ts_uv, tt,
                                         cr, cc_))
                cost = dist + self.rdmult * rate
                if ubest is None or cost < ubest[0]:
                    ubest = (cost, m, pu, pv, qu_t, dqu_t, qv_t, dqv_t)
            # CfL candidate (uv_mode 13) with least-squares alpha + refine
            cfl_js = -1
            cfl_iu = cfl_iv = 0
            if cfl_allowed(bsize):
                from svt_av1_psy_tpu_torch.ops.intra import cfl_luma_ac, cfl_pred
                trial_dc = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize,
                                       y_mode=y_mode, uv_mode=0,
                                       tx_size=ts_y)
                dc_u = fr.predict_txb(trial_dc, 1, cr, cc_, ts_uv)
                dc_v = fr.predict_txb(trial_dc, 2, cr, cc_, ts_uv)
                luma = fr.planes[0]
                lx, ly = cc_ * 8, cr * 8
                xs = np.minimum(np.arange(lx, lx + cw * 2),
                                fr.max_luma_w - 1)
                ys = np.minimum(np.arange(ly, ly + ch * 2),
                                fr.max_luma_h - 1)
                ac = cfl_luma_ac(luma[np.ix_(ys, xs)], cw, ch)
                den = float((ac.astype(np.int64) ** 2).sum())
                tt13 = uv_tx_type(13, ts_uv, False)

                def plane_alpha(src, dc):
                    if den == 0:
                        return [0]
                    a = int(round(64.0 * float(
                        (ac * (src - dc)).sum()) / den))
                    a = max(-16, min(16, a))
                    cands = {0, a}
                    if a > -16:
                        cands.add(a - 1)
                    if a < 16:
                        cands.add(a + 1)
                    return sorted(cands)

                def eval_alpha(src, dc, a):
                    p = cfl_pred(dc, ac, a, self.bd) if a else dc
                    q, dq = self._tq(src - p, ts_uv, tt13)
                    rec2 = np.clip(p + self._inv(dq, ts_uv, tt13), 0,
                                   (1 << self.bd) - 1)
                    dist = float(((src - rec2) ** 2).sum())
                    plane_i = 1 if src is src_u else 2
                    rate = self.tw.rate_txb(plane_i, bsize, q, ts_uv, tt13,
                                            cr, cc_)
                    return dist + self.rdmult * rate, a, q, dq, p

                bu = min((eval_alpha(src_u, dc_u, a)
                          for a in plane_alpha(src_u, dc_u)),
                         key=lambda t: t[0])
                bv = min((eval_alpha(src_v, dc_v, a)
                          for a in plane_alpha(src_v, dc_v)),
                         key=lambda t: t[0])
                au, av = bu[1], bv[1]
                if au or av:
                    su = 0 if au == 0 else (2 if au > 0 else 1)
                    sv = 0 if av == 0 else (2 if av > 0 else 1)
                    js = su * 3 + sv - 1
                    iu = abs(au) - 1 if au else 0
                    iv = abs(av) - 1 if av else 0
                    rate_hdr = (self.tw.rate_uv_mode(bsize, y_mode, 13) +
                                self.tw.rate_cfl_alphas(js, iu, iv))
                    cost13 = bu[0] + bv[0] + self.rdmult * rate_hdr
                    if cost13 < ubest[0]:
                        ubest = (cost13, 13, bu[4], bv[4], bu[2], bu[3],
                                 bv[2], bv[3])
                        cfl_js, cfl_iu, cfl_iv = js, iu, iv

            _, uv_mode, pu, pv, qu, dqu, qv, dqv = ubest
            tt_uv = uv_tx_type(uv_mode, ts_uv, False)
            blk.uv_mode = uv_mode
            blk.angle_delta_uv = ad_uv
            if uv_mode == 13:
                blk.cfl_joint_sign = cfl_js
                blk.cfl_idx_u = cfl_iu
                blk.cfl_idx_v = cfl_iv
            fr.commit_txb(blk, 1, cr, cc_, ts_uv, tt_uv, qu, pu)
            fr.commit_txb(blk, 2, cr, cc_, ts_uv, tt_uv, qv, pv)

        any_y = any(np.any(q) for (_, _, _, q, _) in txbs_y)
        skip = not (any_y or (qu is not None and np.any(qu)) or
                    (qv is not None and np.any(qv)))
        rec = BlockRecord(
            mi_row=r, mi_col=c, bsize=bsize,
            y_mode=y_mode, uv_mode=uv_mode, angle_delta_y=ad_y,
            angle_delta_uv=ad_uv, skip=skip, tx_size=ts_sel,
            cfl_joint_sign=cfl_js if hc and uv_mode == 13 else -1,
            cfl_idx_u=cfl_iu if hc else 0, cfl_idx_v=cfl_iv if hc else 0,
            palette=None if pal_pick is None else pal_colors,
            palette_map=None if pal_pick is None else pal_map,
            txbs_y=[] if skip else [TxbData(q, ts_sel, tt)
                                    for (_, _, tt, q, _) in txbs_y],
            txbs_u=[] if (skip or not hc) else [TxbData(qu, ts_uv, tt_uv)],
            txbs_v=[] if (skip or not hc) else [TxbData(qv, ts_uv, tt_uv)])
        blk.skip = skip
        fr.finish_block(blk, hc)
        # header rates (skip + luma mode syntax); txb/uv/depth rates are
        # already inside best_trial / ubest costs
        hdr = self.tw.rate_skip(r, c, skip)
        if getattr(self.tw, "allow_intrabc", False):
            hdr += self.tw.rate_intrabc_flag(False)
        if pal_pick is not None:
            hdr += pal_hdr           # y_mode(DC) + palette colors + map
        else:
            hdr += self.tw.rate_y_mode(r, c, y_mode)
            if 1 <= y_mode <= 8 and size >= 8:
                hdr += self.tw.rate_angle_delta(y_mode, ad_y)
        total_cost = best_trial[0] + (ubest[0] if hc else 0.0) + \
            self.rdmult * hdr
        commits = [(0, u_row, u_col, ts_sel, tt, qc, pred)
                   for (u_row, u_col, tt, qc, pred) in txbs_y]
        if hc:
            commits.append((1, cr, cc_, ts_uv, tt_uv, qu, pu))
            commits.append((2, cr, cc_, ts_uv, tt_uv, qv, pv))

        # intra block copy trial (spec 5.11.31; ref hash_motion.c role):
        # full RD vs the committed intra/palette winner
        if ibc_snap is not None:
            ibc = self._intrabc_trial(r, c, bsize, (bw, bh), src_y, hc)
            if ibc is not None and ibc[0] < total_cost:
                self.fr.restore_area(ibc_snap)
                return self._commit_intrabc(r, c, bsize, ibc, hc)
        return total_cost, rec, (blk, hc, commits)

    def _luma_tx_types(self, ts):
        tx_set = intra_tx_set(ts, False)
        if tx_set == 0:
            return (int(TxType.DCT_DCT),)
        allowed = EXT_TX_INV[tx_set]
        cands = [int(TxType.DCT_DCT), int(TxType.ADST_ADST)]
        for t in (int(TxType.V_DCT), int(TxType.H_DCT)):
            if t in allowed:
                cands.append(t)
        return tuple(cands)

    def _trial_luma(self, blk, r, c, dims, ts, src_y):
        """Encode all luma txbs at tx size ts (writing recon), returning
        (total_cost, [(u_row, u_col, tx_type, qcoeff, pred), ...])."""
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE

        fr = self.fr
        bw, bh = dims
        tw_, th_ = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
        types = self.force_types or self._luma_tx_types(ts)
        total = 0.0
        out = []
        for oy in range(0, bh, th_):
            for ox in range(0, bw, tw_):
                u_row, u_col = r + oy // 4, c + ox // 4
                pred = fr.predict_txb(blk, 0, u_row, u_col, ts)
                if pred is None:
                    continue
                resid = src_y[oy:oy + th_, ox:ox + tw_] - pred
                tbest = None
                for tt in types:
                    d, qc, rate = self.tw.rd_txb(0, blk.bsize, resid, ts,
                                                 tt, u_row, u_col, self.pq,
                                                 y_mode=blk.y_mode,
                                                 bd=self.bd)
                    cost = d + self.rdmult * rate
                    if tbest is None or cost < tbest[0]:
                        tbest = (cost, tt, qc)
                cost, tt, qc = tbest
                total += cost
                fr.commit_txb(blk, 0, u_row, u_col, ts, tt, qc, pred)
                out.append((u_row, u_col, tt, qc, pred))
        return total, out

    @staticmethod
    def _detect_screen_content(yp: np.ndarray) -> bool:
        """Screen-content heuristic (the pic_analysis_process.c detector
        role): a frame is screen-like when a large share of 16x16 blocks
        uses very few distinct luma values. Vectorized (sort + count
        transitions per block) — runs on every key at --scm 2."""
        H, W = yp.shape
        nh, nw = (H - 16) // 32 + 1, (W - 16) // 32 + 1
        if nh <= 0 or nw <= 0:
            return False
        # gather the sampled 16x16 blocks on a 32-px grid as rows
        idx_y = (np.arange(nh) * 32)[:, None] + np.arange(16)[None, :]
        idx_x = (np.arange(nw) * 32)[:, None] + np.arange(16)[None, :]
        blocks = yp[idx_y.reshape(-1)][:, idx_x.reshape(-1)] \
            .reshape(nh, 16, nw, 16).transpose(0, 2, 1, 3) \
            .reshape(nh * nw, 256)
        s = np.sort(blocks, axis=1)
        ndistinct = 1 + (np.diff(s, axis=1) != 0).sum(axis=1)
        return float((ndistinct <= 8).mean()) >= 0.35

    # --- palette search (screen content; ref palette.c k-means) ----------
    @staticmethod
    def _palette_colors(src: np.ndarray):
        """Candidate palette color sets for a luma block: exact uniques
        when few, else 1-D weighted Lloyd at k in {2,4,8}."""
        vals = src.ravel()
        uniq, counts = np.unique(vals, return_counts=True)
        if len(uniq) < 2:
            return []
        if len(uniq) <= 8:
            return [tuple(int(x) for x in uniq)]
        if len(uniq) > 64:           # not screen-like; skip the trial
            return []
        u = uniq.astype(np.float64)
        w = counts.astype(np.float64)
        out = []
        for k in (8, 4, 2):
            # init at weighted quantiles
            cw = np.cumsum(w)
            qs = (np.arange(k) + 0.5) / k * cw[-1]
            cents = u[np.searchsorted(cw, qs).clip(0, len(u) - 1)]
            for _ in range(8):
                mids = (cents[:-1] + cents[1:]) / 2.0
                a = np.searchsorted(mids, u)
                news = cents.copy()
                for j in range(k):
                    m = a == j
                    if m.any():
                        news[j] = (u[m] * w[m]).sum() / w[m].sum()
                if np.allclose(news, cents):
                    break
                cents = np.sort(news)
            colors = tuple(sorted(set(int(round(x)) for x in cents)))
            if len(colors) >= 2 and colors not in out:
                out.append(colors)
        return out

    def _palette_trial(self, r, c, bsize, dims, src_y, depths):
        """Best luma palette candidate for this block: SSE+header
        pre-rank over color sets, then full tx RD on the winner.
        Returns (total_cost, colors, map, tx_size, txbs, luma_cost,
        header_bits) or None."""
        from svt_av1_psy_tpu_torch.entropy.tile_writer import MAX_TX_SIZE_RECT
        from svt_av1_psy_tpu_torch.entropy.tx_trees import SUB_TX
        cands = self._palette_colors(src_y)
        if not cands:
            return None
        fr, tw = self.fr, self.tw
        bw, bh = dims
        ranked = []
        for colors in cands:
            arr = np.asarray(colors, np.int32)
            idx = np.abs(src_y[..., None] - arr[None, None, :]) \
                .argmin(-1).astype(np.uint8)
            hdr = (tw.rate_palette_y(r, c, bsize, colors) +
                   tw.rate_palette_map(bsize, r, c, idx, len(colors)) +
                   tw.rate_y_mode(r, c, 0))
            sse = float(((src_y - arr[idx]) ** 2).sum())
            ranked.append((sse + self.rdmult * hdr, colors, idx, hdr))
        ranked.sort(key=lambda t: t[0])
        _, colors, idx, hdr = ranked[0]
        blk = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=0,
                          uv_mode=0, tx_size=int(MAX_TX_SIZE_RECT[bsize]),
                          palette=colors, palette_map=idx)
        best = None
        for depth in depths:
            ts = int(MAX_TX_SIZE_RECT[bsize])
            for _ in range(depth):
                ts = int(SUB_TX[ts])
            snap = fr.snapshot(0, r, c, bh // 4, bw // 4)
            cost, txbs = self._trial_luma(blk, r, c, dims, ts, src_y)
            fr.restore(snap)
            cost += self.rdmult * tw.rate_tx_depth(r, c, bsize, ts)
            total = cost + self.rdmult * hdr
            if best is None or total < best[0]:
                best = (total, colors, idx, ts, txbs, cost, hdr)
        return best

    # --- intra block copy search (spec 5.11.31; ref hash_motion.c) -------
    @staticmethod
    def _build_ibc_index(yp: np.ndarray):
        """Exact-match index of 8x8 source tiles on the 8-px grid: tile
        bytes -> earliest (y, x). The hash-ME analog of the reference's
        hash_motion.c, over the source (recon equals source closely at
        matched flat/text areas; candidates are re-verified by true RD
        on the recon)."""
        H, W = yp.shape
        idx = {}
        for y in range(0, H - 7, 8):
            for x in range(0, W - 7, 8):
                key = yp[y:y + 8, x:x + 8].tobytes()
                if key not in idx:
                    idx[key] = (y, x)
        return idx

    def _dv_valid(self, dv, r, c, bsize) -> bool:
        """av1_is_dv_valid analog (single tile, 64px superblocks): full
        pel, inside the frame, >= 4-SB64 raster delay + wavefront rule."""
        bw = BLOCK_SIZE_WIDE[bsize]
        bh = BLOCK_SIZE_HIGH[bsize]
        if (dv[0] & 7) or (dv[1] & 7):
            return False
        src_t = r * 4 * 8 + dv[0]
        src_l = c * 4 * 8 + dv[1]
        src_b = (r * 4 + bh) * 8 + dv[0]
        src_r = (c * 4 + bw) * 8 + dv[1]
        if src_t < 0 or src_l < 0:
            return False
        if src_b > self.mi_rows * 4 * 8 or src_r > self.mi_cols * 4 * 8:
            return False
        delay = 4                    # INTRABC_DELAY_PX 256 / 64
        active_sb_row = (r * 4) >> 6
        active_sb64_col = (c * 4) >> 6
        src_sb_row = ((src_b >> 3) - 1) >> 6
        src_sb64_col = ((src_r >> 3) - 1) >> 6
        total = ((self.mi_cols - 1) >> 4) + 1
        if src_sb_row * total + src_sb64_col >= \
                active_sb_row * total + active_sb64_col - delay:
            return False
        gradient = 1 + delay
        wf = gradient * (active_sb_row - src_sb_row)
        if src_sb_row > active_sb_row or \
                src_sb64_col >= active_sb64_col - delay + wf:
            return False
        return True

    def _intrabc_trial(self, r, c, bsize, dims, src_y, hc):
        """Full-RD IBC candidate: hash + structured DVs filtered by
        validity, ranked by source SSE, best one transformed/costed.
        Returns (total_cost, dv, txbs_y, uvdata, n_units) or None."""
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        from svt_av1_psy_tpu_torch.entropy.tile_writer import MAX_TX_SIZE_RECT
        from svt_av1_psy_tpu_torch.entropy.tx_trees import max_uv_tx_size
        fr, tw = self.fr, self.tw
        bw, bh = dims
        y0, x0 = r * 4, c * 4
        cands = []
        key = src_y[:8, :8].astype(self._src[0].dtype).tobytes()
        hit = self._ibc_index.get(key)
        if hit is not None and hit != (y0, x0):
            cands.append(((hit[0] - y0) * 8, (hit[1] - x0) * 8))
        for dpx in (64, 128):
            cands.append((0, -dpx * 8))
            cands.append((-dpx * 8, 0))
            cands.append((-dpx * 8, -dpx * 8))
        pred_dv = tw.dv_pred(r, c, bsize)
        cands.append(pred_dv)
        # even-full-pel only: chroma DV = dv/2 stays integer (plain copy)
        cands = [d for d in dict.fromkeys(cands)
                 if d[0] % 16 == 0 and d[1] % 16 == 0
                 and self._dv_valid(d, r, c, bsize)]
        if not cands:
            return None
        rec_y = fr.planes[0]
        scored = []
        for dv in cands:
            sy, sx = y0 + dv[0] // 8, x0 + dv[1] // 8
            p = rec_y[sy:sy + bh, sx:sx + bw].astype(np.int32)
            scored.append((float(((src_y - p) ** 2).sum()), dv))
        scored.sort(key=lambda t: t[0])
        _, dv = scored[0]

        ts = int(MAX_TX_SIZE_RECT[bsize])
        tw_, th_ = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
        sy, sx = y0 + dv[0] // 8, x0 + dv[1] // 8
        pred_y = rec_y[sy:sy + bh, sx:sx + bw].astype(np.int32)
        total = 0.0
        txbs = []
        dct = int(TxType.DCT_DCT)
        for oy in range(0, bh, th_):
            for ox in range(0, bw, tw_):
                u_row, u_col = r + oy // 4, c + ox // 4
                pred = pred_y[oy:oy + th_, ox:ox + tw_]
                resid = src_y[oy:oy + th_, ox:ox + tw_] - pred
                d, qc, rate = tw.rd_txb(0, bsize, resid, ts, dct,
                                        u_row, u_col, self.pq,
                                        is_inter=True, bd=self.bd)
                total += d + self.rdmult * rate
                txbs.append((u_row, u_col, qc, pred))
        uvdata = None
        if hc:
            from svt_av1_psy_tpu_torch.entropy.tx_trees import max_uv_tx_size
            ts_uv = max_uv_tx_size(bsize)
            cr, cc_ = r >> 1, c >> 1
            cy, cx = cr * 4, cc_ * 4
            ch = max(bh >> 1, 4)
            cw = max(bw >> 1, 4)
            suy, sux = cy + dv[0] // 16, cx + dv[1] // 16
            up, vp = self._src[1], self._src[2]
            src_u = up[cy:cy + ch, cx:cx + cw].astype(np.int32)
            src_v = vp[cy:cy + ch, cx:cx + cw].astype(np.int32)
            pu = fr.planes[1][suy:suy + ch, sux:sux + cw].astype(np.int32)
            pv = fr.planes[2][suy:suy + ch, sux:sux + cw].astype(np.int32)
            du, qu, ru = tw.rd_txb(1, bsize, src_u - pu, ts_uv, dct,
                                   cr, cc_, self.pq, is_inter=True,
                                   bd=self.bd)
            dvv, qv, rv = tw.rd_txb(2, bsize, src_v - pv, ts_uv, dct,
                                    cr, cc_, self.pq, is_inter=True,
                                    bd=self.bd)
            total += du + dvv + self.rdmult * (ru + rv)
            uvdata = (ts_uv, qu, pu, qv, pv, cr, cc_)
        n_units = len(txbs)
        skip = not (any(np.any(q) for (_, _, q, _) in txbs) or
                    (uvdata is not None and
                     (np.any(uvdata[1]) or np.any(uvdata[3]))))
        hdr = (tw.rate_skip(r, c, skip) + tw.rate_intrabc_flag(True) +
               tw.rate_dv(dv, pred_dv))
        if not skip:
            hdr += 1.0 * n_units     # all-zero var-tx split flags (approx)
        total += self.rdmult * hdr
        return (total, dv, ts, txbs, uvdata, skip)

    def _commit_intrabc(self, r, c, bsize, ibc, hc):
        """Commit the winning IBC candidate to recon + build records."""
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        total, dv, ts, txbs, uvdata, skip = ibc
        fr = self.fr
        dct = int(TxType.DCT_DCT)
        blk = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=0,
                          uv_mode=0, skip=skip, tx_size=ts,
                          is_inter=True, ref_frame=0, mv=dv,
                          inter_mode=3, interp_filters=(3, 3),
                          use_intrabc=True)
        commits = []
        for (u_row, u_col, qc, pred) in txbs:
            fr.commit_txb(blk, 0, u_row, u_col, ts, dct, qc, pred)
            commits.append((0, u_row, u_col, ts, dct, qc, pred))
        if uvdata is not None:
            ts_uv, qu, pu, qv, pv, cr, cc_ = uvdata
            fr.commit_txb(blk, 1, cr, cc_, ts_uv, dct, qu, pu)
            fr.commit_txb(blk, 2, cr, cc_, ts_uv, dct, qv, pv)
            commits.append((1, cr, cc_, ts_uv, dct, qu, pu))
            commits.append((2, cr, cc_, ts_uv, dct, qv, pv))
        fr.finish_block(blk, hc)
        leaves = [(u_row - r, u_col - c, ts) for (u_row, u_col, _, _)
                  in txbs]
        rec = BlockRecord(
            mi_row=r, mi_col=c, bsize=bsize, y_mode=0, uv_mode=0,
            skip=skip, tx_size=ts, use_intrabc=True, is_inter=True,
            ref_frame=0, mv=dv, inter_mode=3, interp_filters=(3, 3),
            tx_leaves=None if skip else leaves,
            txfm_splits=[0] * len(txbs),
            txbs_y=[] if skip else [TxbData(qc, ts, dct)
                                    for (_, _, qc, _) in txbs],
            txbs_u=[] if (skip or uvdata is None) else
            [TxbData(uvdata[1], uvdata[0], dct)],
            txbs_v=[] if (skip or uvdata is None) else
            [TxbData(uvdata[3], uvdata[0], dct)])
        return total, rec, (blk, hc, commits)

    def _inv(self, dqc, ts, tt):
        if self.backend == "native":
            from svt_av1_psy_tpu_torch import native
            return native.inv_txfm2d(dqc, ts, tt, self.bd)
        from svt_av1_psy_tpu_torch.ops.transforms import inverse_transform_2d
        return inverse_transform_2d(dqc, ts, tt, self.bd)

    # --- P-frame coding (single LAST ref, translational MC) ---------------
    def _encode_p_frame(self, y, u, v) -> EncodedFrame:
        from svt_av1_psy_tpu_torch.inter.mvref import MiGrid
        bd = self.bd
        yp = _pad_to(np.asarray(y), self.pah, self.paw)
        up = _pad_to(np.asarray(u), self.pah // 2, self.paw // 2)
        vp = _pad_to(np.asarray(v), self.pah // 2, self.paw // 2)
        self._src = (yp, up, vp)
        self.records = []
        q = self.p_qindex if self.p_qindex is not None else self.qindex
        vb = None
        dq_res_log2 = 0
        if self.enable_variance_boost:
            from svt_av1_psy_tpu_torch.models.variance_boost import (
                adjust_sb_qindex, sb_8x8_variances)
            q, dq_res_log2, vb = adjust_sb_qindex(
                q, sb_8x8_variances(yp), self.vb_strength,
                self.vb_octile, bd)

        fr_params = FrameParams(
            frame_type=1, base_q_idx=q, order_hint=self.frame_index & 0x7F,
            tx_mode_select=False, primary_ref_frame=7,
            refresh_frame_flags=0x01, ref_frame_idx=(0,) * 7,
            allow_high_precision_mv=False, interp_filter=0,
            delta_q_present=vb is not None,
            delta_q_res_log2=dq_res_log2)
        self.fr = FrameReconstructor(
            self.width, self.height, fr_params, bd=bd,
            enable_intra_edge_filter=self.seq.enable_intra_edge_filter)
        self.fr.ref_planes = [self.dpb] * 8
        self.fr.ref_frame_idx = (0,) * 7
        self.fr.interp_filter = 0
        fc = FrameContext(q)
        self.tw = TileWriter(fc, self.mi_rows, self.mi_cols, sb_size=SB,
                             backend=self.backend, tx_mode_select=False,
                             cdef_bits=0, frame_is_intra=False)
        self.search_grid = MiGrid(self.mi_rows, self.mi_cols)
        self._sb_ops = []
        pq_save = self.pq
        rd_save = self.rdmult
        self.pq = build_plane_quant(q, bd=bd)
        qstep = dc_q(q, bd) / 8.0
        self.rdmult = 0.12 * qstep * qstep
        prev_q = q
        for sby in range(0, self.ah, SB):
            for sbx in range(0, self.aw, SB):
                sbq = None
                if vb is not None:
                    sbq = int(vb[sby // SB, sbx // SB])
                    self._set_block_q(sbq)
                    self.fr.q_override = sbq
                self.fr.start_block(sby // 4, sbx // 4)
                _, ops = self._search_partition_p(sby // 4, sbx // 4, 64)
                dq = None
                if vb is not None:
                    first = next(op[1] for op in ops if op[0] == "B")
                    sb_skip = (first.bsize == int(BlockSize.BLOCK_64X64)
                               and first.skip)
                    if not sb_skip:
                        delta = (sbq - prev_q) >> dq_res_log2
                        dq = (abs(delta), 1 if delta < 0 else 0)
                        prev_q = sbq
                self._sb_ops.append((sby // 4, sbx // 4, ops, dq))
                self._write_ops(ops, dq=dq)
        if vb is not None:
            self.fr.q_override = None
            self.pq = build_plane_quant(q, bd=bd)
            qstep = dc_q(q, bd) / 8.0
            self.rdmult = 0.12 * qstep * qstep
        tile = self.tw.finish()
        lf = self._pick_dlf_levels(yp, up, vp)
        fr_params.filter_level = (lf[0], lf[1])
        fr_params.filter_level_uv = (lf[2], lf[3])
        if any(lf):
            self.fr.apply_dlf(lf, sharpness=0)
        deblock_copy = [pl.copy() for pl in self.fr.planes]
        cdef_grid = self._cdef_stage(fr_params, yp, up, vp, q)
        tile = self._apply_and_sign_lr(fr_params, tile, deblock_copy,
                                       yp, up, vp, q, cdef_grid=cdef_grid)
        payload = key_frame_temporal_unit(self.seq, fr_params, tile,
                                          with_seq_header=False)
        self.pq = pq_save
        self.rdmult = rd_save
        self.frame_index += 1
        H, W = self.height, self.width
        out = EncodedFrame(
            payload=payload,
            recon_y=self.fr.planes[0][:H, :W].copy(),
            recon_u=self.fr.planes[1][:(H + 1) // 2, :(W + 1) // 2].copy(),
            recon_v=self.fr.planes[2][:(H + 1) // 2, :(W + 1) // 2].copy())
        self.dpb = (out.recon_y, out.recon_u, out.recon_v)
        return out

    def _search_partition_p(self, r, c, size):
        """Partition RD for P frames: NONE vs HORZ vs VERT vs SPLIT."""
        from svt_av1_psy_tpu_torch.decoder.tile_parser import _subsize
        if r >= self.mi_rows or c >= self.mi_cols:
            return 0.0, []
        tw = self.tw
        bsize = _SQ_BSIZE[size]
        has_rows, has_cols = tw._partition_bounds(r, c, bsize)
        if not (has_rows and has_cols) and size > 8:
            cost, ops = self._split_children_p(r, c, size)
            return cost, [("P", r, c, bsize, int(Partition.SPLIT))] + ops
        can_split = size > max(self.min_block, 8)
        half4 = size // 8
        w4 = size // 4
        cands = [(int(Partition.NONE), bsize, [(r, c, bsize)])]
        if can_split and self.enable_rect:
            hb = _subsize(bsize, int(Partition.HORZ))
            vb = _subsize(bsize, int(Partition.VERT))
            cands.append((int(Partition.HORZ), hb,
                          [(r, c, hb), (r + half4, c, hb)]))
            cands.append((int(Partition.VERT), vb,
                          [(r, c, vb), (r, c + half4, vb)]))
        multi = can_split or len(cands) > 1
        pre = self.fr.snapshot_area(r, c, w4, w4) if multi else None
        gpre = self.search_grid.snapshot(r, c, w4, w4) if multi else None
        best = None
        for part, sub, blocks in cands:
            cost = self.rdmult * tw.rate_partition(r, c, bsize, part)
            items = []
            for (br, bc, bb) in blocks:
                cb, rec, replay = self._search_block_p(br, bc, bb)
                cost += cb
                items.append((rec, replay))
            if best is None or cost < best[0]:
                best = (cost, part, sub, items)
            if multi:
                self.fr.restore_area(pre)
                self.search_grid.restore(gpre)
        if can_split:
            cost_c, ops_c = self._split_children_p(r, c, size)
            cost_s = cost_c + self.rdmult * tw.rate_partition(
                r, c, bsize, int(Partition.SPLIT))
            if cost_s <= best[0]:
                return cost_s, [("P", r, c, bsize,
                                 int(Partition.SPLIT))] + ops_c
            self.fr.restore_area(pre)
            self.search_grid.restore(gpre)
        if multi:
            for (rec, replay) in best[3]:
                self._replay_block(replay)
                bw4 = BLOCK_SIZE_WIDE[rec.bsize] // 4
                bh4 = BLOCK_SIZE_HIGH[rec.bsize] // 4
                self.search_grid.set_block(
                    rec.mi_row, rec.mi_col, bh4, bw4, rec.bsize,
                    rec.ref_frame if rec.is_inter else 0, -1, rec.mv,
                    (0, 0), rec.inter_mode == 3)
        ops = [("P", r, c, bsize, best[1])]
        ops += [("B", rec) for (rec, _) in best[3]]
        ops.append(("PC", r, c, bsize, best[2]))
        return best[0], ops

    def _split_children_p(self, r, c, size):
        half4 = size // 8
        cost = 0.0
        ops = []
        for (rr, cc2) in ((r, c), (r, c + half4),
                          (r + half4, c), (r + half4, c + half4)):
            cst, o = self._search_partition_p(rr, cc2, size // 2)
            cost += cst
            ops += o
        return cost, ops

    def _me_fullpel(self, src, ref, py, px, h, w, start_mv):
        """Diamond full-pel search on luma SAD around start_mv (1/8 units).
        Returns best full-pel mv in 1/8 units."""
        def sad_at(my, mx):
            ys = np.clip(np.arange(py + my, py + my + h), 0,
                         ref.shape[0] - 1)
            xs = np.clip(np.arange(px + mx, px + mx + w), 0,
                         ref.shape[1] - 1)
            return int(np.abs(src - ref[np.ix_(ys, xs)].astype(
                np.int32)).sum())

        best = (start_mv[0] >> 3, start_mv[1] >> 3)
        cands = {best, (0, 0)}
        best_mv = min(cands, key=lambda m: sad_at(*m))
        best_sad = sad_at(*best_mv)
        step = 8
        while step >= 1:
            improved = True
            while improved:
                improved = False
                for (dy, dx) in ((-step, 0), (step, 0), (0, -step),
                                 (0, step)):
                    m = (best_mv[0] + dy, best_mv[1] + dx)
                    if abs(m[0]) > 128 or abs(m[1]) > 128:
                        continue
                    sd = sad_at(*m)
                    if sd < best_sad:
                        best_sad = sd
                        best_mv = m
                        improved = True
            step >>= 1
        return (best_mv[0] * 8, best_mv[1] * 8)

    def _subpel_refine(self, blk, hc, src_y, fullpel_mv):
        """+-1 step refinement at half then quarter pel via real MC."""
        from svt_av1_psy_tpu_torch.ops.mc import mc_block
        ref = self.fr.ref_planes[0][0]
        py, px = blk.mi_row * 4, blk.mi_col * 4
        h, w = src_y.shape

        def cost(mv):
            p = mc_block(np.asarray(ref), px, py, w, h, mv[1] * 2, mv[0] * 2,
                         0, 0, bd=self.bd)
            return int(np.abs(src_y - p).sum())

        best = fullpel_mv
        best_c = cost(best)
        for step in (4, 2):
            improved = True
            while improved:
                improved = False
                for (dy, dx) in ((-step, 0), (step, 0), (0, -step),
                                 (0, step)):
                    m = (best[0] + dy, best[1] + dx)
                    cc2 = cost(m)
                    if cc2 < best_c:
                        best_c = cc2
                        best = m
                        improved = True
        return best

    def _search_block_p(self, r, c, bsize):
        """Inter mode RD for one block: NEARESTMV / GLOBALMV / NEWMV."""
        from svt_av1_psy_tpu_torch.inter.mvref import (lower_mv_precision,
                                                 setup_ref_mv_list)
        from svt_av1_psy_tpu_torch.entropy.tile_writer import MAX_TX_SIZE_RECT
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        yp, up, vp = self._src
        fr = self.fr
        fr.start_block(r, c)
        bw = BLOCK_SIZE_WIDE[bsize]
        bh = BLOCK_SIZE_HIGH[bsize]
        x, y0 = c * 4, r * 4
        src_y = yp[y0:y0 + bh, x:x + bw].astype(np.int32)
        hc = has_chroma(r, c, bsize)
        ts_y = int(MAX_TX_SIZE_RECT[bsize])
        refs = setup_ref_mv_list(self.search_grid, r, c, bsize, 1,
                                 sb_mi=self.sb_mi if hasattr(self, 'sb_mi')
                                 else 16)
        nearest = lower_mv_precision(refs.stack[0], False, False)

        blk = ParsedBlock(mi_row=r, mi_col=c, bsize=bsize, y_mode=0,
                          uv_mode=0, tx_size=ts_y, is_inter=True,
                          ref_frame=1, inter_mode=0, mv=nearest)

        # candidates: NEARESTMV(stack0), NEARMV(stack1+), GLOBALMV, NEWMV
        cands = [(0, nearest, 0)]
        seen = {nearest}
        for idx in range(1, min(refs.count, 3)):
            near = lower_mv_precision(refs.stack[idx], False, False)
            if near not in seen:
                cands.append((1, near, idx - 1))
                seen.add(near)
        if (0, 0) not in seen:
            cands.append((2, (0, 0), 0))
        me = self._me_fullpel(src_y, np.asarray(fr.ref_planes[0][0]),
                              y0, x, bh, bw, nearest)
        blk.mv = me
        newmv = self._subpel_refine(blk, hc, src_y, me)
        if newmv not in seen:
            cands.append((3, newmv, 0))

        best = None
        for (mode, mv, drl) in cands:
            blk.inter_mode = mode
            blk.mv = mv
            snap = fr.snapshot_area(r, c, bw // 4, bh // 4)
            cost, rec_parts = self._trial_inter(blk, hc, src_y, up, vp,
                                                mode, mv, refs)
            if best is None or cost < best[0]:
                best = (cost, mode, mv, drl, rec_parts)
            fr.restore_area(snap)
        _, mode, mv, drl_idx, (txbs, skip, any_nz) = best

        # commit winner
        blk.inter_mode = mode
        blk.mv = mv
        fr._predict_inter_block(blk, hc)
        for (pl, u_row, u_col, ts, tt, qc) in txbs:
            if qc is not None and np.any(qc):
                xx, yy = u_col * 4, u_row * 4
                w_, h_ = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
                pred = fr.planes[pl][yy:yy + h_, xx:xx + w_].astype(np.int32)
                fr.commit_txb(blk, pl, u_row, u_col, ts, tt, qc, pred)
        blk.skip = skip
        fr.finish_block(blk, hc)
        self.search_grid.set_block(r, c, bh // 4, bw // 4, bsize, 1, -1,
                                   mv, (0, 0), mode == 3)

        rec = BlockRecord(
            mi_row=r, mi_col=c, bsize=bsize, y_mode=0, uv_mode=0,
            skip=skip, tx_size=ts_y, is_inter=True, ref_frame=1,
            mv=mv, inter_mode=mode,
            ref_mv_idx=(1 + drl_idx) if mode == 1 else 0,
            txbs_y=[] if skip else [TxbData(q, ts, tt)
                                    for (pl, _, _, ts, tt, q) in txbs
                                    if pl == 0],
            txbs_u=[] if skip else [TxbData(q, ts, tt)
                                    for (pl, _, _, ts, tt, q) in txbs
                                    if pl == 1],
            txbs_v=[] if skip else [TxbData(q, ts, tt)
                                    for (pl, _, _, ts, tt, q) in txbs
                                    if pl == 2])
        replay = (blk, hc, [])   # replay via re-commit (see _replay_p)
        return best[0], rec, (blk, hc, txbs, skip)

    def _replay_block(self, replay):
        """Re-commit a searched block after region rollback (intra replay
        tuples carry explicit commits; P-frame tuples re-run MC)."""
        if len(replay) == 4:
            blk, hc, txbs, skip = replay
            from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
            fr = self.fr
            fr.start_block(blk.mi_row, blk.mi_col)
            fr._predict_inter_block(blk, hc)
            for (pl, u_row, u_col, ts, tt, qc) in txbs:
                if qc is not None and np.any(qc):
                    xx, yy = u_col * 4, u_row * 4
                    w_, h_ = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
                    pred = fr.planes[pl][yy:yy + h_, xx:xx + w_].astype(
                        np.int32)
                    fr.commit_txb(blk, pl, u_row, u_col, ts, tt, qc, pred)
            fr.finish_block(blk, hc)
            return
        blk, hc, commits = replay
        fr = self.fr
        fr.start_block(blk.mi_row, blk.mi_col)
        for (plane, u_row, u_col, ts, tt, qc, pred) in commits:
            fr.commit_txb(blk, plane, u_row, u_col, ts, tt, qc, pred)
        fr.finish_block(blk, hc)

    def _trial_inter(self, blk, hc, src_y, up, vp, mode, mv, refs):
        """T/Q all planes for one inter candidate; returns
        (rd_cost, (txbs, skip, any_nz))."""
        from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE
        from svt_av1_psy_tpu_torch.entropy.tx_trees import max_uv_tx_size
        fr = self.fr
        r, c = blk.mi_row, blk.mi_col
        bsize = blk.bsize
        bw = BLOCK_SIZE_WIDE[bsize]
        bh = BLOCK_SIZE_HIGH[bsize]
        fr._predict_inter_block(blk, hc)
        txbs = []
        dist = 0.0
        rate = 4.0 + (8.0 if mode == 3 else 0.0)   # crude mode+mv bits
        ts_y = blk.tx_size
        tw_, th_ = TX_SIZE_WIDE[ts_y], TX_SIZE_HIGH[ts_y]
        for oy in range(0, bh, th_):
            for ox in range(0, bw, tw_):
                u_row, u_col = r + oy // 4, c + ox // 4
                yy, xx = u_row * 4, u_col * 4
                pred = fr.planes[0][yy:yy + th_, xx:xx + tw_].astype(
                    np.int32)
                resid = src_y[oy:oy + th_, ox:ox + tw_] - pred
                qc, dqc = self._tq(resid, ts_y, 0)
                rec = np.clip(pred + self._inv(dqc, ts_y, 0), 0,
                              (1 << self.bd) - 1)
                dist += float(((src_y[oy:oy + th_, ox:ox + tw_] - rec) ** 2
                               ).sum())
                rate += self.tw.rate_txb(0, bsize, qc, ts_y, 0,
                                         u_row, u_col, is_inter=True)
                txbs.append((0, u_row, u_col, ts_y, 0, qc))
        if hc:
            cr, cc2 = r >> 1, c >> 1
            ts_uv = max_uv_tx_size(bsize)
            cw4 = TX_SIZE_WIDE[ts_uv] // 4
            for pl, srcp in ((1, up), (2, vp)):
                cy, cx = cr * 4, cc2 * 4
                h_, w_ = TX_SIZE_HIGH[ts_uv], TX_SIZE_WIDE[ts_uv]
                src_c = srcp[cy:cy + h_, cx:cx + w_].astype(np.int32)
                pred = fr.planes[pl][cy:cy + h_, cx:cx + w_].astype(
                    np.int32)
                qc, dqc = self._tq(src_c - pred, ts_uv, 0)
                rec = np.clip(pred + self._inv(dqc, ts_uv, 0), 0,
                              (1 << self.bd) - 1)
                dist += float(((src_c - rec) ** 2).sum())
                rate += self.tw.rate_txb(pl, bsize, qc, ts_uv, 0, cr, cc2,
                                         is_inter=True)
                txbs.append((pl, cr, cc2, ts_uv, 0, qc))
        any_nz = any(np.any(q) for (_, _, _, _, _, q) in txbs)
        skip = not any_nz
        return dist + self.rdmult * rate, (txbs, skip, any_nz)

    # --- loop restoration search + final tile rewrite ----------------------
    def _apply_and_sign_lr(self, fr_params, tile, deblock_copy,
                           yp, up, vp, q, cdef_grid=None):
        """SGR-only restoration search per 64-px unit; if any unit helps
        (or per-unit CDEF indices must be interleaved), re-encode the
        tile and apply LR to the recon (ref search: pick_sgrproj in
        enc_restoration)."""
        if not self.seq.enable_restoration:
            if cdef_grid is not None:
                return self._rewrite_tile(q, fr_params, cdef_grid=cdef_grid)
            return tile
        from svt_av1_psy_tpu_torch.ops.restoration import (SGR_PARAMS, apply_sgr,
                                                     apply_lr_frame,
                                                     _unit_ext, sgr_filters)
        H, W = self.height, self.width
        dims = [(W, H), ((W + 1) >> 1, (H + 1) >> 1),
                ((W + 1) >> 1, (H + 1) >> 1)]
        srcs = [yp, up, vp]
        usize = [64, 64, 64]
        units = [{}, {}, {}]
        any_used = False
        for plane in range(3):
            sub = 1 if plane else 0
            pw, ph = dims[plane]
            us = usize[plane]
            ucols = max((pw + (us >> 1)) // us, 1)
            urows = max((ph + (us >> 1)) // us, 1)
            stripe_h = 64 >> sub
            stripe_off = 8 >> sub
            src = srcs[plane]
            cd = self.fr.planes[plane]
            db = deblock_copy[plane]
            for ur in range(urows):
                for uc in range(ucols):
                    ux0 = uc * us
                    uy0 = ur * us
                    ux1 = pw if uc == ucols - 1 else min(ux0 + us, pw)
                    uy1 = ph if ur == urows - 1 else min(uy0 + us, ph)
                    w = ux1 - ux0
                    base = src[uy0:uy1, ux0:ux1].astype(np.int64)
                    cur = cd[uy0:uy1, ux0:ux1].astype(np.int64)
                    sse_none = float(((base - cur) ** 2).sum())
                    best = (sse_none + self.rdmult * 2.0, {"type": 0})
                    # stripe segments of this unit
                    segs = []
                    y = uy0
                    while y < uy1:
                        s_idx = (y + stripe_off) // stripe_h
                        s_top = max(s_idx * stripe_h - stripe_off, 0)
                        s_bot = s_top + stripe_h
                        seg_top = max(y, s_top)
                        seg_bot = min(uy1, s_bot)
                        segs.append((seg_top, seg_bot,
                                     (s_top, min(s_bot, ph))))
                        y = seg_bot
                    exts = [
                        _unit_ext(cd, db, ux0, st, w, sb - st, pw, ph, sbase)
                        for (st, sb, sbase) in segs]
                    for ep in range(16):
                        r0, _, r1, _ = SGR_PARAMS[ep]
                        a0 = []
                        a1 = []
                        tgt = []
                        for ext, (st, sb, _) in zip(exts, segs):
                            h = sb - st
                            f0, f1 = sgr_filters(ext, w, h, ep, self.bd)
                            u = ext[3:3 + h, 3:3 + w].astype(np.int64) << 4
                            sseg = src[st:sb, ux0:ux1].astype(np.int64)
                            t = (sseg << 11) - (u << 7)
                            if r0:
                                a0.append((f0 - u).ravel())
                            if r1:
                                a1.append((f1 - u).ravel())
                            tgt.append(t.ravel())
                        cols = []
                        if r0:
                            cols.append(np.concatenate(a0))
                        if r1:
                            cols.append(np.concatenate(a1))
                        A = np.stack(cols, 1).astype(np.float64)
                        b = np.concatenate(tgt).astype(np.float64)
                        sol, _, _, _ = np.linalg.lstsq(A, b, rcond=None)
                        xq = [0, 0]
                        i = 0
                        if r0:
                            xq[0] = int(round(sol[i]))
                            i += 1
                        if r1:
                            xq[1] = int(round(sol[i]))
                        # map to legal xqd
                        if r0 == 0:
                            x0 = 0
                            x1 = max(-32, min(95, 128 - xq[1]))
                        elif r1 == 0:
                            x0 = max(-96, min(31, xq[0]))
                            x1 = max(-32, min(95, 128 - x0))
                        else:
                            x0 = max(-96, min(31, xq[0]))
                            x1 = max(-32, min(95, 128 - x0 - xq[1]))
                        # exact SSE with the quantized params
                        sse = 0.0
                        for ext, (st, sb, _) in zip(exts, segs):
                            out = apply_sgr(ext, w, sb - st, ep, (x0, x1),
                                            self.bd)
                            d = src[st:sb, ux0:ux1].astype(np.int64) - out
                            sse += float((d * d).sum())
                        cost = sse + self.rdmult * 30.0
                        if cost < best[0]:
                            best = (cost, {"type": 2, "ep": ep,
                                           "xqd": (x0, x1)})
                    units[plane][(ur, uc)] = best[1]
                    if best[1]["type"]:
                        any_used = True
        if not any_used:
            if cdef_grid is not None:
                return self._rewrite_tile(q, fr_params, cdef_grid=cdef_grid)
            return tile
        lr_type = [2 if any(v["type"] for v in units[pl].values()) else 0
                   for pl in range(3)]
        for pl in range(3):
            if not lr_type[pl]:
                units[pl] = {}
        # header fields: coded lr type (NONE=0, SGR=3) + unit shift 0 (64px)
        fr_params.lr_type = tuple(3 if t else 0 for t in lr_type)
        fr_params.lr_unit_shift = 0
        fr_params.lr_uv_shift = 0
        new_tile = self._rewrite_tile(q, fr_params, cdef_grid=cdef_grid,
                                      lr=(lr_type, usize, units, W, H))
        # apply to recon
        apply_lr_frame(self.fr.planes, deblock_copy, dims, lr_type,
                       usize, units, bd=self.bd)
        return new_tile

    def _rewrite_tile(self, q, fr_params, cdef_grid=None, lr=None):
        """Replay the recorded SB ops into a fresh tile with the final
        filter syntax (per-unit cdef_idx literals and/or LR units)."""
        fc2 = FrameContext(q)
        seg_info = getattr(self, "_seg_info", None)
        tw2 = TileWriter(fc2, self.mi_rows, self.mi_cols, sb_size=SB,
                         backend=self.backend,
                         tx_mode_select=self.tw.tx_mode_select,
                         cdef_bits=(fr_params.cdef_bits
                                    if cdef_grid is not None else 0),
                         frame_is_intra=self.tw.frame_is_intra,
                         allow_screen_content=self.tw.allow_screen_content,
                         bd=self.bd,
                         seg=(None if seg_info is None else
                              dict(last_active=seg_info["last_active"],
                                   map=seg_info["map"])))
        if cdef_grid is not None:
            tw2.cdef_grid = cdef_grid
        if lr is not None:
            tw2.init_lr(*lr)
        # mirror the first-pass writer's inter configuration
        for attr in ("allow_hp", "force_integer_mv", "reference_select",
                     "switchable_filter", "dual_filter", "enable_interintra",
                     "motion_mode_switchable", "allow_warped_motion",
                     "skip_mode_present", "gm_mv"):
            if hasattr(self.tw, attr):
                setattr(tw2, attr, getattr(self.tw, attr))
        save_tw = self.tw
        self.tw = tw2
        save_records = self.records
        self.records = []
        for (sbr, sbc, ops, dq) in self._sb_ops:
            if lr is not None:
                tw2.write_lr(sbr, sbc)
            self._write_ops(ops, dq=dq)
        self.tw = save_tw
        self.records = save_records
        return tw2.finish()
