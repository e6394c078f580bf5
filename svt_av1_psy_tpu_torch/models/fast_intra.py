"""The fast encoder with its device search in PyTorch.

FastIntraEncoder here subclasses svt_av1_psy_tpu.models.fast_intra.
FastIntraEncoder and overrides only the methods that call JAX: the
intra decision stage (_decide_dispatch, _decide_finish, prefetch_decide),
the inter frame (_encode_p, low delay and random access), the
screen-content key frame (_encode_key_sc) and the loop-restoration
search (_lr_apply_and_search). Everything else — the native C commit
walks, entropy coding, in-loop filters, DPB and CDF state — is the JAX
package's host code, unchanged.

_encode_p is a copy of the reference method. Only the low-delay branch of
its device-search block (from its ``else:`` to the global-motion comment)
and its first lines (no jax import) differ; tests/test_torch_encode.py
guards every other line against drift. _encode_key_sc and
_lr_apply_and_search are copies that build the port's IntraEncoder and
DeviceLrSearch on ``self.device``; tests/test_torch_intra_encoder.py and
tests/test_torch_lr.py guard every other statement.

Device work runs on ``self.device``. On CUDA the programs are launched
asynchronously in stream order; each packed result comes home through a
HostCopy (a non_blocking copy into pinned memory plus a CUDA event), which
the host waits for only where it reads the result.
"""

from __future__ import annotations

import os

import numpy as np

from svt_av1_psy_tpu.bitstream.headers import (FrameParams,
                                               key_frame_temporal_unit)
from svt_av1_psy_tpu.models import fast_intra
from svt_av1_psy_tpu.models.intra_encoder import EncodedFrame, _pad_to
from svt_av1_psy_tpu.ops.quant import ac_q
from svt_av1_psy_tpu_torch.kernels.hme import hme_search_kernel
from svt_av1_psy_tpu_torch.models.intra_encoder import IntraEncoder
from svt_av1_psy_tpu_torch.models.lr_search import DeviceLrSearch
from svt_av1_psy_tpu_torch.ops.torch_backend import (hme2_unpack,
                                                     hme_search2,
                                                     intra_decide_packed,
                                                     intra_decide_unpack,
                                                     pack_mv_sad,
                                                     plane_tensor)
from svt_av1_psy_tpu_torch.utils.device import HostCopy, resolve_device


def _hme_packed(src, ref):
    """Full-pel ME of the P-frame path as ONE packed int32 tensor
    (mv16 | sad16; hme2_unpack decodes it).

    The route follows the environment at each call, as
    svt_av1_psy_tpu.models.fast_intra._jitted_hme reads it:
    SVT_HME_PALLAS=1 or SVT_HME_1LEVEL=1 select the single-level search
    (the K1 kernel on CUDA; its plain version on the CPU); by default the
    two-level hme_search2 runs."""
    if os.environ.get("SVT_HME_PALLAS") == "1" or \
            os.environ.get("SVT_HME_1LEVEL") == "1":
        return pack_mv_sad(*hme_search_kernel(src, ref))
    return pack_mv_sad(*hme_search2(src, ref))


class FastIntraEncoder(fast_intra.FastIntraEncoder):
    """Device-search + C-commit encoder with the device search in
    PyTorch on ``device`` ("cpu" or "cuda[:N]")."""

    def __init__(self, *args, device, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)

    # --- unported device users ------------------------------------------
    def make_sharded_decide(self, mesh, axis: str = "sp"):
        raise NotImplementedError(
            "sharded decide (make_sharded_decide): ROADMAP queue 1 item 10")

    # --- screen-content key frames ----------------------------------------
    def _encode_key_sc(self, y, u, v, order_hint=None) -> EncodedFrame:
        """Screen-content KEY frame through the full-RD intra path
        (palette + intra-block-copy searches, models/intra_encoder.py;
        ref palette.c:553 k-means + hash_motion.c:351 IBC hash search).
        The fast path owns the stream: the slow encoder shares this
        stream's SequenceParams, and its recon + end-of-frame CDF
        context bridge into the fast DPB so the inter walk references
        the SC key exactly like a fast-coded one."""
        from svt_av1_psy_tpu.utils.trace import stage as _tstage

        d = self.frame_index if order_hint is None else order_hint
        # frame-kind q: same kf ladder as the fast key path
        kq = getattr(self, "kf_qindex", None)
        if self.gop_size == 1:
            base_q = self.qindex
        elif kq is not None:
            base_q = int(kq)
        else:
            base_q = max(0, int(self.qindex *
                                getattr(self, "kf_qfrac", 0.75)))
        self._last_coded_q = base_q
        self._last_is_key = True

        # seq flags must be armed before frame 0 writes the seq header
        # (same block as the fast key path)
        self.seq.enable_masked_compound = bool(
            getattr(self, "masked_compound_search", False))
        self.seq.enable_interintra_compound = bool(
            getattr(self, "interintra_search", False))
        self.seq.enable_filter_intra = bool(
            getattr(self, "fi_search", False))
        if self.frame_index == 0:
            self.seq.enable_restoration = bool(self.enable_lr)

        sc = IntraEncoder(self.width, self.height, qindex=base_q,
                          bd=self.bd, search_top_k=2, device=self.device)
        sc.seq = self.seq                    # one stream, one seq header
        sc.screen_content = True
        sc.enable_intrabc = True
        sc.frame_index = d                   # order_hint + seq-header gate
        with _tstage("sc_key_walk"):
            f = sc.encode_frame(y, u, v)

        # bridge recon into the fast ping-pong planes (edge-replicated
        # into the padded area like every walked frame leaves them)
        H, W = self.height, self.width
        cH, cW = (H + 1) // 2, (W + 1) // 2
        self._join_pending_filter(self._rec_y)
        self._rec_y[:H, :W] = f.recon_y
        self._rec_y[:H, W:self.paw] = self._rec_y[:H, W - 1:W]
        self._rec_y[H:self.pah, :self.paw] = \
            self._rec_y[H - 1:H, :self.paw]
        for buf, plane, (h2, w2, pw2) in (
                (self._rec_u, f.recon_u, (cH, cW, self.paw // 2)),
                (self._rec_v, f.recon_v, (cH, cW, self.paw // 2))):
            buf[:h2, :w2] = plane
            buf[:h2, w2:pw2] = buf[:h2, w2 - 1:w2]
            buf[h2:self.pah // 2, :pw2] = buf[h2 - 1:h2, :pw2]

        # end-of-frame CDF context + DPB refresh (a shown KEY refreshes
        # every slot), identical to the fast key tail
        fc = sc.tw.fc
        self._fc_saved = fc
        if getattr(self, "ra_mode", False):
            self._dpb_fc = {s: fc for s in range(8)}
        elif self.hierarchical_levels > 0:
            self._dpb_fc[0] = fc
            self._last_slot_by_layer = {0: 0}
        if self.hierarchical_levels > 0 or getattr(self, "ra_mode", False):
            rec = (self._rec_y.copy(), self._rec_u.copy(),
                   self._rec_v.copy())
            self._dpb = {s: rec for s in range(8)} \
                if getattr(self, "ra_mode", False) else {0: rec}
        self._slot_gm = [((0, 0),) * 7 for _ in range(8)]
        if self.enable_mfmv:
            from svt_av1_psy_tpu.inter.mfmv import save_motion_field
            kh = d & 0x7F
            mf = save_motion_field([], self.mi_rows, self.mi_cols, kh,
                                   [kh] * 7, [kh] * 7, 7, is_intra=True)
            self._slot_mf = [mf] * 8
        self._slot_hint = [d & 0x7F] * 8
        # the IBC key coded with all in-loop filters off: drop the
        # cross-frame filter caches so the next inter frame re-searches
        self._dlf_cache = None
        self._cdef_cache = None
        self._lr_pending = None
        self.frame_index += 1
        self._swap_recon()
        from svt_av1_psy_tpu.utils.trace import next_frame as _tnext
        _tnext()
        return f

    # --- loop restoration ---------------------------------------------------
    def _lr_apply_and_search(self, yp, up, vp, base_q, lr_dec, pre_cdef):
        """Apply this frame's signalled LR params (normative, in place on
        the recon) and dispatch the device search for the next frame's
        params on the pre-LR post-CDEF recon (the cross-frame cache;
        ref rest_process.c / restoration_pick.c:1471 — the solve +
        filtered-SSE math runs on the device, models/lr_search.py
        DeviceLrSearch)."""
        from svt_av1_psy_tpu.ops.quant import ac_q
        from svt_av1_psy_tpu.ops.restoration import apply_lr_frame
        H, W = self.height, self.width
        cw, ch = (W + 1) // 2, (H + 1) // 2
        dims = [(W, H), (cw, ch), (cw, ch)]
        planes = [self._rec_y, self._rec_u, self._rec_v]
        qstep = ac_q(base_q, self.bd) / 8.0
        rdmult = 0.12 * qstep * qstep * getattr(self, "_cur_rd_scale", 1.0)
        if self._lr_dev is None:
            self._lr_dev = DeviceLrSearch(dims, self.bd, device=self.device)
        tok = self._lr_dev.dispatch((yp, up, vp), planes)
        if lr_dec is not None:
            apply_lr_frame(planes, list(pre_cdef), dims, lr_dec.lr_type,
                           lr_dec.unit_size, lr_dec.units, bd=self.bd)
        self._lr_pending = ("dev", tok, rdmult)

    # --- device search stage ---------------------------------------------
    def _decide_dispatch(self, yp: np.ndarray) -> HostCopy:
        """Launch the decision program on the device and start the copy
        of its packed uint8 result home; no host sync."""
        bias = int(8 * ac_q(self.qindex, self.bd))
        return HostCopy(intra_decide_packed(plane_tensor(yp, self.device),
                                            bias, self.bd, self.min_block))

    def _decide_finish(self, out):
        """Maps of one packed decide buffer: a HostCopy from
        _decide_dispatch, or a numpy row of the GoP program's buffer (the
        RA walk, svt_av1_psy_tpu/models/ra.py _walk_gop)."""
        s64, s32, s16, m64, m32, m16, m8 = intra_decide_unpack(
            np.asarray(out), (self.pah, self.paw))
        # defensive clamp: a corrupted transfer must never reach the C
        # engine as an out-of-range symbol
        maps = {}
        for k, m in ((64, m64), (32, m32), (16, m16), (8, m8)):
            maps[k] = np.where(m <= 12, m, 0).astype(np.uint8)
        return ({64: np.minimum(s64, 1), 32: np.minimum(s32, 1),
                 16: np.minimum(s16, 1)}, maps)

    def prefetch_decide(self, y) -> None:
        """Dispatch the decision stage for the frame the NEXT encode_frame
        call will receive, so it computes on the device while the current
        frame's commit walk runs on the host. The driver must pass the
        SAME array object to the next encode_frame."""
        if self.device.type == "cpu" and \
                not os.environ.get("SVT_PREFETCH_CPU"):
            # on the CPU the decide program and the commit-walk threads
            # share the cores: overlap only pays on a GPU
            return
        ys = self._downscale_y(y)
        yp = _pad_to(np.asarray(ys), self.pah, self.paw)
        pend = getattr(self, "_pref", None)
        if not isinstance(pend, dict):
            pend = {}
            self._pref = pend
        if len(pend) >= 4:          # bound frames-in-flight
            pend.pop(next(iter(pend)))
        # key by object identity; holding y in the value keeps the id
        # stable (no GC reuse) until the entry is consumed or evicted
        pend[id(y)] = (y, self._decide_dispatch(yp))

    # --- P frames (low-delay, single LAST ref) ---------------------------
    def _encode_p(self, y, u, v, ra=None) -> EncodedFrame:
        """Inter frame: device HME + intra decision maps -> native inter
        walk (inter_backend.c). Low-delay (ra=None): reference = previous
        frame's filtered recon (the ping-pong buffer), layer/slot logic
        from the hierarchical LD pyramid. Random access (ra=dict from
        models/ra.py): explicit ref_slot / refresh / order_hint /
        base_q / show — the driver owns the pyramid (ref
        pd_process.c prediction-structure roles)."""
        from svt_av1_psy_tpu.utils.trace import stage as _tstage

        native = self._native
        yp = _pad_to(np.asarray(y), self.pah, self.paw)
        up = _pad_to(np.asarray(u), self.pah // 2, self.paw // 2)
        vp = _pad_to(np.asarray(v), self.pah // 2, self.paw // 2)

        # compound (bidirectional) prediction: second reference =
        # the FUTURE anchor (ALTREF slot); RA mids/leaves only
        ref2_slot = ra.get("ref_slot2") if ra is not None else None
        if ref2_slot is not None and (ref2_slot == ra["ref_slot"] or
                                      ref2_slot not in self._dpb):
            ref2_slot = None

        mv16b = None
        pre = ra.get("pre") if ra is not None else None

        # MRP third reference (GOLDEN = the mini-GoP base; ref
        # pd_process.c ref lists): per-block LAST/GOLDEN choice from the
        # device HME SAD maps. Requires the compound pair (the sign-bias
        # /skip-mode slot derivation assumes the full RA ref list).
        ref3_slot = ra.get("ref_slot3") if ra is not None else None
        mv16g = ref_sel = None
        if pre is not None:
            ref_sel = pre.get("refsel")
        if ref3_slot is not None and (
                ref3_slot == ra["ref_slot"] or ref2_slot is None or
                ref3_slot == ref2_slot or ref3_slot not in self._dpb or
                pre is None):
            ref3_slot = None
        if ref3_slot is not None:
            mv16g = pre.get("mv16g")
            if mv16g is None:
                ref3_slot = None
        # sel values: 0 = LAST, 1 = GOLDEN (needs ref3), 2 = ALTREF
        # (needs the compound second ref + its HME field). Demote
        # selections whose reference did not survive the slot checks.
        if ref_sel is not None:
            if ref3_slot is None and (ref_sel == 1).any():
                ref_sel = np.where(ref_sel == 1, 0, ref_sel)
            if (ref2_slot is None or pre is None or
                    pre.get("mv16b") is None) and (ref_sel == 2).any():
                ref_sel = np.where(ref_sel == 2, 0, ref_sel)
            ref_sel = np.ascontiguousarray(ref_sel, np.uint8)
            if not ref_sel.any():
                ref_sel = None
        if ref_sel is None:
            ref3_slot = None
        with _tstage("device_search"):
            if pre is not None:
                # GoP-batched device search (ops/jax_backend.gop_search):
                # the RA driver computed decide maps + every edge's HME in
                # one dispatch at GoP start — nothing to wait for here
                split, modes = pre["decide"]
                mv16 = pre["mv16"]
                if ref2_slot is not None:
                    mv16b = pre.get("mv16b")
            else:
                # launch every device program and start its copy home
                # first (in stream order on CUDA), THEN wait for the
                # results
                if ra is not None:
                    hme_ref = self._dpb[ra["ref_slot"]][0]
                else:
                    hme_ref = self._ref_y
                yp_dev = plane_tensor(yp, self.device)
                hme_dev = HostCopy(_hme_packed(
                    yp_dev, plane_tensor(hme_ref[:self.pah, :self.paw],
                                         self.device)))
                hme2_dev = None
                if ref2_slot is not None:
                    hme2_ref = self._dpb[ref2_slot][0]
                    hme2_dev = HostCopy(_hme_packed(
                        yp_dev, plane_tensor(hme2_ref[:self.pah, :self.paw],
                                             self.device)))
                split, modes = self._take_decide(y, yp)
                n16r, n16c = self.pah // 16, self.paw // 16
                mv16, _sad16 = hme2_unpack(hme_dev.numpy(), n16r, n16c)
                mv16 = np.clip(mv16, -127, 127).astype(np.int16)
                self._ld_sad16 = _sad16
                if hme2_dev is not None:
                    mv16b, _s2 = hme2_unpack(hme2_dev.numpy(), n16r, n16c)
                    mv16b = np.clip(mv16b, -127, 127).astype(np.int16)

        # global motion: ROTZOOM (LSQ over the device HME field; pan +
        # zoom/rotation content) with robust-translation fallback
        # (ref global_me.c:126; params coded per spec 5.9.24)
        gm_wm = None
        gm_mv8v = (0, 0)
        gm_rz = None
        if self.enable_gm:
            import os as _osgm
            from svt_av1_psy_tpu.inter.global_motion import (
                WARPEDMODEL_PREC_BITS, estimate_rotzoom,
                estimate_translation, mv8_to_wm01)
            rz = None
            if _osgm.environ.get("SVT_GM_RZ", "1") != "0":
                rz = estimate_rotzoom(mv16)
            one = 1 << WARPEDMODEL_PREC_BITS
            # the non-translational part must move a frame corner by
            # >= 1 px — below that the model is noise-fit and plain
            # translation codes cheaper
            if rz is not None and \
                    (abs(rz[2] - one) + abs(rz[3])) * \
                    max(self.pah, self.paw) >= one:
                gm_rz = rz
            else:
                est = estimate_translation(mv16)
                if est is not None:
                    gm_mv8v = est
                    gm_wm = mv8_to_wm01(*est)

        # RefFrameSignBias + skip-mode allowance (spec 5.9.2 / 5.9.22;
        # must equal the decoder's derivation from slot order hints)
        sign_bias = [0] * 8
        sm_present = False
        if ref2_slot is not None:
            def _rel(a, b):
                d = a - b
                m = 1 << 6                      # order_hint_bits = 7
                return (d & (m - 1)) - (d & m)
            cur_hint = ra["order_hint"] & 0x7F
            hint_last = self._slot_hint[ra["ref_slot"]]
            hint_alt = self._slot_hint[ref2_slot]
            hints7 = [hint_last] * 6 + [hint_alt]
            if ref3_slot is not None:
                hints7[3] = self._slot_hint[ref3_slot]   # GOLDEN
            for k in range(7):
                sign_bias[k + 1] = int(_rel(hints7[k], cur_hint) > 0)
            fwd_h = bwd_h = None
            for h in hints7:
                if _rel(h, cur_hint) < 0:
                    if fwd_h is None or _rel(h, fwd_h) > 0:
                        fwd_h = h
                elif _rel(h, cur_hint) > 0:
                    if bwd_h is None or _rel(h, bwd_h) < 0:
                        bwd_h = h
            if fwd_h is not None:
                if bwd_h is not None:
                    sm_present = True
                else:
                    sm_present = any(_rel(h, fwd_h) < 0 for h in hints7)

        L = self.hierarchical_levels
        gop_pos = self.frame_index if self.gop_size == 0 else \
            self.frame_index % max(self.gop_size, 1)
        if ra is not None:
            layer = ra["layer"]
            ref_slot = ra["ref_slot"]
        elif L > 0:
            m = 1 << L
            pos = gop_pos % m
            tz = (pos & -pos).bit_length() - 1 if pos else L
            layer = L - min(tz, L)
        else:
            layer = 0
        if ra is None:
            # reference slot: most recent stored frame at layer <= ours
            ref_slot = 0
            for l2 in range(min(layer, L), -1, -1):
                if l2 in self._last_slot_by_layer:
                    ref_slot = self._last_slot_by_layer[l2]
                    break

        # MFMV (spec 7.9): project the DPB's saved motion fields into
        # this frame; the C ref-MV stacks then insert temporal candidates
        # (ref md_config_process.c:505 av1_setup_motion_field). The
        # decoder rebuilds the same projection from its own saved fields,
        # so the per-slot state must mirror the decode side exactly.
        cur_hint_mf = (self.frame_index if ra is None
                       else ra["order_hint"]) & 0x7F
        if ra is not None:
            rl7 = [ref_slot] * 6 + [ref2_slot] \
                if ref2_slot is not None else [ref_slot] + [0] * 6
            if ref3_slot is not None:
                rl7[3] = ref3_slot                       # GOLDEN
            ref_idx7 = tuple(rl7)
        else:
            ref_idx7 = (ref_slot,) + (0,) * 6
        hints7_mf = [self._slot_hint[ref_idx7[k]] for k in range(7)]
        tpl_pack = None
        use_rfm = False
        if self.enable_mfmv and self.seq.enable_ref_frame_mvs:
            from svt_av1_psy_tpu.inter.mfmv import setup_motion_field
            from svt_av1_psy_tpu.utils.trace import stage as _ts0

            def _rdist(a, b):
                d = a - b
                msk = 1 << 6
                return (d & (msk - 1)) - (d & msk)

            with _ts0("mfmv_projection"):
                tpl_mv, tpl_off, tpl_valid = setup_motion_field(
                    self._slot_mf, ref_idx7, cur_hint_mf, 7,
                    self.mi_rows, self.mi_cols)
            cur_off8 = np.zeros(8, np.int32)
            for k in range(7):
                cur_off8[k + 1] = _rdist(cur_hint_mf, hints7_mf[k])
            tpl_pack = (np.ascontiguousarray(tpl_mv),
                        np.ascontiguousarray(tpl_off),
                        np.ascontiguousarray(tpl_valid, np.uint8),
                        cur_off8)
            use_rfm = True

        base_q = self.qindex if ra is None else ra["base_q"]
        if ra is None and L > 0 and layer > 0:
            # per-layer q spread with PSY qp-scale-compress
            w = (1.0, 1.125, 1.25, 1.375)[min(layer, 3)]
            qsc = 1.0 / (1.0 + 0.5 * self.qp_scale_compress_strength)
            base_q = int(np.clip(round(self.qindex +
                                       self.qindex * (w - 1.0) * qsc),
                                 0, 255))
        if self.frame_luma_bias:
            # ref rc_process.c:3413 (temporal layer 1 for flat IPPP)
            avg_luma = float(yp[::4, ::4].mean()) / (1 << (self.bd - 8))
            denom = 1024.0 / (1 * 4 * 0.01 * self.frame_luma_bias)
            adj = round(-(((255.0 - avg_luma) / denom) ** 0.5) *
                        (base_q / 8.0))
            base_q = int(np.clip(base_q + adj, 0, 255))
        # eighth-pel MVs only at fine quantizers (the libaom
        # HIGH_PRECISION_MV_QTHRESH rule, ref enc_mode_config.c:8479;
        # the reference further restricts hp to <=480p inputs). Default
        # OFF: with the SAD-driven subpel search, the hp bits measured
        # +2-5% BD on the pan/occl harness even with the q gate — the
        # capability stays available via the allow_hp attr for
        # RD-aware-subpel work later.
        self._frame_allow_hp = bool(getattr(self, "allow_hp", False)) \
            and base_q < 128
        self._last_coded_q = base_q
        self._last_is_key = False
        sbq = None
        dq_res_log2 = -1
        if self.tpl_offsets is not None:
            from svt_av1_psy_tpu.models.tpl import snap_sb_q
            merged, dq_res_log2 = snap_sb_q(
                base_q, base_q + self.tpl_offsets.astype(np.int32))
            sbq = merged.astype(np.int16)

        # inter partition tree from the device HME field (ref: the
        # open-loop ME SAD tree drives MD depth; our intra source-SAD
        # tree over-splits noisy inter content to 8x8 — an order of
        # magnitude more commit trials than needed, and a partition-bit
        # tax at low rates). models/inter_tree derives split maps from
        # MV-field coherence + prediction quality vs the quantizer.
        import os as _os0
        tree_l = pre.get("tree") if pre is not None else None
        if tree_l is not None and \
                _os0.environ.get("SVT_INTER_TREE", "1") != "0":
            from svt_av1_psy_tpu.models.inter_tree import inter_split_maps
            tree_edges = [(pre["sad16"],) + tuple(tree_l)]
            if mv16b is not None and pre.get("treeb") is not None:
                tree_edges.append((pre["sad16b"],) + tuple(pre["treeb"]))
            if ref3_slot is not None and pre.get("treeg") is not None:
                tree_edges.append((pre["sad16g"],) + tuple(pre["treeg"]))
            split = inter_split_maps(tree_edges, split, base_q, self.bd)

        self._lf_y[:] = 0
        self._lf_uv[:] = 0

        # primary_ref_frame CDF inheritance: start from the saved frame-end
        # context of the reference (spec load_cdfs; decoder mirrors this)
        if ra is not None or L > 0:
            src_fc = self._dpb_fc.get(ref_slot, self._fc_saved)
            ref_planes = self._dpb.get(ref_slot)
        else:
            src_fc = self._fc_saved
            ref_planes = None
        lr_dec = self._take_lr_pending() if self.enable_lr else None

        inherited = src_fc.inherit_copy()
        n_tiles_total = self.n_tiles * self.n_tile_rows
        tile_fcs = [inherited if ti == 0 else inherited.copy()
                    for ti in range(n_tiles_total)]
        qm = self._frame_qm_levels(base_q)

        # refresh decision (known before the walk): a frame that refreshes
        # no DPB slot is never referenced — its motion field is dead and
        # its in-loop filter APPLY can leave the critical path
        if ra is not None:
            refresh = ra["refresh"]
        elif L > 0:
            refresh = (1 << layer) if layer < L else 0
        else:
            refresh = 0x01
        never_referenced = refresh == 0

        # frame-kind lambda (ref compute_rd_mult's gf_update_type):
        # ARF/base anchors vs mid-pyramid vs never-referenced leaves
        if (ra is not None and ra["layer"] == 0) or \
                (ra is None and L > 0 and layer == 0):
            rd_kind = "arf"
        elif never_referenced:
            rd_kind = "leaf"
        else:
            rd_kind = "mid"
        rd_scale = self._frame_rd_scale(rd_kind, base_q)
        self._cur_rd_scale = rd_scale

        def encode_tile(ti):
            tr, tc = divmod(ti, self.n_tiles)
            r0 = self.tile_row_starts[tr] * 16
            r1 = min(self.tile_row_starts[tr + 1] * 16, self.mi_rows)
            c0 = self.tile_col_starts[tc] * 16
            c1 = min(self.tile_col_starts[tc + 1] * 16, self.mi_cols)
            eng = native.CommitEngine(self.width, self.height, self.bd,
                                      sharpness=self.sharpness,
                                      base_q=base_q)
            eng.set_rdmult_scale(rd_scale)
            if qm is not None:
                eng.set_qm(*qm)
            if self.noise_norm:
                eng.set_noise_norm(self.noise_norm)
            if self.tune_ssim:
                eng.set_tune_ssim(True)
            eng.attach_planes(self._rec_y, self._rec_u, self._rec_v)
            if ref_planes is not None:
                eng.set_ref(*ref_planes)
            else:
                eng.set_ref(self._ref_y, self._ref_u, self._ref_v)
            if self.enable_dlf:
                eng.attach_lfmaps(self._lf_y, self._lf_uv)
            eng.attach_skipmap(self._skip_map)
            if self.psy_rd:
                eng.set_psy_rd(self.psy_rd)
            if lr_dec is not None:
                eng.set_lr(lr_dec.lr_type, lr_dec.unit_size, lr_dec.flat,
                           lr_dec.ucols, lr_dec.urows)
            eng.set_src(yp, up, vp)
            eng.set_gm(gm_mv8v)
            if gm_rz is not None:
                eng.set_gm_warp(gm_rz)
            if getattr(self, "interp_search", False):
                eng.set_interp(True, gm_wm is not None)
            if self.obmc_search or self.warp_search:
                eng.set_obmc(True, self.warp_search)
            if getattr(self, "interintra_search", False):
                eng.set_interintra(True)
            if getattr(self, "fi_search", False):
                # seq enable_filter_intra gates the flag on intra blocks
                # of INTER frames too (spec 5.11.7)
                eng.set_filter_intra(True)
            if ref2_slot is not None:
                eng.set_ref2(*self._dpb[ref2_slot])
                eng.set_compound(sm_present, sign_bias,
                                 self.masked_compound_search)
            if ref3_slot is not None:
                eng.set_ref3(*self._dpb[ref3_slot])
            if ref_sel is not None:
                eng.set_ref_sel(
                    ref_sel, mv16g if mv16g is not None
                    else np.zeros(ref_sel.shape + (2,), np.int16))
            if tpl_pack is not None:
                eng.set_tpl(*tpl_pack)
            # after set_tpl: both share the allow_hp field in C
            eng.set_allow_hp(self._frame_allow_hp)
            if getattr(self, "inter_tx_split", False):
                eng.set_tx_select(True)
            ec = native.NativeRangeEncoder()
            eng.encode_inter(ec, tile_fcs[ti], split, modes, mv16,
                             sbq=sbq, dq_res_log2=dq_res_log2,
                             base_q=base_q,
                             mi_bounds=(r0, r1, c0, c1),
                             n_cands=self.n_cands, mv16b=mv16b)
            grid_exp = None
            if self.enable_mfmv and not never_referenced:
                grid_exp = (eng.grid_read(), (r0, r1, c0, c1))
            return ec.done(), grid_exp

        import os as _os
        # a deferred leaf filter from two frames ago may still be
        # running on this ping-pong buffer
        self._join_pending_filter(self._rec_y)
        with _tstage("inter_commit_walk"):
            if n_tiles_total == 1 or _os.environ.get("SVT_TILE_SEQ"):
                tile_out = [encode_tile(i) for i in range(n_tiles_total)]
            else:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=n_tiles_total) as tp:
                    tile_out = list(tp.map(encode_tile,
                                           range(n_tiles_total)))
        tile_bytes = [t[0] for t in tile_out]

        # spec 7.20 motion-field storage for later frames' MFMV (dead
        # when no DPB slot is refreshed — nothing can reference it)
        new_mf = None
        if self.enable_mfmv and not never_referenced:
            from types import SimpleNamespace
            from svt_av1_psy_tpu.inter.mfmv import save_motion_field
            grids = []
            for _, gb in tile_out:
                if gb is None or gb[0] is None:
                    continue
                (g_ref0, g_ref1, g_mv0, g_mv1), bounds = gb
                grids.append((SimpleNamespace(ref0=g_ref0, ref1=g_ref1,
                                              mv0=g_mv0, mv1=g_mv1),
                              bounds))
            new_mf = save_motion_field(grids, self.mi_rows, self.mi_cols,
                                       cur_hint_mf, hints7_mf, hints7_mf,
                                       7, is_intra=False)

        if self.n_tiles == 1:
            tg = tile_bytes[0]
        else:
            parts = [b"\x00"]
            for tb in tile_bytes[:-1]:
                parts.append((len(tb) - 1).to_bytes(4, "little"))
                parts.append(tb)
            parts.append(tile_bytes[-1])
            tg = b"".join(parts)

        # in-loop filter stage. A never-referenced frame whose DLF/CDEF
        # parameters come from the frame-level caches moves the APPLY
        # (not the search — the header signals the cached levels) to a
        # background thread that overlaps the next frame's walk — the
        # P1-pipeline deferral the all-intra path uses, generalized to
        # the pyramid's leaf frames (SURVEY §2.2 P1)
        filters_cached = (
            self._dlf_cache is not None and self._cdef_cache is not None
            and (self.frame_index % max(self.cdef_search_interval, 1)))
        defer = (never_referenced and filters_cached and self.enable_dlf
                 and self.enable_cdef and not self.superres_denom)
        deferred_task = None
        if defer:
            ly, lu, lv_ = self._dlf_cache
            lf = (ly, ly, lu, lv_)
            cdef_st = self._cdef_cache
            cdef_damp = 3 + (base_q >> 6)
            deferred_task = self._deferred_filter_task(
                yp, up, vp, base_q, (ly, lu, lv_), cdef_st, cdef_damp,
                lr_dec=lr_dec if self.enable_lr else None)
        else:
            lf = (0, 0, 0, 0)
            if self.enable_dlf:
                with _tstage("dlf"):
                    lf = self._pick_and_apply_dlf(yp, up, vp, base_q)
            pre_cdef = None
            if self.enable_lr:
                pre_cdef = (self._rec_y.copy(), self._rec_u.copy(),
                            self._rec_v.copy())
            cdef_st, cdef_damp = ((0, 0, 0, 0), 3)
            if self.enable_cdef:
                with _tstage("cdef"):
                    cdef_st, cdef_damp = self._search_apply_cdef(
                        yp, up, vp, base_q)
            if self.enable_lr:
                with _tstage("loop_restoration"):
                    self._lr_apply_and_search(yp, up, vp, base_q, lr_dec,
                                              pre_cdef)

        self._fc_saved = tile_fcs[0]
        ref_idx = (0,) * 7
        show = True
        order_hint = self.frame_index & 0x7F
        if ra is not None:
            if ref2_slot is not None:
                rl = [ref_slot] * 6 + [ref2_slot]
            else:
                rl = [ref_slot] + [0] * 6
            if ref3_slot is not None:
                rl[3] = ref3_slot                        # GOLDEN
            ref_idx = tuple(rl)
            show = ra["show"]
            order_hint = ra["order_hint"] & 0x7F
        elif L > 0:
            ref_idx = (ref_slot,) + (0,) * 6

        gm_trans = None
        if gm_rz is not None:
            gm_trans = (gm_rz,) + (None,) * 6      # LAST only, ROTZOOM
        elif gm_wm is not None:
            gm_trans = (gm_wm,) + (None,) * 6      # LAST only
        fr_params = FrameParams(
            frame_type=1, base_q_idx=base_q,
            order_hint=order_hint,
            using_qmatrix=qm is not None,
            qm_y=qm[0] if qm else 15,
            qm_u=qm[1] if qm else 15,
            qm_v=qm[2] if qm else 15,
            show_frame=show, showable_frame=not show,
            tx_mode_select=getattr(self, "inter_tx_split", False),
            primary_ref_frame=0,
            gm_trans=gm_trans,
            gm_prev=self._slot_gm[ref_idx[0]],
            reference_select=ref2_slot is not None,
            skip_mode_allowed=sm_present,
            skip_mode_present=sm_present,
            refresh_frame_flags=refresh, ref_frame_idx=ref_idx,
            use_ref_frame_mvs=use_rfm,
            is_motion_mode_switchable=self.obmc_search or self.warp_search,
            allow_warped_motion=self.warp_search,
            allow_high_precision_mv=self._frame_allow_hp,
            interp_filter=0,
            is_filter_switchable=getattr(self, "interp_search", False),
            delta_q_present=sbq is not None,
            delta_q_res_log2=max(dq_res_log2, 0),
            lr_type=self._lr_coded_type(lr_dec),
            lr_unit_shift=0, lr_uv_shift=1,
            tile_cols_log2=self.tile_cols_log2,
            tile_rows_log2=self.tile_rows_log2,
            filter_level=(lf[0], lf[1]),
            filter_level_uv=(lf[2], lf[3]),
            film_grain=self._fg_params,
            cdef_damping=cdef_damp, cdef_bits=0,
            cdef_y_pri=(cdef_st[0],),
            cdef_y_sec=(cdef_st[1] - (cdef_st[1] == 4),),
            cdef_uv_pri=(cdef_st[2],),
            cdef_uv_sec=(cdef_st[3] - (cdef_st[3] == 4),))
        if ra is not None:
            if refresh:
                rec = (self._rec_y.copy(), self._rec_u.copy(),
                       self._rec_v.copy())
                for s in range(8):
                    if refresh & (1 << s):
                        self._dpb[s] = rec
                        self._dpb_fc[s] = tile_fcs[0]
        elif L > 0 and layer < L:
            slot = layer
            self._dpb[slot] = (self._rec_y.copy(), self._rec_u.copy(),
                               self._rec_v.copy())
            self._dpb_fc[slot] = tile_fcs[0]
            self._last_slot_by_layer[layer] = slot
        # mirror the decoder's SavedGmParams + slot-hint updates (7.20)
        cur_gm = ((gm_rz if gm_rz is not None else
                   gm_wm if gm_wm is not None else (0, 0)),) + \
            ((0, 0),) * 6
        for s in range(8):
            if refresh & (1 << s):
                self._slot_gm[s] = cur_gm
                self._slot_hint[s] = order_hint
                if new_mf is not None:
                    self._slot_mf[s] = new_mf

        payload = key_frame_temporal_unit(
            self.seq, fr_params, tg, with_seq_header=False,
            metadata=(getattr(self, "metadata_frame", b"") +
                      self._per_frame_metadata(
                          self.frame_index if ra is None
                          else ra["order_hint"])))
        self.frame_index += 1
        from svt_av1_psy_tpu.utils.trace import next_frame as _tnext
        if deferred_task is not None:
            self._swap_recon()
            _tnext()
            return EncodedFrame(payload=payload, resolve=deferred_task)
        H, W = self.height, self.width
        cH, cW = (H + 1) // 2, (W + 1) // 2
        dt = np.uint8 if self.bd == 8 else np.uint16
        rec_y = self._rec_y[:H, :W].astype(dt)
        rec_u = self._rec_u[:cH, :cW].astype(dt)
        rec_v = self._rec_v[:cH, :cW].astype(dt)
        self._swap_recon()
        _tnext()
        return EncodedFrame(payload=payload, recon_y=rec_y, recon_u=rec_u,
                            recon_v=rec_v)
