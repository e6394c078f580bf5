"""Fast all-intra encoder: dense device search + native commit walk.

The two-phase architecture SURVEY.md §7 prescribes:

  1. SEARCH (device, JAX/XLA): every superblock's intra mode costs for all
     block sizes are evaluated densely in one jitted program
     (ops/jax_backend.block_mode_costs) — the PD_PASS_0 analog of the
     reference (ref: Source/Lib/Codec/enc_dec_process.c:3455). Produces
     per-size best-mode maps and split decisions.
  2. COMMIT (host, native C): the wavefront-exact encode pass —
     prediction from reconstructed neighbors, transform/quantize/recon and
     tile entropy coding (native/commit_backend.c) — the PD_PASS_1 +
     encode-pass + EC analog (ref: coding_loop.c, entropy_coding.c).

This path is the high-preset (speed) configuration; the full Python RD
funnel (models/intra_encoder.py) remains the quality path.

The port's copy of svt_av1_psy_tpu/models/fast_intra.py, with its
device search in PyTorch on ``device`` ("cpu" or "cuda[:N]"): the intra
decision (_decide_dispatch / _decide_finish / prefetch_decide), the
low-delay device block of _encode_p, hme_mv_sad, and _encode_key_sc, which
builds the port's IntraEncoder on that device. The walks' post-walk tail
(the tile runner, the tile-group assembly and the in-loop filter stage,
with CDEF on the card and the LR search on the device) is the port's own,
models/frame_tail.py FrameTail, a base of FastIntraEncoder. On CUDA the
programs launch asynchronously in stream order; each packed result comes
home through a HostCopy (a non_blocking copy into pinned memory plus a
CUDA event), which the host waits for only where it reads the result.
The multi-device decide (make_sharded_decide) takes a list of devices in
place of a mesh and shards the plane's columns over it. Everything else
is the reference's code; tests/test_torch_standalone.py lists what
differs and guards the rest against drift.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from svt_av1_psy_tpu_torch.bitstream.headers import (FrameParams, SequenceParams,
                                               key_frame_temporal_unit)
from svt_av1_psy_tpu_torch.entropy.frame_context import FrameContext
from svt_av1_psy_tpu_torch.kernels.hme import hme_search_kernel
from svt_av1_psy_tpu_torch.models.frame_tail import FrameTail
from svt_av1_psy_tpu_torch.models.intra_encoder import EncodedFrame, _pad_to
from svt_av1_psy_tpu_torch.ops.quant import ac_q
from svt_av1_psy_tpu_torch.ops.torch_backend import (hme2_unpack,
                                                     hme_search2,
                                                     intra_decide_packed,
                                                     intra_decide_sharded,
                                                     intra_decide_unpack,
                                                     pack_mv_sad,
                                                     pixel_tensor,
                                                     plane_tensor)
from svt_av1_psy_tpu_torch.utils.device import (DeviceGroup, HostCopy,
                                               resolve_device)

SB = 64


def _k1_route() -> bool:
    """Whether the full-pel ME takes the single-level search. The route
    follows the environment at each call, as the reference's _jitted_hme
    reads it (once, at its first call): SVT_HME_PALLAS=1 or
    SVT_HME_1LEVEL=1 select the single-level search (the K1 kernel on
    CUDA; its plain version on the CPU); by default the two-level
    hme_search2 runs."""
    return os.environ.get("SVT_HME_PALLAS") == "1" or \
        os.environ.get("SVT_HME_1LEVEL") == "1"


def _hme_plane(arr, device):
    """A numpy pixel plane on `device` as _hme_packed takes it: in its
    pixel width for K1 (the kernel reads 8-bit and 16-bit pixels as they
    are), int32 for hme_search2."""
    return (pixel_tensor if _k1_route() else plane_tensor)(arr, device)


def _hme_packed(src, ref):
    """Full-pel ME of two (H, W) device planes (from _hme_plane) as ONE
    packed int32 tensor (mv16 | sad16; hme2_unpack decodes it)."""
    if _k1_route():
        return pack_mv_sad(*hme_search_kernel(src, ref))
    return pack_mv_sad(*hme_search2(src, ref))


def hme_mv_sad(src_p, ref_p, device):
    """Run the full-pel ME on (padded) planes on ``device`` and return
    (mv16, sad16) as numpy — the packed transfer + unpack in one step
    for callers outside the frame pipeline (TPL, temporal filter).
    src_p, ref_p: (H, W) uint8/uint16 numpy planes, H and W multiples of
    16."""
    dev = resolve_device(device)
    out = HostCopy(_hme_packed(_hme_plane(src_p, dev),
                               _hme_plane(ref_p, dev)))
    ph, pw = src_p.shape
    return hme2_unpack(out.numpy(), ph // 16, pw // 16)


class FastIntraEncoder(FrameTail):
    """Device-search + C-commit all-intra encoder (KEY frames only)."""

    def __init__(self, width: int, height: int, qindex: int, bd: int = 8,
                 min_block: int = 8, n_tiles: int = 0, n_cands: int = 3,
                 superres_denom: int = 0, n_tile_rows: int = 0, *,
                 device):
        """n_tiles: desired tile columns (0 = auto: one per host core,
        capped by frame width). Tiles are the host thread-parallel axis
        AND the device shard axis (SURVEY.md §2.2 P4; ref ec_process.c:208
        runs one EC kernel per tile).
        n_cands: top-K device mode candidates the commit walk RD-trials
        per block (1..3; the md_stage_0 -> md_stage_3 funnel width).
        superres_denom: 9..16 codes every frame at the horizontally
        downscaled width and signals the normative upscale (spec 5.9.8 /
        7.16; all-intra only — inter frames would need scaled refs)."""
        import os

        from svt_av1_psy_tpu_torch import native
        assert width % 2 == 0 and height % 2 == 0
        self.up_width = width
        self.superres_denom = superres_denom
        if superres_denom:
            from svt_av1_psy_tpu_torch.ops.resize import superres_coded_width
            assert 9 <= superres_denom <= 16
            width = superres_coded_width(width, superres_denom)
        self.width, self.height = width, height
        self.qindex = qindex
        self.bd = bd
        self.min_block = min_block
        self.n_cands = n_cands
        self.mi_cols = 2 * ((width + 7) >> 3)
        self.mi_rows = 2 * ((height + 7) >> 3)
        self.aw = self.mi_cols * 4
        self.ah = self.mi_rows * 4
        self.paw = (self.aw + SB - 1) // SB * SB
        self.pah = (self.ah + SB - 1) // SB * SB
        self.seq = SequenceParams(width=self.up_width, height=height,
                                  bit_depth=bd,
                                  enable_cdef=True, enable_restoration=False,
                                  enable_superres=bool(superres_denom))
        self.frame_index = 0
        self._native = native
        # where the device search runs ("cpu" or "cuda[:N]")
        self.device = resolve_device(device)
        # tile geometry (uniform spacing, spec 5.9.15; bounds from the
        # CODED width)
        from svt_av1_psy_tpu_torch.bitstream.headers import (tile_info_bounds,
                                                       tile_log2)
        sb_cols = (self.paw + 63) >> 6
        sb_rows = (self.pah + 63) >> 6
        want = n_tiles if n_tiles > 0 else min(os.cpu_count() or 1, 8)
        (min_l2c, max_l2c, max_l2r, min_l2t) = tile_info_bounds(self.seq,
                                                                width)
        self.tile_cols_log2 = min(max(tile_log2(1, want), min_l2c), max_l2c)
        tw_sb = (sb_cols + (1 << self.tile_cols_log2) - 1) >> \
            self.tile_cols_log2
        self.tile_col_starts = list(range(0, sb_cols, tw_sb)) + [sb_cols]
        # uniform tile ROWS (spec 5.9.15; ref Parameters.md:274
        # --tile-rows): a second host-parallel axis over SB rows
        self.tile_rows_log2 = 0
        if n_tile_rows > 0:
            want_r = min(n_tile_rows, sb_rows)
            self.tile_rows_log2 = min(tile_log2(1, want_r), max_l2r)
        min_l2r = max(min_l2t - self.tile_cols_log2, 0)
        self.tile_rows_log2 = max(self.tile_rows_log2, min_l2r)
        th_sb = (sb_rows + (1 << self.tile_rows_log2) - 1) >> \
            self.tile_rows_log2
        self.tile_row_starts = list(range(0, sb_rows, th_sb)) + [sb_rows]
        self.n_tile_rows = len(self.tile_row_starts) - 1
        self.n_tiles = len(self.tile_col_starts) - 1
        from svt_av1_psy_tpu_torch.utils import trace as _tr
        _tr.set_tile_grid(self.n_tiles, self.n_tile_rows)
        # initialize the native layer once, single-threaded (tile engines
        # are constructed inside worker threads)
        native.CommitEngine(64, 64, bd)
        # shared recon planes (numpy-owned, attached to every tile engine);
        # ping-pong pair: current frame writes one set while the previous
        # (filtered) set serves as the LAST reference for P frames
        self._rec_y = np.zeros((self.pah + 64, self.paw + 64), np.uint16)
        self._rec_u = np.zeros((self.pah // 2 + 64, self.paw // 2 + 64),
                               np.uint16)
        self._rec_v = np.zeros_like(self._rec_u)
        self._ref_y = np.zeros_like(self._rec_y)
        self._ref_u = np.zeros_like(self._rec_u)
        self._ref_v = np.zeros_like(self._rec_v)
        self.gop_size = 1    # 1 = all intra, 0 = IPPP, N = keyint
        # hierarchical low-delay pyramid: 0 = flat IPPP; L in 1..3 gives a
        # 2^L mini-GoP with per-layer q offsets (ref pred_structure.c;
        # PSY qp-scale-compress weights rc_process.c:777)
        self.hierarchical_levels = 0
        self.qp_scale_compress_strength = 1
        # random-access mode: the mini-GoP pyramid driver (models/ra.py)
        # owns slot/refresh/order-hint decisions and calls _encode_key /
        # _encode_p directly with explicit overrides
        self.ra_mode = False
        # DPB: one stored recon + CDF context per temporal layer slot
        self._dpb = {}          # slot -> (y, u, v) copies
        self._dpb_fc = {}       # slot -> FrameContext
        self._last_slot_by_layer = {}
        # shared loop-filter tx-dim maps + scratch for the level search
        self._lf_y = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self._lf_uv = np.zeros(((self.mi_rows + 1) // 2,
                                (self.mi_cols + 1) // 2), np.uint8)
        self._lf_scratch = np.zeros_like(self._rec_y)
        self.enable_dlf = True
        self._skip_map = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.enable_cdef = True
        self.cdef_search_interval = 8   # re-search on keys / every Nth
        self._cdef_cache = None
        # the frame's CDEF, on the encoder thread and on the deferred
        # filter thread, for the encoder's life
        self._cdef_route, self._cdef_side = self._cdef_routes()
        # deferred in-loop filter threads by recon-buffer id (all-intra
        # pipelining; joined before a ping-pong buffer is rewritten)
        self._pending_filters = {}
        self._dlf_cache = None
        # loop restoration (Wiener; cross-frame param cache — the walk
        # writes lr syntax before this frame's recon exists, so params
        # searched on frame N signal on frame N+1; ref restoration_pick.c)
        self.enable_lr = False
        self._lr_pending = None
        self._lr_dev = None
        # TPL per-SB qindex offsets for the NEXT frame (set by the
        # lookahead driver from models/tpl.tpl_sb_offsets; None = off)
        self.tpl_offsets = None
        # variance-boost AQ (PSY flagship; ref rc_process.c:1516)
        self.enable_variance_boost = False
        self.vb_strength = 2
        self.vb_octile = 6
        # PSY psy-rd: transform-domain AC-energy preservation in RD
        # (ref psy_rd.c:51-123; tune 2/3 semantics, strength 0..6)
        self.psy_rd = 0.0
        # PSY sharpness: diff-based quant rounding bias
        # (ref md_config_process.c:96-117)
        self.sharpness = 0
        # PSY max-32-tx-size (needs the TX_MODE_SELECT split search)
        self.max_tx32 = False
        # Tune 3: SSIM-weighted candidate distortion in the walks
        # (ref enc_mode_config.c:7883 tune_ssim_level -> SSIM_LVL_1)
        self.tune_ssim = False
        # PSY noise normalization: AC coefficient revival in the encode
        # pass (ref full_loop.c:1464; strength 1..4, auto 3 at tune 3)
        self.noise_norm = 0
        # quantizer matrices (spec 5.9.12; PSY default ON with decoupled
        # chroma range — ref enc_settings.c:1084-1088): None = off, else
        # (min_qm, max_qm, min_chroma_qm, max_chroma_qm, tune) and the
        # per-frame levels follow the tune's curve
        # (ref md_config_process.c:175-215)
        self.qm_cfg = None
        # PSY frame-luma-bias: more bits for dark frames
        # (ref rc_process.c:3413)
        self.frame_luma_bias = 0
        # film grain: 0 = off, 1 = estimate from source (PSY adaptive
        # block size), or a FilmGrainParams for an external table
        # (the --fgs-table analog)
        self.film_grain = 0
        self._fg_params = None
        # global motion (TRANSLATION): robust fit over the device HME
        # field (ref global_me.c:126); params coded vs the primary ref's
        # saved params, so mirror the decoder's SavedGmParams per slot
        self.enable_gm = True
        self._slot_gm = [((0, 0),) * 7 for _ in range(8)]
        # per-slot order hints (mirrors the decoder's slot_hints; feeds
        # sign_bias + skip-mode allowance for compound frames)
        self._slot_hint = [0] * 8
        # MFMV temporal MV prediction (spec 7.9/7.20; ref
        # md_config_process.c:505 av1_setup_motion_field): per-slot saved
        # motion fields + use_ref_frame_mvs signalling
        self.enable_mfmv = True
        self._slot_mf = [None] * 8
        self.seq.enable_ref_frame_mvs = True
        # motion-mode search (ref enc_mode_config obmc/warp levels);
        # preset-gated by the API layer
        self.obmc_search = False
        self.warp_search = False
        self.seq.enable_warped_motion = True
        # TX_MODE_SELECT on intra frames: depth-1 tx split search
        # (ref enc_mode_config txt/txs levels)
        self.tx_split_search = False
        # masked compound (wedge/diffwtd) search on RA compound blocks
        self.masked_compound_search = False
        # inter var-tx: depth-1 TX split search on inter blocks
        # (TX_MODE_SELECT, spec 5.11.16; ref tx_search.c inter tx depth)
        self.inter_tx_split = False
        # inter-intra search (smooth II blend; spec 5.11.28)
        self.interintra_search = False
        # CfL chroma candidate in the intra walk (spec 7.11.5)
        self.cfl_search = False
        # filter-intra candidates in the intra walk (spec 7.11.6)
        self.fi_search = False

    # --- lambda system (ref rd_cost.c / rc_process.c:1029-1110) ----------
    @staticmethod
    def _frame_rd_scale(kind: str, qindex: int) -> float:
        """Frame-kind lambda factor: the def_{kf,arf,inter}_rd_multiplier
        ratios of ref rc_process.c:1029-1056, normalized to the inter
        point so the calibrated 0.12*qstep^2 base is preserved. The
        reference additionally applies rd_frame_type_factor (180/128 on
        leaves); measured on the RA harness here that double-counts with
        the TPL r0/beta per-frame q ladder (+0.9% BD), so the leaf
        factor stays at the anchors' 140 (-0.9% BD vs flat lambda)."""
        base = 3.2 + 0.0035 * qindex
        mult = {"key": 3.3, "arf": 3.25,
                "mid": 3.2, "leaf": 3.2}[kind]
        return (mult + 0.0035 * qindex) / base

    # --- sharded device search (multi-chip; SURVEY.md §2.2 P4) -----------
    def make_sharded_decide(self, devices):
        """Shard the decision stage over column shards of a device list,
        the port's form of the reference's mesh: one shard of whole
        superblocks per entry (a list of torch.devices or names, which may
        repeat one device; each entry runs on a CUDA stream of its own).
        Each shard is copied with the halo columns its edge reads need
        (ops/torch_backend.intra_decide_sharded). Returns a function with
        the same output contract as _decide."""
        group = DeviceGroup(devices)

        def decide(yp: np.ndarray):
            bias = int(8 * ac_q(self.qindex, self.bd))
            return self._decide_finish(intra_decide_sharded(
                np.asarray(yp), bias, self.bd, self.min_block, group))

        self._decide = decide
        return decide

    # --- device search stage ---------------------------------------------
    def _decide_dispatch(self, yp: np.ndarray) -> HostCopy:
        """Launch the decision program on the device and start the copy
        of its packed uint8 result home; no host sync."""
        from svt_av1_psy_tpu_torch.utils import trace as _tr
        bias = int(8 * ac_q(self.qindex, self.bd))
        dev = _tr.device_begin("decide_program", self.device)
        out = HostCopy(intra_decide_packed(plane_tensor(yp, self.device),
                                           bias, self.bd, self.min_block))
        _tr.device_end(dev)
        return out

    def _decide_finish(self, out):
        """Maps of one packed decide buffer: a HostCopy from
        _decide_dispatch, or a numpy row of the GoP program's buffer (the
        RA walk, RaDriver._walk_gop)."""
        s64, s32, s16, m64, m32, m16, m8 = intra_decide_unpack(
            np.asarray(out), (self.pah, self.paw))
        # defensive clamp: a corrupted transfer must never reach the C
        # engine as an out-of-range symbol
        maps = {}
        for k, m in ((64, m64), (32, m32), (16, m16), (8, m8)):
            maps[k] = np.where(m <= 12, m, 0).astype(np.uint8)
        return ({64: np.minimum(s64, 1), 32: np.minimum(s32, 1),
                 16: np.minimum(s16, 1)}, maps)

    def _decide(self, yp: np.ndarray):
        """Dense decision stage on device -> split + mode maps (one call)."""
        return self._decide_finish(self._decide_dispatch(yp))

    def prefetch_decide(self, y) -> None:
        """Dispatch the decision stage for the frame the NEXT encode_frame
        call will receive, so it computes on the device while the current
        frame's commit walk runs on the host. The driver must pass the
        SAME array object to the next encode_frame."""
        if "_decide" in self.__dict__:        # sharded override active
            return
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

    def _downscale_y(self, y):
        if not self.superres_denom:
            return y
        from svt_av1_psy_tpu_torch.ops.resize import downscale_horiz
        return downscale_horiz(np.asarray(y), self.width)

    def _take_decide(self, y, yp):
        from svt_av1_psy_tpu_torch.utils import trace as _tr
        pend = getattr(self, "_pref", None)
        if isinstance(pend, dict):
            hit = pend.pop(id(y), None)
            if hit is not None:
                _tr.count("decide.prefetched", 1.0)
                return self._decide_finish(hit[1])
        _tr.count("decide.prefetched", 0.0)
        return self._decide(yp)

    # --- frame -----------------------------------------------------------
    def encode_frame(self, y, u, v) -> EncodedFrame:
        idx = self.frame_index - getattr(self, "_gop_anchor", 0)
        is_p = self.frame_index > 0 and self.gop_size != 1 and \
            (self.gop_size == 0 or idx % max(self.gop_size, 1) != 0)
        if is_p and getattr(self, "enable_scenecut", False) \
                and self._is_scene_cut(y):
            is_p = False
            self._gop_anchor = self.frame_index
            self._lr_pending = None      # cross-cut LR params are stale
        if getattr(self, "enable_scenecut", False):
            self._prev_src_y = np.asarray(y)[::2, ::2].astype(np.int32)
        if is_p:
            return self._encode_p(y, u, v)
        return self._encode_key(y, u, v)

    def _is_scene_cut(self, y) -> bool:
        """Source-diff scene-change detection (the scd_mode=1 analog,
        ref pic_analysis_process.c scene_change_detection): a cut when
        the mean abs source diff vs the previous frame exceeds the
        threshold. Quarter-res sampling; deterministic."""
        prev = getattr(self, "_prev_src_y", None)
        if prev is None:
            return False
        cur = np.asarray(y)[::2, ::2].astype(np.int32)
        mad = float(np.abs(cur - prev).mean()) / (1 << (self.bd - 8))
        return mad > getattr(self, "scenecut_threshold", 20.0)

    def _frame_qm_levels(self, base_q: int):
        """Per-frame QM levels from the frame qindex (ref
        md_config_process.c svt_av1_qm_init; levels of 15 mean flat).
        Returns (qm_y, qm_u, qm_v) or None when QM is off entirely."""
        if self.qm_cfg is None:
            return None
        from svt_av1_psy_tpu_torch.ops.quant import get_qmlevel
        mn, mx, cmn, cmx, tune = self.qm_cfg
        qy = get_qmlevel(base_q, mn, mx, tune)
        qc = get_qmlevel(base_q, cmn, cmx, tune)
        if qy >= 15 and qc >= 15:
            return None
        return (qy, qc, qc)

    def _swap_recon(self):
        self._rec_y, self._ref_y = self._ref_y, self._rec_y
        self._rec_u, self._ref_u = self._ref_u, self._rec_u
        self._rec_v, self._ref_v = self._ref_v, self._rec_v

    # --- recode support (ref rc_process.c:3269 recode loop) ---------------
    def snapshot(self) -> dict:
        """Capture the state encode_frame mutates, so a frame can be
        re-encoded at a different qindex (the recode loop). Plane
        ping-pong buffers are deep-copied; DPB entries/contexts are
        immutable once stored, so shallow dict copies suffice."""
        for th in list(self._pending_filters.values()):
            th.join()
        self._pending_filters.clear()
        return {
            "frame_index": self.frame_index,
            "_gop_anchor": getattr(self, "_gop_anchor", None),
            "_fc_saved": getattr(self, "_fc_saved", None),
            "_dpb_fc": dict(getattr(self, "_dpb_fc", {})),
            "_dpb": dict(getattr(self, "_dpb", {})),
            "_last_slot_by_layer": dict(self._last_slot_by_layer),
            "_lr_pending": self._lr_pending,
            "_cdef_cache": self._cdef_cache,
            "_dlf_cache": self._dlf_cache,
            "_fg_params": self._fg_params,
            "_prev_src_y": getattr(self, "_prev_src_y", None),
            "_slot_gm": list(self._slot_gm),
            "_slot_hint": list(self._slot_hint),
            "_slot_mf": list(self._slot_mf),
            "_rec": (self._rec_y.copy(), self._rec_u.copy(),
                     self._rec_v.copy()),
            "_ref": (self._ref_y.copy(), self._ref_u.copy(),
                     self._ref_v.copy()),
        }

    def restore(self, snap: dict) -> None:
        self.frame_index = snap["frame_index"]
        if snap["_gop_anchor"] is not None:
            self._gop_anchor = snap["_gop_anchor"]
        self._fc_saved = snap["_fc_saved"]
        self._dpb_fc = snap["_dpb_fc"]
        self._dpb = snap["_dpb"]
        self._last_slot_by_layer = snap["_last_slot_by_layer"]
        self._lr_pending = snap["_lr_pending"]
        self._cdef_cache = snap["_cdef_cache"]
        self._dlf_cache = snap["_dlf_cache"]
        self._fg_params = snap["_fg_params"]
        if snap["_prev_src_y"] is not None:
            self._prev_src_y = snap["_prev_src_y"]
        self._slot_gm = snap["_slot_gm"]
        self._slot_hint = snap["_slot_hint"]
        self._slot_mf = snap["_slot_mf"]
        self._rec_y[...], self._rec_u[...], self._rec_v[...] = snap["_rec"]
        self._ref_y[...], self._ref_u[...], self._ref_v[...] = snap["_ref"]
        self._pref = {}         # a prefetched decide is q-independent but
        # single-shot; drop it so the retry re-dispatches cleanly

    def _encode_key(self, y, u, v, order_hint=None) -> EncodedFrame:
        from svt_av1_psy_tpu_torch.utils import trace as _tr
        from svt_av1_psy_tpu_torch.utils.trace import stage as _tstage

        # screen-content key frames (--scm 2 auto-detection at the fast
        # presets; ref pic_analysis_process.c SC detection +
        # palette.c:553 / hash_motion.c:351 searches): a detected key
        # routes through the full-RD intra path with palette + IBC —
        # text/UI content codes orders of magnitude better there — and
        # its recon/contexts feed the fast inter walk's DPB
        if (getattr(self, "scm_auto", False) or
                getattr(self, "screen_content", False)) and \
                not self.superres_denom:
            from svt_av1_psy_tpu_torch.models.intra_encoder import IntraEncoder
            ypad = _pad_to(np.asarray(y), self.pah, self.paw)
            if getattr(self, "screen_content", False) or \
                    IntraEncoder._detect_screen_content(ypad):
                return self._encode_key_sc(y, u, v, order_hint)

        # masked compound changes compound-block syntax: the seq flag
        # must be armed before the stream's sequence header is written
        self.seq.enable_masked_compound = bool(
            getattr(self, "masked_compound_search", False))
        self.seq.enable_interintra_compound = bool(
            getattr(self, "interintra_search", False))
        self.seq.enable_filter_intra = bool(
            getattr(self, "fi_search", False))
        native = self._native
        if self.superres_denom:
            # superres (spec 5.9.8): code the horizontally downscaled
            # frame; recon upscales normatively after CDEF (spec 7.16)
            from svt_av1_psy_tpu_torch.ops.resize import downscale_horiz
            assert self.gop_size == 1 and not self.enable_lr, \
                "superres: all-intra without LR only"
            ds = downscale_horiz(np.asarray(y), self.width)
            u = downscale_horiz(np.asarray(u), (self.width + 1) // 2)
            v = downscale_horiz(np.asarray(v), (self.width + 1) // 2)
            yp = _pad_to(ds, self.pah, self.paw)
        else:
            yp = _pad_to(np.asarray(y), self.pah, self.paw)
        up = _pad_to(np.asarray(u), self.pah // 2, self.paw // 2)
        vp = _pad_to(np.asarray(v), self.pah // 2, self.paw // 2)

        with _tstage("device_search"):
            split, modes = self._take_decide(y, yp)

        # key-frame boost in GOP modes (the kf_boost analog, ref
        # rc_process.c crf_qindex_calc): keys carry the GOP. kf_qindex
        # (absolute, from the RA driver's TPL r0 ladder) wins when set;
        # otherwise the kf_qfrac fallback fraction applies.
        kq = getattr(self, "kf_qindex", None)
        if self.gop_size == 1:
            base_q = self.qindex
        elif kq is not None:
            base_q = int(kq)
        else:
            base_q = max(0, int(self.qindex *
                                getattr(self, "kf_qfrac", 0.75)))
        sbq = None
        dq_res_log2 = -1
        if self.enable_variance_boost:
            from svt_av1_psy_tpu_torch.models.variance_boost import (
                adjust_sb_qindex, sb_8x8_variances)
            # operate on the kf-boosted base (a VB frame must not lose
            # the key-frame boost; this previously re-derived from the
            # unboosted session qindex)
            base_q, dq_res_log2, vb = adjust_sb_qindex(
                base_q, sb_8x8_variances(yp), self.vb_strength,
                self.vb_octile, self.bd)
            sbq = vb.astype(np.int16)
        if self.tpl_offsets is not None:
            from svt_av1_psy_tpu_torch.models.tpl import snap_sb_q
            base = sbq.astype(np.int32) if sbq is not None else \
                np.full(self.tpl_offsets.shape, base_q, np.int32)
            merged, dq_res_log2 = snap_sb_q(base_q,
                                            base + self.tpl_offsets)
            sbq = merged.astype(np.int16)

        # record the frame's actually-coded base q for the library RC
        # feedback loop (api.Encoder._rc_track; TPL/kf ladders override
        # the session qindex, and the controller must model coded q)
        self._last_coded_q = base_q
        self._last_is_key = True

        if self.frame_index == 0:
            self.seq.enable_restoration = bool(self.enable_lr)
        lr_dec = self._take_lr_pending() if self.enable_lr else None

        qm = self._frame_qm_levels(base_q)

        # the walk rewrites this ping-pong buffer: a deferred filter from
        # two frames ago may still be running on it
        with _tr.span("filter_join"):
            self._join_pending_filter(self._rec_y)

        # one engine + CDF context + range coder per tile; tile walks run
        # concurrently in threads (ctypes releases the GIL in C)
        n_tiles_total = self.n_tiles * self.n_tile_rows
        tile_fcs = [FrameContext(base_q) for _ in range(n_tiles_total)]

        rd_scale = self._frame_rd_scale("key", base_q)
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
            if self.max_tx32:
                eng.set_max_tx32(True)
            if getattr(self, "cfl_search", False):
                eng.set_cfl(True)
            if getattr(self, "fi_search", False):
                eng.set_filter_intra(True)
            eng.attach_planes(self._rec_y, self._rec_u, self._rec_v)
            if self.enable_dlf:
                eng.attach_lfmaps(self._lf_y, self._lf_uv)
            eng.attach_skipmap(self._skip_map)
            if self.psy_rd:
                eng.set_psy_rd(self.psy_rd)
            if lr_dec is not None:
                eng.set_lr(lr_dec.lr_type, lr_dec.unit_size, lr_dec.flat,
                           lr_dec.ucols, lr_dec.urows)
            eng.set_src(yp, up, vp)
            if getattr(self, "tx_split_search", False):
                eng.set_tx_select(True)
            ec = native.NativeRangeEncoder()
            with _tr.tile_span(walk, ti):
                eng.encode_intra(ec, tile_fcs[ti], split, modes, sbq=sbq,
                                 dq_res_log2=dq_res_log2, base_q=base_q,
                                 mi_bounds=(r0, r1, c0, c1),
                                 n_cands=self.n_cands)
            return ec.done()

        with _tstage("intra_commit_walk"):
            walk = _tr.walk_begin()
            tile_bytes = self._run_tiles(encode_tile)
            _tr.walk_end(walk)
        tg = self._tile_group(tile_bytes)

        # frame-end context save (refresh slot 0, context_update_tile_id=0)
        self._fc_saved = tile_fcs[0]
        if getattr(self, "ra_mode", False):
            self._dpb_fc = {s: tile_fcs[0] for s in range(8)}
        elif self.hierarchical_levels > 0:
            self._dpb_fc[0] = tile_fcs[0]
            self._last_slot_by_layer = {0: 0}

        if self.film_grain and self._fg_params is None:
            from svt_av1_psy_tpu_torch.bitstream.headers import FilmGrainParams
            if isinstance(self.film_grain, FilmGrainParams):
                self._fg_params = self.film_grain
            else:
                from svt_av1_psy_tpu_torch.models.film_grain import                     estimate_film_grain
                self._fg_params = estimate_film_grain(
                    np.asarray(y), np.asarray(u), np.asarray(v), self.bd)
            self.seq.film_grain_params_present = self._fg_params is not None

        # all-intra pipelining (SURVEY §2.2 P1): a frame that is never a
        # reference may defer its filters' applies
        lf, cdef_st, cdef_damp, deferred_task = self._filter_stage(
            yp, up, vp, base_q, lr_dec,
            may_defer=self.gop_size == 1 and self.hierarchical_levels == 0
            and not getattr(self, "ra_mode", False) and not self.enable_lr)
        if self.hierarchical_levels > 0 or getattr(self, "ra_mode", False):
            # a shown KEY frame refreshes every DPB slot
            rec = (self._rec_y.copy(), self._rec_u.copy(),
                   self._rec_v.copy())
            self._dpb = {s: rec for s in range(8)} \
                if getattr(self, "ra_mode", False) else {0: rec}
        # KEY refreshes all slots with identity gm (spec 7.20)
        self._slot_gm = [((0, 0),) * 7 for _ in range(8)]
        # KEY refreshes every slot with an empty (intra) motion field
        if self.enable_mfmv:
            from svt_av1_psy_tpu_torch.inter.mfmv import save_motion_field
            kh = (self.frame_index if order_hint is None
                  else order_hint) & 0x7F
            mf = save_motion_field([], self.mi_rows, self.mi_cols, kh,
                                   [kh] * 7, [kh] * 7, 7, is_intra=True)
            self._slot_mf = [mf] * 8
        key_hint = (self.frame_index if order_hint is None
                    else order_hint) & 0x7F
        self._slot_hint = [key_hint] * 8

        fr_params = FrameParams(base_q_idx=base_q,
                                order_hint=(self.frame_index
                                            if order_hint is None
                                            else order_hint) & 0x7F,
                                use_superres=bool(self.superres_denom),
                                superres_denom=self.superres_denom or 8,
                                using_qmatrix=qm is not None,
                                qm_y=qm[0] if qm else 15,
                                qm_u=qm[1] if qm else 15,
                                qm_v=qm[2] if qm else 15,
                                tx_mode_select=getattr(
                                    self, "tx_split_search", False),
                                delta_q_present=sbq is not None,
                                delta_q_res_log2=max(dq_res_log2, 0),
                                lr_type=self._lr_coded_type(lr_dec),
                                lr_unit_shift=0, lr_uv_shift=1,
                                tile_cols_log2=self.tile_cols_log2,
                                tile_rows_log2=self.tile_rows_log2,
                                filter_level=(lf[0], lf[1]),
                                filter_level_uv=(lf[2], lf[3]),
                                film_grain=self._fg_params,
                                cdef_damping=cdef_damp,
                                cdef_bits=0,
                                cdef_y_pri=(cdef_st[0],),
                                cdef_y_sec=(cdef_st[1] -
                                            (cdef_st[1] == 4),),
                                cdef_uv_pri=(cdef_st[2],),
                                cdef_uv_sec=(cdef_st[3] -
                                             (cdef_st[3] == 4),))
        payload = key_frame_temporal_unit(
            self.seq, fr_params, tg, with_seq_header=(self.frame_index == 0),
            metadata=(getattr(self, "metadata_key", b"") +
                      getattr(self, "metadata_frame", b"") +
                      self._per_frame_metadata(
                          self.frame_index if order_hint is None
                          else order_hint)))
        self.frame_index += 1
        H, W = self.height, self.width
        cH, cW = (H + 1) // 2, (W + 1) // 2
        if deferred_task is not None:
            self._swap_recon()
            from svt_av1_psy_tpu_torch.utils.trace import next_frame as _tnext
            _tnext()
            return EncodedFrame(payload=payload, resolve=deferred_task)
        if self.superres_denom:
            from svt_av1_psy_tpu_torch.ops.resize import superres_upscale_frame
            rec_y, rec_u, rec_v = superres_upscale_frame(
                (self._rec_y[:H, :self.aw],
                 self._rec_u[:cH, :(self.aw + 1) // 2],
                 self._rec_v[:cH, :(self.aw + 1) // 2]),
                self.up_width, self.superres_denom, self.bd,
                tile_mi_starts=[s * 16 for s in self.tile_col_starts],
                coded_w=W)
        else:
            dt0 = np.uint8 if self.bd == 8 else np.uint16
            rec_y = self._rec_y[:H, :W].astype(dt0)
            rec_u = self._rec_u[:cH, :cW].astype(dt0)
            rec_v = self._rec_v[:cH, :cW].astype(dt0)
        if self.bd == 8 and rec_y.dtype != np.uint8:
            rec_y = rec_y.astype(np.uint8)
            rec_u = rec_u.astype(np.uint8)
            rec_v = rec_v.astype(np.uint8)
        self._swap_recon()
        from svt_av1_psy_tpu_torch.utils.trace import next_frame as _tnext
        _tnext()
        return EncodedFrame(payload=payload, recon_y=rec_y, recon_u=rec_u,
                            recon_v=rec_v)

    # --- P frames (low-delay, single LAST ref) ---------------------------
    def _encode_p(self, y, u, v, ra=None) -> EncodedFrame:
        """Inter frame: device HME + intra decision maps -> native inter
        walk (inter_backend.c). Low-delay (ra=None): reference = previous
        frame's filtered recon (the ping-pong buffer), layer/slot logic
        from the hierarchical LD pyramid. Random access (ra=dict from
        models/ra.py): explicit ref_slot / refresh / order_hint /
        base_q / show — the driver owns the pyramid (ref
        pd_process.c prediction-structure roles)."""
        from svt_av1_psy_tpu_torch.utils import trace as _tr
        from svt_av1_psy_tpu_torch.utils.trace import stage as _tstage

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
                yp_dev = _hme_plane(yp, self.device)

                def ref_dev(plane):
                    # recon planes are uint16 at every bit depth: narrowed
                    # to the source's width, so that K1 sees one pixel type
                    return _hme_plane(plane[:self.pah, :self.paw].astype(
                        yp.dtype, copy=False), self.device)

                hme_dev = HostCopy(_hme_packed(yp_dev, ref_dev(hme_ref)))
                hme2_dev = None
                if ref2_slot is not None:
                    hme2_dev = HostCopy(_hme_packed(
                        yp_dev, ref_dev(self._dpb[ref2_slot][0])))
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
            from svt_av1_psy_tpu_torch.inter.global_motion import (
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
            from svt_av1_psy_tpu_torch.inter.mfmv import setup_motion_field
            from svt_av1_psy_tpu_torch.utils.trace import stage as _ts0

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
            from svt_av1_psy_tpu_torch.models.tpl import snap_sb_q
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
            from svt_av1_psy_tpu_torch.models.inter_tree import inter_split_maps
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
            with _tr.tile_span(walk, ti):
                eng.encode_inter(ec, tile_fcs[ti], split, modes, mv16,
                                 sbq=sbq, dq_res_log2=dq_res_log2,
                                 base_q=base_q,
                                 mi_bounds=(r0, r1, c0, c1),
                                 n_cands=self.n_cands, mv16b=mv16b)
            grid_exp = None
            if self.enable_mfmv and not never_referenced:
                grid_exp = (eng.grid_read(), (r0, r1, c0, c1))
            return ec.done(), grid_exp

        # a deferred leaf filter from two frames ago may still be
        # running on this ping-pong buffer
        with _tr.span("filter_join"):
            self._join_pending_filter(self._rec_y)
        with _tstage("inter_commit_walk"):
            walk = _tr.walk_begin()
            tile_out = self._run_tiles(encode_tile)
            _tr.walk_end(walk)
        tile_bytes = [t[0] for t in tile_out]

        # spec 7.20 motion-field storage for later frames' MFMV (dead
        # when no DPB slot is refreshed — nothing can reference it)
        new_mf = None
        if self.enable_mfmv and not never_referenced:
            from types import SimpleNamespace
            from svt_av1_psy_tpu_torch.inter.mfmv import save_motion_field
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

        tg = self._tile_group(tile_bytes)
        # the pyramid's leaves defer their filters' applies as all-intra
        # frames do (SURVEY §2.2 P1)
        lf, cdef_st, cdef_damp, deferred_task = self._filter_stage(
            yp, up, vp, base_q, lr_dec, may_defer=never_referenced)

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
        from svt_av1_psy_tpu_torch.utils.trace import next_frame as _tnext
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


    def _encode_key_sc(self, y, u, v, order_hint=None) -> EncodedFrame:
        """Screen-content KEY frame through the full-RD intra path
        (palette + intra-block-copy searches, models/intra_encoder.py;
        ref palette.c:553 k-means + hash_motion.c:351 IBC hash search).
        The fast path owns the stream: the slow encoder shares this
        stream's SequenceParams, and its recon + end-of-frame CDF
        context bridge into the fast DPB so the inter walk references
        the SC key exactly like a fast-coded one."""
        from svt_av1_psy_tpu_torch.models.intra_encoder import IntraEncoder
        from svt_av1_psy_tpu_torch.utils.trace import stage as _tstage

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
                          bd=self.bd, search_top_k=2,
                          device=self.device)
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
            from svt_av1_psy_tpu_torch.inter.mfmv import save_motion_field
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
        from svt_av1_psy_tpu_torch.utils.trace import next_frame as _tnext
        _tnext()
        return f

    def _per_frame_metadata(self, display_idx: int) -> bytes:
        """Per-display-frame metadata OBUs (the DoVi-RPU / HDR10+ attach
        model of ref app_process_cmd.c:463-495 retrieve_dovi_rpu_for
        _frame: one T.35 payload per picture). metadata_per_frame maps
        TRUE display index -> raw OBU bytes built by
        bitstream/metadata.build_metadata_payload."""
        m = getattr(self, "metadata_per_frame", None)
        if not m:
            return b""
        return m.get(display_idx, b"")

    @staticmethod
    def _lr_coded_type(lr_dec):
        """Frame-header coded lr type per plane (spec remap_lr_type:
        NONE=0 SWITCHABLE=1 WIENER=2 SGRPROJ=3 as coded values)."""
        if lr_dec is None:
            return (0, 0, 0)
        coded = {0: 0, 1: 2, 2: 3, 3: 1}
        return tuple(coded[t] for t in lr_dec.lr_type)

    def _take_lr_pending(self):
        """Resolve the pending LR decision: the device search for this
        frame's signalling was dispatched at the END of the previous
        frame (async) and is fetched here, right before the walk needs
        it (SURVEY §2.2 P1 overlap)."""
        p = self._lr_pending
        if isinstance(p, tuple) and p and p[0] == "dev":
            _, tok, rdm = p
            p = self._lr_dev.finish(tok, rdm)
            self._lr_pending = p
        return p

    def _join_pending_filter(self, buf) -> None:
        """Join the deferred filter still running on `buf` (called before
        the walk reuses a ping-pong buffer, and before any state copy)."""
        th = self._pending_filters.pop(id(buf), None)
        if th is not None:
            th.join()

    def close(self) -> None:
        """Drain every deferred in-loop-filter thread (the deinit join of
        ref enc_handle.c:2748 — the reference joins all 16 process
        threads before teardown). Without this, daemon filter threads
        die mid-write at interpreter shutdown (stray tracebacks today;
        corrupted recon the day a caller reads it late)."""
        for th in list(self._pending_filters.values()):
            th.join()
        self._pending_filters.clear()
