"""The post-walk tail of FastIntraEncoder's two walks, the port's own.

Both walks (_encode_key, _encode_p) hand their tiles to one runner
(_run_tiles), their tile bytes to one tile-group assembly (_tile_group)
and their recon to one in-loop filter stage (_filter_stage): DLF, CDEF
and LR, each searching its parameters on the frames that search (_cached)
and applying the cached ones on the rest, inline or, for a frame that is
never a reference, on a background thread (_deferred_filter_task). The
frame's CDEF runs through a route chosen once per encoder from its device
(_cdef_routes): the C library's cdef_run on the CPU (NativeCdef), the
card on CUDA (CardCdef, kernels/cdef.py); each frame binds a route to its
own planes (frame()), so the route itself holds no frame's state.

FrameTail is a mixin of FastIntraEncoder: its methods read the encoder's
geometry, switches, recon planes and filter caches. The JAX package's
encoder has the same tail copied into each walk; the port is held to it
by whole encodes (tests/test_torch_encode.py, tests/test_torch_cdef.py),
not by its source.
"""

from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from svt_av1_psy_tpu_torch.kernels.cdef import CardCdef, NativeCdef
from svt_av1_psy_tpu_torch.models.lr_search import DeviceLrSearch
from svt_av1_psy_tpu_torch.ops.quant import ac_q
from svt_av1_psy_tpu_torch.ops.restoration import apply_lr_frame
from svt_av1_psy_tpu_torch.utils import trace as _tr


class FrameTail:
    """The tile runner, the tile-group assembly and the in-loop filter
    stage of FastIntraEncoder (a mixin over its state)."""

    def _run_tiles(self, encode_tile) -> list:
        """encode_tile(ti) over every tile, the outputs in tile order: one
        thread per tile (ctypes releases the GIL in the C walk), or in
        sequence where there is one tile or SVT_TILE_SEQ is set."""
        n = self.n_tiles * self.n_tile_rows
        if n == 1 or os.environ.get("SVT_TILE_SEQ"):
            return [encode_tile(ti) for ti in range(n)]
        with ThreadPoolExecutor(max_workers=n) as tp:
            return list(tp.map(encode_tile, range(n)))

    @staticmethod
    def _tile_group(tile_bytes) -> bytes:
        """The tile group of an OBU_FRAME (spec 5.11.1): a lone tile as it
        is; several after tile_start_and_end_present_flag = 0 (one aligned
        zero bit), each but the last with its size field."""
        if len(tile_bytes) == 1:
            return tile_bytes[0]
        parts = [b"\x00"]
        for tb in tile_bytes[:-1]:
            parts += [(len(tb) - 1).to_bytes(4, "little"), tb]
        parts.append(tile_bytes[-1])
        return b"".join(parts)

    def _cdef_routes(self):
        """The frame's CDEF routes on the encoder thread and on the deferred
        filter threads: the C library on the CPU (one NativeCdef for both);
        on a CUDA device one CardCdef each (kernels/cdef.py), the filter
        threads' on a stream of their own, since they run at once."""
        if self.device.type != "cuda":
            route = NativeCdef(self._native)
            return route, route
        return (CardCdef(self.device),
                CardCdef(self.device, torch.cuda.Stream(self.device)))

    def _cached(self, cache):
        """cache (the DLF levels or the CDEF strengths) where this frame
        reuses it; None where the frame searches again: with nothing cached,
        and on every cdef_search_interval-th frame."""
        if cache is None or \
                self.frame_index % max(self.cdef_search_interval, 1) == 0:
            return None
        return cache

    def _filter_stage(self, yp, up, vp, base_q, lr_dec, may_defer):
        """The frame's in-loop filters after its walk, on the recon: DLF,
        CDEF, then LR at lr_dec's parameters (_filter_planes). A frame that
        may_defer (its recon is never a reference), with DLF and CDEF on,
        both cached (_cached) and no superres, moves the applies (not the
        searches: the header signals the cached parameters) to a background
        thread that overlaps the next frame's walk; LR goes with them, and
        the search for the next frame's LR is not dispatched. Returns the
        header's DLF levels, CDEF strengths and damping, and the deferred
        frame's resolve() (None where the filters ran here)."""
        levels = self._cached(self._dlf_cache)
        cdef_st = self._cached(self._cdef_cache)
        if self.enable_cdef:
            _tr.count("cdef.device", float(self.device.type == "cuda"))
        resolve = None
        if may_defer and self.enable_dlf and self.enable_cdef and \
                levels is not None and cdef_st is not None and \
                not self.superres_denom:
            resolve = self._deferred_filter_task(
                (yp, up, vp), base_q, levels, cdef_st, lr_dec)
        else:
            levels, cdef_st = self._filter_planes(
                (self._rec_y, self._rec_u, self._rec_v),
                (self._lf_y, self._lf_uv, self._lf_uv), self._skip_map,
                (yp, up, vp), base_q, levels, cdef_st, lr_dec,
                self._cdef_route, inline=True)
        ly, lu, lv = levels if self.enable_dlf else (0, 0, 0)
        if not self.enable_cdef:
            return (ly, ly, lu, lv), (0, 0, 0, 0), 3, resolve
        return (ly, ly, lu, lv), cdef_st, 3 + (base_q >> 6), resolve

    def _plane_dims(self):
        """(is_luma, mi rows, mi cols, display width, height) of y, u, v."""
        rows, cols = self.mi_rows, self.mi_cols
        chroma = (False, (rows + 1) // 2, (cols + 1) // 2,
                  (self.width + 1) // 2, (self.height + 1) // 2)
        return ((True, rows, cols, self.width, self.height), chroma, chroma)

    def _filter_planes(self, planes, maps, skip, pixels, base_q, levels,
                       cdef_st, lr_dec, route, inline):
        """The in-loop filters on planes (y, u, v), in place, in the
        normative order: DLF at levels (y, u, v) over the planes' tx-dim
        maps, CDEF at cdef_st over the skip map through route, bound to
        this frame (route.frame), and LR at lr_dec's parameters (None: not
        applied) from the post-CDEF planes and a pre-CDEF copy. pixels: the
        frame's sources in their pixel width, as the card and the LR search
        take them (the C's DLF and CDEF widen them). On the encoder thread
        (inline) each filter is a trace stage (dlf, cdef, loop_restoration),
        a filter whose parameters are None searches them first, and the
        search for the next frame's LR is dispatched on the post-CDEF
        planes; the deferred filter thread passes every parameter. Returns
        (levels, cdef_st)."""
        stage = _tr.stage if inline else \
            (lambda name: contextlib.nullcontext())
        dims = self._plane_dims()
        if self.enable_dlf:
            with stage("dlf"):
                if levels is None:
                    levels = self._search_dlf(planes, maps, pixels, base_q)
                for plane, lf, lv, (luma, r, c, w, h) in zip(planes, maps,
                                                             levels, dims):
                    if lv:
                        self._native.dlf_apply(plane, lf, luma, lv, lv, 0,
                                               self.bd, r, c, w, h)
        pre_cdef = [p.copy() for p in planes] if lr_dec is not None else None
        if self.enable_cdef:
            with stage("cdef"):
                cdef = route.frame(planes, pixels, skip, self.width,
                                   self.height, self.bd, 3 + (base_q >> 6))
                if cdef_st is None:
                    cdef_st = self._search_cdef(cdef)
                if any(cdef_st):
                    cdef(cdef_st, apply=True)
        if self.enable_lr:
            with stage("loop_restoration"):
                if inline:
                    self._lr_search(planes, pixels, base_q)
                if lr_dec is not None:
                    apply_lr_frame(list(planes), pre_cdef,
                                   [d[3:] for d in dims], lr_dec.lr_type,
                                   lr_dec.unit_size, lr_dec.units,
                                   bd=self.bd)
        return levels, cdef_st

    def _search_dlf(self, planes, maps, pixels, base_q):
        """The frame's DLF levels (y, u, v), cached: per plane the first
        level of least SSE on a ladder around a q-derived guess (ref
        av1_pick_filter_level's bisection; dlf_process.c kernel); chroma
        levels only where luma filters (they are coded only then)."""
        guess = max(0, base_q // 12)
        lad_y = sorted({0, max(0, guess // 2), guess, guess + guess // 2,
                        min(63, 2 * guess)})
        lad_c = sorted({0, guess // 2, guess})
        srcs = [np.ascontiguousarray(p, np.uint16) for p in pixels]
        levels = []
        with _tr.span("dlf_search"):
            for plane, src, lf, (luma, r, c, w, h) in zip(
                    planes, srcs, maps, self._plane_dims()):
                best, best_sse = 0, None
                for lv in lad_y if luma else lad_c:
                    sse = self._native.dlf_try_level(
                        plane, src, self._lf_scratch, lf, luma, lv, 0,
                        self.bd, r, c, w, h)
                    if best_sse is None or sse < best_sse:
                        best, best_sse = lv, sse
                levels.append(best)
        self._dlf_cache = tuple(levels) if levels[0] else (0, 0, 0)
        return self._dlf_cache

    def _search_cdef(self, cdef):
        """The frame's CDEF strengths (y_pri, y_sec, uv_pri, uv_sec),
        cached: a frame-level ladder on the subsampled SSEs that cdef, the
        route bound to this frame, gives (ref enc_cdef.c search at
        cdef_bits=0 scope), each rung taken where its cost is strictly
        lower."""
        def sse(st):
            return cdef(st, apply=False, sample=4)

        with _tr.span("cdef_search"):
            base_y, base_c = sse((0, 0, 0, 0))
            best_y, cost_y = 0, base_y
            for pri in (1, 2, 4, 7, 12):
                cy, _ = sse((pri, 0, 0, 0))
                if cy < cost_y:
                    best_y, cost_y = pri, cy
            best_ys = 0
            for sec in (1, 2):
                cy, _ = sse((best_y, sec, 0, 0))
                if cy < cost_y:
                    best_ys, cost_y = sec, cy
            best_c, cost_c = 0, base_c
            for pri in (1, 2, 4):
                _, cc2 = sse((0, 0, pri, 0))
                if cc2 < cost_c:
                    best_c, cost_c = pri, cc2
        self._cdef_cache = (best_y, best_ys, best_c, 0)
        return self._cdef_cache

    def _lr_search(self, planes, pixels, base_q):
        """Dispatch the device search for the next frame's LR parameters on
        the post-CDEF, pre-LR planes (the cross-frame cache: the walk
        writes LR syntax before the frame's recon exists; ref
        rest_process.c / restoration_pick.c:1471; the solve and the
        filtered-SSE math run on the device, models/lr_search.py
        DeviceLrSearch). _take_lr_pending fetches it."""
        qstep = ac_q(base_q, self.bd) / 8.0
        rdmult = 0.12 * qstep * qstep * getattr(self, "_cur_rd_scale", 1.0)
        if self._lr_dev is None:
            self._lr_dev = DeviceLrSearch(
                [d[3:] for d in self._plane_dims()], self.bd,
                device=self.device)
        self._lr_pending = ("dev", self._lr_dev.dispatch(pixels,
                                                         list(planes)),
                            rdmult)

    def _deferred_filter_task(self, pixels, base_q, levels, cdef_st, lr_dec):
        """Start _filter_planes with the cached parameters, and the recon
        crop, on a background thread over THIS frame's recon buffers (never
        a reference: all-intra frames, or pyramid leaves with refresh == 0).
        Returns a resolve() that joins and yields the cropped recon."""
        planes = (self._rec_y, self._rec_u, self._rec_v)
        lf_uv = self._lf_uv.copy()      # the next walk rewrites the maps
        maps = (self._lf_y.copy(), lf_uv, lf_uv)
        skip = self._skip_map.copy()
        H, W = self.height, self.width
        cH, cW = (H + 1) // 2, (W + 1) // 2
        dt = np.uint8 if self.bd == 8 else np.uint16
        out = {}
        token = _tr.handoff()

        def task():
            with _tr.span("leaf_filter", token):
                self._filter_planes(planes, maps, skip, pixels, base_q,
                                    levels, cdef_st, lr_dec,
                                    self._cdef_side, inline=False)
                ry, ru, rv = planes
                out["rec"] = (ry[:H, :W].astype(dt), ru[:cH, :cW].astype(dt),
                              rv[:cH, :cW].astype(dt))

        th = threading.Thread(target=task, daemon=True)
        th.start()
        self._pending_filters[id(planes[0])] = th

        def resolve():
            th.join()
            return out["rec"]

        return resolve
