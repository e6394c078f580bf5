"""Random-access mini-GoP pyramid driver (fast path).

Implements the reference's hierarchical random-access prediction
structure (ref Source/Lib/Codec/pd_process.c picture-decision GoP
typing, pred_structure.c pyramid layers, packetization_process.c
decode-order packet emission) the TPU-native way: the pyramid is pure
host-side control flow over the existing single-ref device-search +
native-commit inter path — each frame picks ONE reference frame-level
(nearest coded past or future anchor, chosen by subsampled SAD), hidden
anchors are emitted with show_frame=0 and displayed later through
show_existing_frame TUs.

Decode-order emission for a 4-GoP (base b, anchors hidden `h`,
leaves shown `s`):   [b+4 h] [b+2 h] [b+1 s] [SE b+2] [b+3 s] [SE b+4]
which displays b+1, b+2, b+3, b+4 in order — the standard AV1 RA
packing.

DPB slot management: base + the recursion stack of live anchors
(max pyramid depth + 1 slots of the 8); slots are allocated from a
free pool and released when both half-GoPs under an anchor are done.

The port's copy of svt_av1_psy_tpu/models/ra.py, with its device search
in PyTorch on ``enc.device``. _dispatch_gop sends the planes to that
device, runs the port's gop_search / gop_search_tf and queues the copy of
their packed result into pinned memory (a HostCopy) in place of a fetch
thread; _walk_gop takes the unpackers from the port; _tf_device_dispatch
runs the key frame's temporal filter there. The multi-device GoP meshes
(gop_meshes) are device groups, each a list of devices with a stream per
entry; _sharded_gop_search runs a GoP's program on its group,
width-sharded when the group has several entries. Nothing is warmed up
ahead of the first GoP (the reference's _warmup_async compiles its jax
programs; the port's are eager PyTorch). Everything else is the
reference's code; tests/test_torch_standalone.py lists what differs and
guards the rest against drift.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from svt_av1_psy_tpu_torch.ops.torch_backend import (gop_search,
                                                     gop_search_sharded,
                                                     gop_search_tf,
                                                     plane_tensor,
                                                     tf_filter_device)
from svt_av1_psy_tpu_torch.utils.device import DeviceGroup, HostCopy


@dataclass
class RaPacket:
    """One temporal unit in decode order.

    display_idx: display position this TU *shows* (-1 for hidden coded
    frames); recon: clipped recon planes of the shown frame (None for
    hidden TUs). recon may be a _LazyRecon — tuple-like, but resolving
    a deferred in-loop-filter thread on first access.
    qindex / is_key: the coded base qindex and frame type of the coded
    frame inside this TU (-1 for show_existing TUs that code nothing) —
    the library RC feedback (api.Encoder._rc_track) models coded q, not
    the session base q."""
    payload: bytes
    display_idx: int
    recon: tuple | None
    qindex: int = -1
    is_key: bool = False


class _LazyRecon:
    """Tuple-like view over an EncodedFrame's recon planes: accessing
    any element joins the frame's deferred filter task (leaf-frame
    filter deferral, fast_intra._deferred_filter_task)."""

    __slots__ = ("_f",)

    def __init__(self, f):
        self._f = f

    def _t(self):
        return (self._f.recon_y, self._f.recon_u, self._f.recon_v)

    def __getitem__(self, i):
        return self._t()[i]

    def __iter__(self):
        return iter(self._t())

    def __len__(self):
        return 3


_SHARDED_GOP_CACHE = {}


def _sharded_gop_search(group):
    """The GoP program of one entry of gop_meshes, a device group (a list
    of devices, cached per group): a function of (planes (F, H, W) numpy,
    edges, bias, bd, min_block) that queues gop_search on the group's
    streams, width-sharded when the group has several entries
    (ops/torch_backend.gop_search_sharded), and returns the host copy of
    its packed result."""
    key = (id(group), tuple(str(d) for d in group))
    hit = _SHARDED_GOP_CACHE.get(key)
    if hit is None:
        hit = _SHARDED_GOP_CACHE[key] = DeviceGroup(group)
    return functools.partial(gop_search_sharded, group=hit)


class RaDriver:
    """Buffers a mini-GoP of source frames and encodes it out of order.

    push() returns the finished packets whenever a full GoP (or a forced
    key boundary) completes; flush() closes the tail GoP.
    """

    def __init__(self, enc, gop_levels: int = 4, keyint: int = 0,
                 tf_strength: int = 0, dynamic_gop: bool = False,
                 tf_adaptive: bool = False):
        enc.ra_mode = True
        self.enc = enc
        self.levels = max(1, min(gop_levels, 5))
        self.M = 1 << self.levels
        self.keyint = keyint          # key every N displayed frames (0 =
                                      # first frame only)
        self.tf_strength = tf_strength
        # adaptive TF (the reference's --enable-tf 2, ref
        # Parameters.md:281 / temporal_filtering.c adaptive gate): skip
        # the ARF filter on high-motion windows where the full-pel
        # alignment would blend mismatched content
        self.tf_adaptive = tf_adaptive
        self.tf_adaptive_threshold = 10.0   # mean |diff|/px, 8-bit
        # dynamic mini-GoP (ref Docs/Appendix-Dynamic-Mini-GoP +
        # pd_process.c GoP typing): close the group early at a
        # power-of-two size when the buffered motion is high — long
        # pyramids only pay off when anchors predict the leaves
        self.dynamic_gop = dynamic_gop
        self.dyn_threshold = 12.0     # mean |diff|/px (8-bit units)
        self._mads = []
        self._dyn_prev = None
        self._buf = []                # [(display_idx, (y, u, v))]
        self._next_display = 0
        self._base_slot = 0
        self._base_display = -1
        self._recon_by_display = {}
        # one-GoP-deep pipeline (SURVEY §2.2 P1/P2): when a mini-GoP
        # completes, its device search (TF + decide maps + edge HMEs) is
        # DISPATCHED asynchronously and the GoP is parked; its host
        # commit walks run when the NEXT GoP completes — so the device
        # computes GoP N+1's search while the host walks GoP N. The
        # open-loop search runs on SOURCE planes (the reference's ME
        # process also searches sources, ref me_process.c:97), which is
        # what makes the dispatch independent of the pending walks.
        self._pending = None          # parked GopTask dict
        self._key_pending = None      # stashed key frame (deferred encode)
        # dispatch-time base frame (display + padded source luma): the
        # last dispatched GoP's ARF, or the last key — the edge reference
        # for the NEXT GoP's open-loop search
        self._disp_base_display = -1
        self._disp_base_src = None

    # -- q ladder (ref rc_process.c RA qindex offsets + PSY
    #    qp-scale-compress weights) ---------------------------------------
    #
    # Measured on the synthetic BD clips (33f cif, 4 CRFs, vs the
    # reference's p8 RA): a flat ladder + small ARF boost gives +14.6%
    # BD-rate while steeper per-layer spreads lose 20-90% — without
    # TPL-style boost statistics, pushing leaf q up quantizes away
    # exactly the residual detail the anchors cannot predict. The
    # layer_spread knob re-enables a spread (scaled by PSY
    # qp-scale-compress); tpl_strength > 0 replaces the whole ladder
    # with the measured r0/beta per-frame q from the GoP dependency
    # flow (models/tpl.tpl_gop_q; ref rc_process.c:873).
    layer_spread = 0.0
    tpl_strength = 0.0

    def _layer_q(self, depth: int) -> int:
        q = self.enc.qindex
        if depth == 0:                # ARF: boosted, everything refs it
            return max(0, q - q // 16)
        if not self.layer_spread:
            return q
        qsc = 1.0 / (1.0 + 0.5 * self.enc.qp_scale_compress_strength)
        return int(np.clip(round(q * (1 + self.layer_spread * depth *
                                      qsc)), 0, 255))

    def _is_key(self, d: int) -> bool:
        if d == 0:
            return True
        return self.keyint > 0 and d % self.keyint == 0

    # -- public api --------------------------------------------------------
    def push(self, y, u, v) -> list[RaPacket]:
        d = self._next_display
        self._next_display += 1
        out = []
        # scene-change detection in picture decision (ref
        # pic_analysis_process.c scene_change_detection feeding
        # pd_process GoP typing): a cut closes the pending mini-GoP at
        # its buffered tail and re-keys on the cut frame
        cut = getattr(self.enc, "enable_scenecut", False) and \
            self.enc._is_scene_cut(y)
        if getattr(self.enc, "enable_scenecut", False):
            self.enc._prev_src_y = np.asarray(y)[::2, ::2].astype(np.int32)
        if self._is_key(d) or cut:
            # drain the pipeline: dispatch the buffered tail FIRST so its
            # device search computes under the pending GoP's host walks,
            # then walk both in order, then stash the key. The key's
            # ENCODE is deferred into the walk of the mini-GoP that
            # follows it, so its q can come from the same TPL r0 model
            # that ladders the GoP (the lookahead-driven kf_boost of
            # ref rc_process.c crf_qindex_calc; the dispenser sees the
            # frames the key's quality will propagate into).
            tail = self._dispatch_gop()
            out.extend(self._emit_pending_key())
            out.extend(self._finish_pending())
            if tail is not None:
                out.extend(self._walk_gop(tail))
            from svt_av1_psy_tpu_torch.models.intra_encoder import _pad_to
            dtype = np.uint8 if getattr(self.enc, "bd", 8) == 8 \
                else np.uint16
            src = _pad_to(np.asarray(y), self.enc.pah,
                          self.enc.paw).astype(dtype)
            self._key_pending = (d, (y, u, v), src)
            self._disp_base_display = d
            self._disp_base_src = src
            return out
        self._buf.append((d, (y, u, v)))
        # pre-dispatch the pending KEY's temporal filter as soon as its
        # forward window (the next 2 sources) is buffered: dispatched at
        # walk time it queues BEHIND the next GoP's search on the device
        # and its fetch sits on the critical path (measured ~7-10 s)
        if (self.tf_strength and self._key_pending is not None and
                len(self._key_pending) == 3 and len(self._buf) >= 2):
            kd, kfuv, ksrc = self._key_pending
            win = [self._buf[0][1], self._buf[1][1], kfuv]
            tok = self._tf_device_dispatch(win)
            self._key_pending = (kd, kfuv, ksrc, tok)
        close = len(self._buf) >= self.M
        if self.dynamic_gop and not close:
            cur = np.asarray(y)[::4, ::4].astype(np.int32)
            bd_sh = getattr(self.enc, "bd", 8) - 8
            if self._dyn_prev is not None:
                self._mads.append(
                    float(np.abs(cur - self._dyn_prev).mean()) /
                    (1 << bd_sh))
            self._dyn_prev = cur
            n = len(self._buf)
            if n < self.M and n in (2, 4, 8, 16) and self._mads:
                window = self._mads[-n:]
                if sum(window) / len(window) > self.dyn_threshold:
                    close = True
        if close:
            # pipeline step: dispatch this GoP's device search (async),
            # then run the PREVIOUS GoP's host walks while the device
            # computes. A stashed key rides the new task: it encodes at
            # the top of that task's walk, with its q from the GoP's
            # TPL r0 ladder.
            task = self._dispatch_gop()
            out.extend(self._finish_pending())
            self._pending = task
        return out

    def flush(self) -> list[RaPacket]:
        # same dispatch-before-walk ordering as the key-boundary drain
        tail = self._dispatch_gop()
        out = self._finish_pending()
        if tail is not None:
            out.extend(self._walk_gop(tail))
        out.extend(self._emit_pending_key())
        return out

    def close(self) -> None:
        """Join the background warm-up thread and the encoder's deferred
        filter threads (the deinit drain of ref enc_handle.c:2748).
        Idempotent; safe before or after flush()."""
        th = getattr(self, "_warm_thread", None)
        if th is not None:
            th.join()
            self._warm_thread = None
        close = getattr(self.enc, "close", None)
        if close is not None:
            close()

    def _emit_pending_key(self) -> list[RaPacket]:
        """Fallback for a stashed key with NO mini-GoP after it (flush
        right after the key, or back-to-back keys): encode at the
        default kf fraction — there is no dependency information."""
        if self._key_pending is None:
            return []
        d, fuv = self._key_pending[0], self._key_pending[1]
        tok = self._key_pending[3] if len(self._key_pending) > 3 else None
        self._key_pending = None
        self.enc.kf_qindex = None
        return [self._encode_base_key(d, fuv, tf_tok=tok)]

    # -- internals ---------------------------------------------------------
    def _encode_base_key(self, d: int, fuv, future: dict | None = None,
                         tf_tok=None) -> RaPacket:
        y, u, v = fuv
        if self.tf_strength and tf_tok is not None:
            # pre-dispatched at push time (the forward-window frames
            # arrived long before the walk): only the fetch remains
            from svt_av1_psy_tpu_torch.utils.trace import stage as _tstage
            with _tstage("temporal_filter"):
                y, u, v = self._tf_device_fetch(tf_tok)
        elif self.tf_strength and future:
            # key-frame alt-ref filter over FUTURE sources (the
            # reference filters I-frames with a forward window, ref
            # temporal_filtering.c key-frame path) — on device, one
            # fused call (the host block-loop filter costs seconds per
            # 1080p key)
            win = [future[dd] for dd in sorted(future) if dd > d][:2] \
                + [(y, u, v)]
            if len(win) > 1:
                from svt_av1_psy_tpu_torch.utils.trace import stage as _tstage
                with _tstage("temporal_filter"):
                    y, u, v = self._tf_device(win)
        f = self.enc._encode_key(y, u, v, order_hint=d)
        self._base_slot = 0
        self._base_display = d
        # NOTE: _disp_base_* is set at key STASH time (push), not here —
        # by emit time the next GoP's dispatch has already advanced it
        self._recon_by_display[d] = (f.recon_y, f.recon_u, f.recon_v)
        return RaPacket(f.payload, d, (f.recon_y, f.recon_u, f.recon_v),
                        qindex=getattr(self.enc, '_last_coded_q', -1),
                        is_key=True)

    def _tf_device(self, win):
        """Device temporal filter of win[-1] (center LAST) against the
        other window frames; returns cropped (y, u, v) uint arrays."""
        return self._tf_device_fetch(self._tf_device_dispatch(win))

    def _tf_device_fetch(self, tok):
        (fy, fu, fv), (H, W) = tok
        dtype = np.uint8 if getattr(self.enc, "bd", 8) == 8 else np.uint16
        ch, cw = (H + 1) // 2, (W + 1) // 2
        return (np.asarray(fy)[:H, :W].astype(dtype),
                np.asarray(fu)[:ch, :cw].astype(dtype),
                np.asarray(fv)[:ch, :cw].astype(dtype))

    def _tf_device_dispatch(self, win):
        """Launch the key frame's temporal filter of win[-1] (center LAST)
        against the other window frames; returns the token that the
        reference's _tf_device_fetch crops and casts."""
        enc = self.enc
        H, W = np.asarray(win[-1][0]).shape
        ph, pw = enc.pah, enc.paw
        chf = (ph // 2, pw // 2)
        dtype = np.uint8 if getattr(enc, "bd", 8) == 8 else np.uint16

        def pad(p, hh, ww):
            p = np.asarray(p)
            return np.pad(p, ((0, hh - p.shape[0]), (0, ww - p.shape[1])),
                          mode="edge").astype(dtype)

        dev = enc.device
        planes = [plane_tensor(np.stack([pad(f[k], *shape) for f in win]),
                               dev)
                  for k, shape in ((0, (ph, pw)), (1, chf), (2, chf))]
        out = tf_filter_device(*planes, torch.ones(len(win)),
                               float(self.tf_strength), enc.bd)
        return tuple(HostCopy(a) for a in out), (H, W)

    def _free_slots(self, in_use):
        return [s for s in range(8) if s not in in_use]

    def _encode_inter(self, d, fuv, ref_slot, refresh, show, depth,
                      ref_slot2=None):
        tq = self._tpl_q.get(d) if getattr(self, "_tpl_q", None) else None
        ra = {"ref_slot": ref_slot, "refresh": refresh,
              "order_hint": d, "show": show, "layer": depth,
              "base_q": self._layer_q(depth) if tq is None else tq,
              "ref_slot2": ref_slot2,
              # MRP GOLDEN = the mini-GoP base anchor's slot (disabled
              # per frame when it coincides with LAST/ALTREF or no
              # refsel map was produced)
              "ref_slot3": getattr(self, "_gop_base_slot", None)}
        pre = getattr(self, "_pre_by_d", None)
        if pre:
            ra["pre"] = pre.pop(d, None)
        filt = getattr(self, "_filtered_src", None)
        if filt and d in filt:
            # anchor was temporal-filtered on device; decide/HME ran on
            # the filtered plane, so the walk codes the same source
            fuv = filt[d][0]
        y, u, v = fuv
        f = self.enc._encode_p(y, u, v, ra=ra)
        self._recon_by_display[d] = _LazyRecon(f)
        return f

    # -- GoP-batched device search (pipelined) -----------------------------
    def _dispatch_gop(self) -> dict | None:
        """Phase A of a mini-GoP, as the reference's: consume the source
        buffer and launch the whole GoP's device work (the port's
        gop_search / gop_search_tf on self.enc.device), then queue the
        copy of its packed result into pinned host memory behind it. No
        thread and no host sync: on CUDA the launches return before the
        device is done, whatever is still queued runs under the previous
        GoP's host walks, and np.asarray(task["out"]) in _walk_gop waits
        for the copy's event alone."""
        buf, self._buf = self._buf, []
        self._mads = []
        if not buf:
            return None
        from svt_av1_psy_tpu_torch.models.intra_encoder import _pad_to
        from svt_av1_psy_tpu_torch.ops.quant import ac_q
        from svt_av1_psy_tpu_torch.utils.trace import stage as _tstage

        enc = self.enc
        pah, paw = enc.pah, enc.paw
        frames = dict(buf)            # display -> (y,u,v)
        b = self._disp_base_display
        arf_d = buf[-1][0]
        if len(buf) == 1:
            plan = [(arf_d, b, b, 1)]
        else:
            plan = self._tpl_plan(b, arf_d)
        ds = [b] + [p[0] for p in plan]
        idx = {d: i for i, d in enumerate(ds)}
        fmax = self.M + 1
        emax = 3 * self.M       # <= 3 prediction edges per frame (MRP)
        dtype = np.uint8 if enc.bd == 8 else np.uint16
        planes = np.zeros((fmax, pah, paw), dtype)
        if self._disp_base_src is not None:
            planes[0] = self._disp_base_src
        padded = {}
        for d, *_ in plan:
            p = _pad_to(np.asarray(frames[d][0]), pah, paw).astype(dtype)
            planes[idx[d]] = p
            padded[d] = p
        edge_keys = []
        edges = np.zeros((emax, 2), np.int32)
        for d, lo, hi, *_ in plan:
            refs = [lo] if hi == lo else [lo, hi]
            if b not in refs:
                # MRP GOLDEN edge: every frame also searches the GoP
                # base (ref pd_process.c ref lists / GOLDEN role)
                refs.append(b)
            for r in refs:
                edges[len(edge_keys)] = (idx[d], idx[r])
                edge_keys.append((d, r))
        bias = np.int32(8 * ac_q(enc.qindex, enc.bd))
        tf_on = bool(self.tf_strength) and len(buf) > 1
        if tf_on and self.tf_adaptive:
            # adaptive gate: quarter-res MAD of the TF window
            bd_sh = getattr(enc, "bd", 8) - 8
            wfr = [np.asarray(frames[dd][0])[::4, ::4].astype(np.int32)
                   for dd in sorted(frames) if dd >= arf_d - 4]
            if len(wfr) >= 2:
                mads = [float(np.abs(wfr[k + 1] - wfr[k]).mean()) /
                        (1 << bd_sh) for k in range(len(wfr) - 1)]
                if sum(mads) / len(mads) > self.tf_adaptive_threshold:
                    tf_on = False
        with _tstage("gop_dispatch"):
            dev = enc.device
            groups = None if tf_on else getattr(self, "gop_meshes", None)
            # device time of the program, first launch to last result
            # (one stream: not for device groups)
            from svt_av1_psy_tpu_torch.utils import trace as _tr
            program = None if groups else _tr.device_begin("gop_program",
                                                           dev)
            planes_dev = None if groups else plane_tensor(planes, dev)
            if tf_on:
                # TF window: sources at arf_d-4..arf_d-1, center (ARF)
                # last — gathered from the frame stack by index; masked
                # slots (short GoPs) contribute nothing. The reference
                # filters with an altref window up to 7 neighbors
                # (temporal_filtering.c); 4 past neighbors measured best
                # on the noisy RA harness here
                T = 5
                win_ds = [dd for dd in range(arf_d - 4, arf_d)
                          if dd in frames]
                win_idx = np.zeros(T, np.int32)
                win_mask = np.zeros(T, np.float32)
                chf = (pah // 2, paw // 2)
                win_u = np.zeros((T,) + chf, dtype)
                win_v = np.zeros((T,) + chf, dtype)
                for k, dd in enumerate(win_ds):
                    win_idx[k] = idx[dd]
                    win_mask[k] = 1.0
                    win_u[k] = _pad_to(np.asarray(frames[dd][1]),
                                       *chf).astype(dtype)
                    win_v[k] = _pad_to(np.asarray(frames[dd][2]),
                                       *chf).astype(dtype)
                win_idx[T - 1] = idx[arf_d]
                win_mask[T - 1] = 1.0
                win_u[T - 1] = _pad_to(np.asarray(frames[arf_d][1]),
                                       *chf).astype(dtype)
                win_v[T - 1] = _pad_to(np.asarray(frames[arf_d][2]),
                                       *chf).astype(dtype)
                # depth-1 mid anchor TF (+-2 window; the reference TFs
                # its layer-1 pictures too, tf_params_per_type[1]).
                # Stack position 2 = plan[1] by construction.
                mid_d = plan[1][0] if len(plan) > 1 else None
                tf_mid = mid_d is not None and idx[mid_d] == 2
                w2_idx = np.zeros(T, np.int32)
                w2_mask = np.zeros(T, np.float32)
                w2_u = np.zeros((T,) + chf, dtype)
                w2_v = np.zeros((T,) + chf, dtype)
                # no mid: the "filter" must be the identity on stack
                # pos 2 (center = itself, no weighted neighbors)
                w2_idx[T - 1] = 2 if fmax > 2 else 0
                if tf_mid:
                    w2_ds = [dd for dd in (mid_d - 2, mid_d - 1,
                                           mid_d + 1, mid_d + 2)
                             if dd in frames or dd == b]
                    for k, dd in enumerate(w2_ds):
                        w2_idx[k] = idx[dd] if dd != b else 0
                        w2_mask[k] = 1.0
                        fr2 = frames.get(dd)
                        if fr2 is not None:
                            w2_u[k] = _pad_to(np.asarray(fr2[1]),
                                              *chf).astype(dtype)
                            w2_v[k] = _pad_to(np.asarray(fr2[2]),
                                              *chf).astype(dtype)
                        else:
                            # base anchor: luma comes from the stack;
                            # chroma unavailable at dispatch — weight
                            # the slot out of the chroma accumulation
                            # is not possible per-plane, so drop it
                            w2_mask[k] = 0.0
                    w2_idx[T - 1] = idx[mid_d]
                    w2_mask[T - 1] = 1.0
                    w2_u[T - 1] = _pad_to(np.asarray(frames[mid_d][1]),
                                          *chf).astype(dtype)
                    w2_v[T - 1] = _pad_to(np.asarray(frames[mid_d][2]),
                                          *chf).astype(dtype)
                packed = gop_search_tf(
                    planes_dev, edges, int(bias),
                    plane_tensor(win_u, dev), plane_tensor(win_v, dev),
                    win_idx, torch.from_numpy(win_mask),
                    float(self.tf_strength), enc.bd, enc.min_block,
                    plane_tensor(w2_u, dev), plane_tensor(w2_v, dev),
                    w2_idx, torch.from_numpy(w2_mask))
                _tr.device_end(program)
                out = HostCopy(packed)
                tf_n = 2
                tf_mid = mid_d if tf_mid else None
            elif groups:
                # GoP parallelism over device groups (the reference's
                # disjoint meshes): successive mini-GoPs go round robin
                # over the groups, each queued on its group's streams, so
                # GoP k+1's program computes while GoP k is walked
                group = groups[getattr(self, "_gop_seq", 0) % len(groups)]
                self._gop_seq = getattr(self, "_gop_seq", 0) + 1
                out = _sharded_gop_search(group)(planes, edges, int(bias),
                                                 enc.bd, enc.min_block)
            else:
                packed = gop_search(planes_dev, edges, int(bias), enc.bd,
                                    enc.min_block)
                _tr.device_end(program)
                out = HostCopy(packed)
        # dispatch-time base for the NEXT GoP's edges: this GoP's ARF
        # source (open-loop; its recon does not exist yet)
        self._disp_base_display = arf_d
        self._disp_base_src = padded[arf_d]
        # a stashed key rides this task: it is this GoP's base b and
        # encodes at the top of the walk with its q from the TPL ladder
        key, self._key_pending = self._key_pending, None
        return {"frames": frames, "b": b, "arf_d": arf_d, "plan": plan,
                "n": len(buf), "out": out, "edge_keys": edge_keys,
                "idx": idx, "fmax": fmax, "emax": emax, "padded": padded,
                "tf": tf_on, "tf_n": tf_n if tf_on else 0,
                "tf_mid": tf_mid if tf_on else None, "key": key}

    def _finish_pending(self) -> list[RaPacket]:
        task, self._pending = self._pending, None
        if task is None:
            return []
        return self._walk_gop(task)

    def _encode_gop(self) -> list[RaPacket]:
        """Non-pipelined fallback: dispatch + walk in one step (GoP
        tails at flush/key boundaries)."""
        task = self._dispatch_gop()
        if task is None:
            return []
        return self._walk_gop(task)

    def _walk_gop(self, task) -> list[RaPacket]:
        """Phase B: fetch the GoP's packed device results and run the
        host commit walks (ARF + pyramid recursion + show_existing
        emission)."""
        from svt_av1_psy_tpu_torch.ops.torch_backend import (
            gop_search_tf_unpack, gop_search_unpack)
        from svt_av1_psy_tpu_torch.utils.trace import stage as _tstage

        enc = self.enc
        pah, paw = enc.pah, enc.paw
        frames = task["frames"]
        b, arf_d, plan = task["b"], task["arf_d"], task["plan"]
        idx = task["idx"]
        self._tpl_q = None
        with _tstage("gop_fetch"):
            buf = np.asarray(task["out"])
        self._filtered_src = {}
        if task["tf"]:
            mv, sad, sad32, sad64, dec, filt = gop_search_tf_unpack(
                buf, task["fmax"], task["emax"], (pah, paw), enc.bd,
                n_filtered=task.get("tf_n", 1))
            fy, fu, fv = filt[0]
            H, W = enc.height, enc.width
            ch, cw = (H + 1) // 2, (W + 1) // 2
            arf_src = (fy[:H, :W], fu[:ch, :cw], fv[:ch, :cw])
            # the ARF decide/HME ran on the FILTERED plane; the walk
            # must code the same source
            arf_padded = fy
            if len(filt) > 1 and task.get("tf_mid") is not None:
                f2y, f2u, f2v = filt[1]
                self._filtered_src[task["tf_mid"]] = (
                    (f2y[:H, :W], f2u[:ch, :cw], f2v[:ch, :cw]), f2y)
        else:
            mv, sad, sad32, sad64, dec = gop_search_unpack(
                buf, task["fmax"], task["emax"], (pah, paw))
            arf_src = frames[arf_d]
            arf_padded = task["padded"][arf_d]
        edge_ms = {k: (mv[i], sad[i])
                   for i, k in enumerate(task["edge_keys"])}
        edge_tree = {k: (sad32[i], sad64[i])
                     for i, k in enumerate(task["edge_keys"])}
        pre_by_d = {}
        for d, lo, hi, *_ in plan:
            entry = {"decide": enc._decide_finish(dec[idx[d]]),
                     "mv16": np.clip(edge_ms[(d, lo)][0], -127,
                                     127).astype(np.int16),
                     "sad16": edge_ms[(d, lo)][1],
                     "tree": edge_tree[(d, lo)]}
            if hi != lo:
                entry["mv16b"] = np.clip(edge_ms[(d, hi)][0], -127,
                                         127).astype(np.int16)
                entry["sad16b"] = edge_ms[(d, hi)][1]
                entry["treeb"] = edge_tree[(d, hi)]
            # per-16x16 single-ref choice from the HME SADs (the ME-SAD
            # ref pruning of motion_estimation.c:1615): 0 = LAST,
            # 1 = GOLDEN (GoP base), 2 = ALTREF (future anchor). Each
            # alternative must beat the incumbent by a 5/8 margin — it
            # pays ref-coding overhead and a weaker MVP (measured:
            # -4.1% BD on occlusion content, -0.4% on smooth motion;
            # laxer margins lose the latter). ALTREF single-ref covers
            # occlusion UNCOVER regions the past refs cannot see (the
            # BWD/ALT role of the reference's RA ref lists).
            best = edge_ms[(d, lo)][1].astype(np.int64)
            sel = np.zeros(best.shape, np.uint8)
            ge = edge_ms.get((d, b))
            if b != lo and b != hi and ge is not None:
                mv_g, sad_g = ge
                gwin = sad_g.astype(np.int64) * 8 < best * 5
                sel[gwin] = 1
                best = np.where(gwin, sad_g.astype(np.int64), best)
                entry["mv16g"] = np.clip(mv_g, -127,
                                         127).astype(np.int16)
                entry["sad16g"] = sad_g
                entry["treeg"] = edge_tree[(d, b)]
            if hi != lo:
                sad_a = edge_ms[(d, hi)][1]
                awin = sad_a.astype(np.int64) * 8 < best * 5
                sel[awin] = 2
            if sel.any():
                entry["refsel"] = sel
            pre_by_d[d] = entry
        self._pre_by_d = pre_by_d

        packets: list[RaPacket] = []
        key = task.get("key")

        # TPL r0/beta ladder: per-frame q from the GoP dependency flow
        # (ref tpl_model.c tpl_mc_flow; rc_process.c:783 crf_qindex_calc),
        # fed from the SAME device HME results the walks consume. A
        # pending key is the GoP base b: its q comes from the same r0
        # model (the kf_boost role) before it encodes below.
        if self.tpl_strength > 0:
            from svt_av1_psy_tpu_torch.models.tpl import tpl_gop_q
            with _tstage("tpl_gop_q"):
                fy_map = dict(task["padded"])
                fy_map[arf_d] = arf_padded
                for fd, (_fuv, fpad) in self._filtered_src.items():
                    fy_map[fd] = fpad
                fy_map[b] = key[2][:pah, :paw] if key is not None else \
                    np.asarray(enc._dpb[self._base_slot][0])[:pah, :paw]
                self._tpl_q = tpl_gop_q(
                    fy_map, plan, enc.qindex, bd=getattr(enc, "bd", 8),
                    strength=self.tpl_strength, edge_results=edge_ms,
                    key_d=b if key is not None else None,
                    base_q_coded=getattr(self, "_base_q_coded", None))

        if key is not None:
            kd, kfuv = key[0], key[1]
            ktok = key[3] if len(key) > 3 else None
            kq = self._tpl_q.get(kd) if self._tpl_q else None
            self.enc.kf_qindex = kq
            packets.append(self._encode_base_key(kd, kfuv,
                                                 future=frames,
                                                 tf_tok=ktok))
            self._base_q_coded = kq

        self._gop_base_slot = self._base_slot
        in_use = {self._base_slot}

        if task["n"] == 1:
            slot = self._free_slots(in_use)[0]
            f = self._encode_inter(arf_d, frames[arf_d], self._base_slot,
                                   1 << slot, True, 1)
            packets.append(RaPacket(f.payload, arf_d,
                                    self._recon_by_display[arf_d],
                                    qindex=getattr(self.enc,
                                                   '_last_coded_q', -1)))
            self._base_slot, self._base_display = slot, arf_d
            self._base_q_coded = self._tpl_q.get(arf_d) \
                if getattr(self, "_tpl_q", None) else None
            return packets

        arf_slot = self._free_slots(in_use)[0]
        in_use.add(arf_slot)

        f = self._encode_inter(arf_d, arf_src, self._base_slot,
                               1 << arf_slot, False, 0)
        packets.append(RaPacket(f.payload, -1, None,
                                qindex=getattr(self.enc,
                                               '_last_coded_q', -1)))

        self._rec_pyramid(b, arf_d, self._base_slot, arf_slot, 1,
                          frames, packets, in_use)

        from svt_av1_psy_tpu_torch.bitstream.headers import \
            show_existing_temporal_unit
        packets.append(RaPacket(show_existing_temporal_unit(arf_slot),
                                arf_d, self._recon_by_display[arf_d]))
        in_use.discard(self._base_slot)
        self._base_slot, self._base_display = arf_slot, arf_d
        self._base_q_coded = self._tpl_q.get(arf_d) \
            if getattr(self, "_tpl_q", None) else None
        return packets

    def _tpl_plan(self, b, arf_d):
        """Encode-order (display, lo_ref, hi_ref, depth) tuples mirroring
        _rec_pyramid's frame-level reference choices (references always
        precede their dependents — the property tpl_gop_q's backward
        induction relies on)."""
        plan = [(arf_d, b, b, 0)]

        def rec(lo, hi, depth):
            if hi - lo < 2:
                return
            mid = (lo + hi) // 2
            plan.append((mid, lo, hi, depth))
            rec(lo, mid, depth + 1)
            rec(mid, hi, depth + 1)

        rec(b, arf_d, 1)
        return plan

    def _rec_pyramid(self, lo, hi, lo_slot, hi_slot, depth, frames,
                     packets, in_use):
        if hi - lo < 2:
            return
        mid = (lo + hi) // 2
        # bidirectional: LAST = past anchor, ALTREF = future anchor
        # (compound NEAREST/NEW pairs + skip_mode in the walk)
        ref, ref2 = lo_slot, (hi_slot if hi_slot != lo_slot else None)
        if hi - lo == 2:
            # leaf: shown in its own TU, never referenced
            f = self._encode_inter(mid, frames[mid], ref, 0, True, depth,
                                   ref_slot2=ref2)
            packets.append(RaPacket(f.payload,
                                    mid, self._recon_by_display[mid],
                                    qindex=getattr(self.enc,
                                                   '_last_coded_q', -1)))
            return
        mid_slot = self._free_slots(in_use)[0]
        in_use.add(mid_slot)
        f = self._encode_inter(mid, frames[mid], ref, 1 << mid_slot,
                               False, depth, ref_slot2=ref2)
        packets.append(RaPacket(f.payload, -1, None,
                                qindex=getattr(self.enc,
                                               '_last_coded_q', -1)))
        self._rec_pyramid(lo, mid, lo_slot, mid_slot, depth + 1, frames,
                          packets, in_use)
        from svt_av1_psy_tpu_torch.bitstream.headers import \
            show_existing_temporal_unit
        packets.append(RaPacket(show_existing_temporal_unit(mid_slot),
                                mid, self._recon_by_display[mid]))
        self._rec_pyramid(mid, hi, mid_slot, hi_slot, depth + 1, frames,
                          packets, in_use)
        in_use.discard(mid_slot)
