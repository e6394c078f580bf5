"""PyTorch device search programs: intra decision and full-pel ME.

The port of the device programs of svt_av1_psy_tpu/ops/jax_backend.py that
the low-delay P-frame path runs. Every function takes tensors on one
device (CPU or CUDA) and computes with the same int32 integer math as the
JAX function it names, so the outputs are equal byte for byte. The numpy
unpackers are copied here so that the port never imports jax_backend
(which imports jax at module level).

Constants that the JAX programs bake into their traces (smooth weights,
directional gather maps, SEARCH_MODE_ORDER) are built as tensors from the
same numpy sources by block_tables(), once per (size, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svt_av1_psy_tpu.constants import PredMode
from svt_av1_psy_tpu.ops.intra import (_SM_WEIGHTS, _dr_maps_z1, _dr_maps_z2,
                                       _dr_maps_z3)

N_CANDS = 3

SEARCH_MODE_ORDER = (int(PredMode.DC_PRED), int(PredMode.V_PRED),
                     int(PredMode.H_PRED), int(PredMode.SMOOTH_PRED),
                     int(PredMode.SMOOTH_V_PRED), int(PredMode.SMOOTH_H_PRED),
                     int(PredMode.PAETH_PRED),
                     # directional family (base angles, delta 0)
                     int(PredMode.D45_PRED), int(PredMode.D135_PRED),
                     int(PredMode.D113_PRED), int(PredMode.D157_PRED),
                     int(PredMode.D203_PRED), int(PredMode.D67_PRED))

_DIR_ANGLES = (45, 135, 113, 157, 203, 67)


def plane_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint8/uint16 numpy pixel plane as a contiguous int32 tensor on
    `device`. 16-bit planes travel as int16 (AV1 pixels are < 2^12, so the
    reinterpretation keeps every value) because torch.uint16 has almost no
    kernels; the int32 widening happens on the device."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    elif arr.dtype != np.uint8:
        raise TypeError(f"pixel plane must be uint8 or uint16, got {arr.dtype}")
    return torch.from_numpy(arr).to(device).to(torch.int32)


@functools.lru_cache(maxsize=None)
def block_tables(size: int, device: torch.device) -> dict:
    """The search constants for size x size blocks as tensors on `device`:
    smooth weights, the SEARCH_MODE_ORDER lookup and, per directional
    angle, the gather indices, interpolation shifts and masks of
    jax_backend.predict_directional_batch (from ops/intra._dr_maps_*)."""
    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.array(x).reshape(-1), dtype=dtype,
                               device=device)

    def taps(idx, edge_len):
        # the gather pair (idx, idx + 1); idx + 1 is clamped to the edge
        # as XLA clamps an out-of-range gather (only masked-out positions
        # reach past the edge)
        return t(idx), t(np.minimum(idx + 1, edge_len - 1))

    s = size
    max_base = 2 * s - 1
    above_len, left_len = 2 * s + 1, 2 * s + 2      # ab_ext, le_ext
    directional = []
    for angle in _DIR_ANGLES:
        if angle < 90:
            base, shift, _ = _dr_maps_z1(s, s, angle, 0, False)
            directional.append((
                "above", *taps(np.minimum(base, max_base) + 1, above_len),
                t(shift, torch.int32), t(base < max_base, torch.bool),
                max_base + 1))
        elif angle < 180:
            a_base, a_shift, use_above, l_base, l_shift = _dr_maps_z2(
                s, s, angle, 0, 0)
            directional.append((
                "both", *taps(a_base + 1, above_len), t(a_shift, torch.int32),
                *taps(l_base + 2, left_len), t(l_shift, torch.int32),
                t(use_above, torch.bool)))
        else:
            base, shift, _ = _dr_maps_z3(s, s, angle, 0)
            directional.append((
                "left", *taps(np.minimum(base, max_base) + 2, left_len),
                t(shift, torch.int32), t(base < max_base, torch.bool),
                max_base + 2))
    return {"sm_weights": t(_SM_WEIGHTS[s], torch.int32),
            "mode_lut": t(SEARCH_MODE_ORDER, torch.uint8),
            "directional": tuple(directional)}


# --- intra prediction (batched over blocks) ---------------------------------

def predict_modes_batch(above: torch.Tensor, left: torch.Tensor,
                        above_left: torch.Tensor, have_above: torch.Tensor,
                        have_left: torch.Tensor, w: int, h: int,
                        bd: int = 8) -> torch.Tensor:
    """jax_backend.predict_modes_batch: the non-directional predictors
    DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH for a batch of blocks.
    above (N, w), left (N, h), above_left / have_* (N,); returns
    (N, 7, h, w) int32."""
    n = above.shape[0]
    base = 1 << (bd - 1)
    a = above.to(torch.int32)
    l = left.to(torch.int32)
    al = above_left.to(torch.int32).reshape(n, 1, 1)

    sum_a = a.sum(dim=1, dtype=torch.int32)
    sum_l = l.sum(dim=1, dtype=torch.int32)
    log2w = w.bit_length() - 1
    log2h = h.bit_length() - 1
    dc_both = (sum_a + sum_l + ((w + h) >> 1)) // (w + h)
    dc_a = (sum_a + (w >> 1)) >> log2w
    dc_l = (sum_l + (h >> 1)) >> log2h
    dc = torch.where(have_above & have_left, dc_both,
                     torch.where(have_above, dc_a,
                                 torch.where(have_left, dc_l, base)))
    dc_pred = dc.reshape(n, 1, 1).expand(n, h, w)

    v_pred = a.reshape(n, 1, w).expand(n, h, w)
    h_pred = l.reshape(n, h, 1).expand(n, h, w)

    wx = block_tables(w, a.device)["sm_weights"].reshape(1, 1, w)
    wy = block_tables(h, a.device)["sm_weights"].reshape(1, h, 1)
    below = l[:, h - 1].reshape(n, 1, 1)
    right = a[:, w - 1].reshape(n, 1, 1)
    a3 = a.reshape(n, 1, w)
    l3 = l.reshape(n, h, 1)
    smooth = ((wy * a3 + (256 - wy) * below + wx * l3 + (256 - wx) * right
               + 256) >> 9)
    smooth_v = ((wy * a3 + (256 - wy) * below + 128) >> 8).expand(n, h, w)
    smooth_h = ((wx * l3 + (256 - wx) * right + 128) >> 8).expand(n, h, w)

    pbase = a3 + l3 - al
    pa = (pbase - a3).abs()
    pl = (pbase - l3).abs()
    pal = (pbase - al).abs()
    paeth = torch.where((pa <= pl) & (pa <= pal), a3,
                        torch.where(pl <= pal, l3, al))

    return torch.stack([dc_pred, v_pred, h_pred, smooth, smooth_v, smooth_h,
                        paeth], dim=1)


def _interp(edge: torch.Tensor, idx: torch.Tensor, idx1: torch.Tensor,
            shift: torch.Tensor) -> torch.Tensor:
    return (edge[:, idx] * (32 - shift) + edge[:, idx1] * shift + 16) >> 5


def predict_directional_batch(above2: torch.Tensor, left2: torch.Tensor,
                              above_left: torch.Tensor, size: int,
                              bd: int = 8) -> torch.Tensor:
    """jax_backend.predict_directional_batch: directional predictors at
    base angles, delta 0, no edge filter. above2/left2 (N, 2*size)
    extended edges; returns (N, 6, size, size) int32 in _DIR_ANGLES
    order."""
    n = above2.shape[0]
    hi = (1 << bd) - 1
    al = above_left.to(torch.int32).reshape(n, 1)
    ab_ext = torch.cat([al, above2.to(torch.int32)], dim=1)
    le_ext = torch.cat([torch.zeros_like(al), al, left2.to(torch.int32)],
                       dim=1)
    outs = []
    for kind, *maps in block_tables(size, ab_ext.device)["directional"]:
        if kind == "both":
            a_idx, a_idx1, a_shift, l_idx, l_idx1, l_shift, use_above = maps
            v = torch.where(use_above,
                            _interp(ab_ext, a_idx, a_idx1, a_shift),
                            _interp(le_ext, l_idx, l_idx1, l_shift))
        else:
            idx, idx1, shift, inside, fill = maps
            edge = ab_ext if kind == "above" else le_ext
            v = torch.where(inside, _interp(edge, idx, idx1, shift),
                            edge[:, fill:fill + 1])
        outs.append(v.clamp(0, hi).reshape(n, size, size))
    return torch.stack(outs, dim=1)


def _gather_sb_edges(plane: torch.Tensor, sb: int, bd: int,
                     ext: bool = False):
    """jax_backend._gather_sb_edges: edges of every sb x sb block of a
    plane from the SOURCE frame. plane (H, W) int32. Returns (above (N,sb),
    left (N,sb), above_left (N,), have_a, have_l), plus (above2 (N,2sb),
    left2 (N,2sb)) extended edges clamped at the frame when ext=True."""
    H, W = plane.shape
    nr, nc = H // sb, W // sb
    base = 1 << (bd - 1)
    dev = plane.device
    padded = plane.new_full((H + 1, W + 1), base)
    padded[1:, 1:] = plane
    rows = padded[::sb, :][:nr, 1:]                     # (nr, W)
    above = rows.reshape(nr, nc, sb)
    cols = padded[:, ::sb][1:, :nc]                     # (H, nc)
    left = cols.reshape(nr, sb, nc).permute(0, 2, 1)    # (nr, nc, sb)
    al = padded[::sb, ::sb][:nr, :nc]                   # (nr, nc)
    have_a = (torch.arange(nr, device=dev) > 0).reshape(nr, 1).expand(nr, nc)
    have_l = (torch.arange(nc, device=dev) > 0).reshape(1, nc).expand(nr, nc)
    ha3 = have_a.reshape(nr, nc, 1)
    hl3 = have_l.reshape(nr, nc, 1)
    n = nr * nc
    # spec edge fill for unavailable sides
    above = torch.where(ha3, above,
                        torch.where(hl3, left[:, :, :1], base - 1))
    left = torch.where(hl3, left,
                       torch.where(ha3, above[:, :, :1], base + 1))
    out = (above.reshape(n, sb), left.reshape(n, sb), al.reshape(n),
           have_a.reshape(n), have_l.reshape(n))
    if not ext:
        return out
    cs = torch.arange(2 * sb, device=dev)
    xs = torch.clamp_max(torch.arange(nc, device=dev).reshape(nc, 1) * sb
                         + cs, W - 1)
    above2 = rows[:, xs]                                # (nr, nc, 2sb)
    ys = torch.clamp_max(torch.arange(nr, device=dev).reshape(nr, 1) * sb
                         + cs, H - 1)
    left2 = cols.t()[:, ys].permute(1, 0, 2)            # (nr, nc, 2sb)
    above2 = torch.where(ha3, above2,
                         torch.where(hl3, left[:, :, :1], base - 1))
    left2 = torch.where(hl3, left2,
                        torch.where(ha3, above[:, :, :1], base + 1))
    return out + (above2.reshape(n, 2 * sb), left2.reshape(n, 2 * sb))


def intra_decide(plane: torch.Tensor, split_bias: int, bd: int = 8,
                 min_block: int = 8):
    """jax_backend.intra_decide: mode search at every block size plus the
    bottom-up split tree. plane (H, W) integer pixels (H, W multiples of
    64); split_bias: rate bias per split. Returns (split64, split32,
    split16, mode64, mode32, mode16, mode8): split maps uint8 (nr, nc),
    mode maps uint8 (nr, nc, N_CANDS), the stable top-K of the 13 modes.

    Materialises (blocks, 13, s, s) int32 predictions per size, as the
    JAX program does (about 109 MB per size at 1088x1920)."""
    p = plane.to(torch.int32)
    H, W = p.shape
    sizes = [s for s in (64, 32, 16, 8) if s >= min_block]
    costs = {}
    modes = {}
    for s in sizes:
        a, l, c0, da, dl, a2, l2 = _gather_sb_edges(p, s, bd, ext=True)
        preds = torch.cat([predict_modes_batch(a, l, c0, da, dl, s, s, bd),
                           predict_directional_batch(a2, l2, c0, s, bd)],
                          dim=1)
        blocks = p.reshape(H // s, s, W // s, s).permute(0, 2, 1, 3)
        n = blocks.shape[0] * blocks.shape[1]
        sad = (blocks.reshape(n, 1, s, s) - preds).abs().sum(
            dim=(2, 3), dtype=torch.int32)
        # split decisions use the non-directional cost floor (as in JAX)
        costs[s] = sad[:, :7].amin(dim=1).reshape(H // s, W // s)
        # jnp.argsort is stable: ties keep SEARCH_MODE_ORDER
        topk = torch.argsort(sad, dim=1, stable=True)[:, :N_CANDS]
        modes[s] = block_tables(s, p.device)["mode_lut"][topk].reshape(
            H // s, W // s, N_CANDS)
    for s in (64, 32, 16, 8):
        if s not in modes:
            modes[s] = torch.zeros((H // s, W // s, N_CANDS),
                                   dtype=torch.uint8, device=p.device)
    split = {s: torch.zeros((H // s, W // s), dtype=torch.uint8,
                            device=p.device) for s in (64, 32, 16)}
    if len(sizes) > 1:
        eff = {sizes[-1]: costs[sizes[-1]]}
        for s in sizes[-2::-1]:
            child = eff[s // 2]
            agg = (child[0::2, 0::2] + child[0::2, 1::2] +
                   child[1::2, 0::2] + child[1::2, 1::2])
            do_split = agg + split_bias < costs[s]
            split[s] = do_split.to(torch.uint8)
            eff[s] = torch.where(do_split, agg + split_bias, costs[s])
    return (split[64], split[32], split[16],
            modes[64], modes[32], modes[16], modes[8])


def intra_decide_packed(plane: torch.Tensor, split_bias: int, bd: int = 8,
                        min_block: int = 8) -> torch.Tensor:
    """intra_decide with all seven outputs packed into ONE uint8 vector,
    so the result comes to the host in one copy."""
    outs = intra_decide(plane, split_bias, bd, min_block)
    return torch.cat([o.reshape(-1).to(torch.uint8) for o in outs])


def intra_decide_unpack(buf, shape):
    """Host-side unpack of intra_decide_packed (numpy). shape = padded
    (H, W) of the plane the program ran on."""
    H, W = shape
    parts = []
    off = 0
    for s in (64, 32, 16):
        n = (H // s) * (W // s)
        parts.append(buf[off:off + n].reshape(H // s, W // s))
        off += n
    for s in (64, 32, 16, 8):
        n = (H // s) * (W // s) * N_CANDS
        parts.append(buf[off:off + n].reshape(H // s, W // s, N_CANDS))
        off += n
    assert off == buf.size
    return tuple(parts)


# --- full-pel motion search -------------------------------------------------

def pack_mv_sad(mv16: torch.Tensor, sad: torch.Tensor) -> torch.Tensor:
    """Pack a full-pel ME result (mv16, sad16) into ONE int32 vector."""
    return torch.cat([mv16.reshape(-1).to(torch.int32),
                      sad.reshape(-1).to(torch.int32)])


def hme2_unpack(buf, n16r, n16c):
    nmv = n16r * n16c * 2
    mv16 = buf[:nmv].reshape(n16r, n16c, 2).astype(np.int16)
    sad = buf[nmv:].reshape(n16r, n16c)
    return mv16, sad


def _half_res(plane: torch.Tensor) -> torch.Tensor:
    return (plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] +
            plane[1::2, 1::2] + 2) >> 2


def _edge_pad(plane: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate padding by r on every side, by clamped gathers (any
    dtype, any device)."""
    H, W = plane.shape
    dev = plane.device
    rows = torch.arange(-r, H + r, device=dev).clamp_(0, H - 1)
    cols = torch.arange(-r, W + r, device=dev).clamp_(0, W - 1)
    return plane[rows[:, None], cols[None, :]]


def hme_planes(src: torch.Tensor, ref: torch.Tensor, search_range: int):
    """The inputs of the SAD scan: the rounded 2x2-mean decimation of src
    (H/2, W/2) and of ref, edge-padded by search_range, as contiguous
    int32 (H/2 + 2R, W/2 + 2R)."""
    sh = _half_res(src.to(torch.int32)).contiguous()
    rp = _edge_pad(_half_res(ref.to(torch.int32)), search_range)
    return sh, rp.contiguous()


def hme_search(src: torch.Tensor, ref: torch.Tensor,
               search_range: int = 12):
    """jax_backend.hme_search, the plain version of the K1 kernel: full
    search at half resolution over +-search_range with a running min over
    the dy-major offset grid (strict <, so the first minimal offset wins).
    src, ref (H, W) integer planes, H and W multiples of 16. Returns
    (mv16 (H/16, W/16, 2) int16 full-pel, sad16 (H/16, W/16) int32)."""
    sh, rp = hme_planes(src, ref, search_range)
    Hh, Wh = sh.shape
    n16r, n16c = Hh // 8, Wh // 8
    R = search_range
    side = 2 * R + 1
    best_sad = torch.full((n16r, n16c), 1 << 30, dtype=torch.int32,
                          device=sh.device)
    best_mv = torch.zeros((n16r, n16c, 2), dtype=torch.int32,
                          device=sh.device)
    offsets = torch.tensor([(i // side - R, i % side - R)
                            for i in range(side * side)],
                           dtype=torch.int32, device=sh.device)
    for i in range(side * side):
        dy = i // side - R
        dx = i % side - R
        shifted = rp[dy + R:dy + R + Hh, dx + R:dx + R + Wh]
        sad = (sh - shifted).abs().reshape(n16r, 8, n16c, 8).sum(
            dim=(1, 3), dtype=torch.int32)
        better = sad < best_sad
        best_mv = torch.where(better[..., None], offsets[i], best_mv)
        best_sad = torch.where(better, sad, best_sad)
    return (2 * best_mv).to(torch.int16), best_sad
