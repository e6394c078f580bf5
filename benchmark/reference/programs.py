"""The plain reference of the device programs that the benchmark's cells
drive: a frozen copy, in plain PyTorch and NumPy, of the search programs
the encoder runs on the card (the intra decide, the single-level full
search that the K1 kernel computes, the two-level search, the SAD tree,
the temporal filter, the GoP program's layout, the loop-restoration
search and the lookahead's per-superblock offsets).

It imports nothing of the encoder: the tables it needs (smooth weights,
the directional derivative table, the search's mode order) are written
out here, from the AV1 specification. The functions take device or CPU
tensors and compute with int32 integer math, and the two float programs
(temporal filter, restoration search) in the float type they are given.
The checks (checks/) run those two in float64, so that the reference
differs from the encoder's float32 in its arithmetic and a sound run
reads the encoder's own rounding; the control runs them in bfloat16, and
every search on 7-bit pixels, one precision below the configuration.
The integer programs are the encoder's, written out again: that they
compute what the JAX package computes is held by the repo's parity tests
(tests/test_torch_*), not here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# AV1 intra prediction modes (spec 6.10.22)
DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, \
    D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, \
    PAETH_PRED = range(13)

# global candidates of the two-level search (the encoder's default)
K_GLOB = 4

# spec 7.11.2.6 smooth-weight table, indexed by block dimension
_SM_WEIGHTS = {
    4: np.array([255, 149, 85, 64], np.int32),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32], np.int32),
    16: np.array([255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26,
                  20, 17, 16], np.int32),
    32: np.array([255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
                  101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14,
                  12, 10, 9, 8, 8], np.int32),
    64: np.array([255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176,
                  169, 163, 156, 150, 144, 138, 133, 127, 121, 116, 111, 106,
                  101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44,
                  41, 38, 35, 32, 29, 27, 25, 22, 20, 18, 16, 15, 13, 12, 10,
                  9, 8, 7, 6, 6, 5, 5, 4, 4, 4], np.int32),
}

# spec 7.11.2.4 Dr_Intra_Derivative, indexed by angle (0 where unused)
_DR_DERIV = np.zeros(90, np.int32)
for _a, _d in ((3, 1023), (6, 547), (9, 372), (14, 273), (17, 215),
               (20, 178), (23, 151), (26, 132), (29, 116), (32, 102),
               (36, 90), (39, 80), (42, 71), (45, 64), (48, 57), (51, 51),
               (54, 45), (58, 40), (61, 35), (64, 31), (67, 27), (70, 23),
               (73, 19), (76, 15), (81, 11), (84, 7), (87, 3)):
    _DR_DERIV[_a] = _d


def _deriv_dx(p_angle: int) -> int:
    return int(_DR_DERIV[p_angle]) if p_angle < 90 \
        else int(_DR_DERIV[180 - p_angle])


def _deriv_dy(p_angle: int) -> int:
    return int(_DR_DERIV[p_angle - 90]) if p_angle < 180 \
        else int(_DR_DERIV[270 - p_angle])


@functools.lru_cache(maxsize=None)
def _dr_maps_z1(w, h, p_angle, ua, _unused):
    dx = _deriv_dx(p_angle)
    i = np.arange(h).reshape(h, 1)
    j = np.arange(w).reshape(1, w)
    idx = (i + 1) * dx
    base = (idx >> (6 - ua)) + (j << ua)
    shift = ((idx << ua) >> 1) & 0x1F
    shift = np.broadcast_to(shift, (h, w))
    return base, shift, None


@functools.lru_cache(maxsize=None)
def _dr_maps_z2(w, h, p_angle, ua, ul):
    dx = _deriv_dx(p_angle)
    dy = _deriv_dy(p_angle)
    i = np.arange(h).reshape(h, 1)
    j = np.arange(w).reshape(1, w)
    idx = (j << 6) - (i + 1) * dx
    a_base = idx >> (6 - ua)
    a_shift = ((idx << ua) >> 1) & 0x1F
    use_above = a_base >= -(1 << ua)
    a_base = np.maximum(a_base, -(1 << ua))   # safe index when unused
    idx2 = (i << 6) - (j + 1) * dy
    l_base = idx2 >> (6 - ul)
    l_shift = ((idx2 << ul) >> 1) & 0x1F
    l_base = np.maximum(l_base, -2)
    return (np.broadcast_to(a_base, (h, w)),
            np.broadcast_to(a_shift, (h, w)), use_above,
            np.broadcast_to(l_base, (h, w)),
            np.broadcast_to(l_shift, (h, w)))


@functools.lru_cache(maxsize=None)
def _dr_maps_z3(w, h, p_angle, ul):
    dy = _deriv_dy(p_angle)
    i = np.arange(h).reshape(h, 1)
    j = np.arange(w).reshape(1, w)
    idx = (j + 1) * dy
    base = (idx >> (6 - ul)) + (i << ul)
    shift = ((idx << ul) >> 1) & 0x1F
    shift = np.broadcast_to(shift, (h, w))
    return base, shift, None


N_CANDS = 3

SEARCH_MODE_ORDER = ((DC_PRED), (V_PRED),
                     (H_PRED), (SMOOTH_PRED),
                     (SMOOTH_V_PRED), (SMOOTH_H_PRED),
                     (PAETH_PRED),
                     # directional family (base angles, delta 0)
                     (D45_PRED), (D135_PRED),
                     (D113_PRED), (D157_PRED),
                     (D203_PRED), (D67_PRED))

_DIR_ANGLES = (45, 135, 113, 157, 203, 67)



@functools.lru_cache(maxsize=None)
def block_tables(size: int, device: torch.device) -> dict:
    """The search constants for size x size blocks as tensors on `device`:
    smooth weights, the SEARCH_MODE_ORDER lookup and, per directional
    angle, the gather indices, interpolation shifts and masks of
    predict_directional_batch (from the _dr_maps_* above)."""
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
    """predict_modes_batch: the non-directional predictors
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
    """predict_directional_batch: directional predictors at
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
    """_gather_sb_edges: edges of every sb x sb block of a
    plane from the SOURCE frame. plane (H, W) int32. Returns (above (N,sb),
    left (N,sb), above_left (N,), have_a, have_l), plus (above2 (N,2sb),
    left2 (N,2sb)) extended edges clamped at the frame when ext=True.

"""
    H, Wp = plane.shape
    a, b, x0, W = 0, Wp, 0, Wp
    nr, nc = H // sb, (b - a) // sb
    base = 1 << (bd - 1)
    dev = plane.device
    padded = plane.new_full((H + 1, Wp + 1), base)
    padded[1:, 1:] = plane
    rows = padded[::sb, 1:][:nr]                        # (nr, Wp)
    above = rows[:, a:b].reshape(nr, nc, sb)
    cols = padded[1:, a::sb][:, :nc]                    # (H, nc)
    left = cols.reshape(nr, sb, nc).permute(0, 2, 1)    # (nr, nc, sb)
    al = padded[::sb, a::sb][:nr, :nc]                  # (nr, nc)
    have_a = (torch.arange(nr, device=dev) > 0).reshape(nr, 1).expand(nr, nc)
    have_l = (torch.arange(nc, device=dev) * sb + x0 > 0).reshape(
        1, nc).expand(nr, nc)
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
    xs = a + torch.clamp_max(torch.arange(nc, device=dev).reshape(nc, 1) * sb
                             + cs, W - 1 - x0)
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
    """intra_decide: mode search at every block size plus the
    bottom-up split tree. plane (H, W) integer pixels (H, W multiples of
    64); split_bias: rate bias per split. Returns (split64, split32,
    split16, mode64, mode32, mode16, mode8): split maps uint8 (nr, nc),
    mode maps uint8 (nr, nc, N_CANDS), the stable top-K of the 13 modes.

    Materialises (blocks, 13, s, s) int32 predictions per size, as the
    JAX program does (about 109 MB per size at 1088x1920)."""
    p = plane.to(torch.int32)
    own_p = p
    H, W = own_p.shape
    sizes = [s for s in (64, 32, 16, 8) if s >= min_block]
    costs = {}
    modes = {}
    for s in sizes:
        a, l, c0, da, dl, a2, l2 = _gather_sb_edges(p, s, bd, ext=True)
        preds = torch.cat([predict_modes_batch(a, l, c0, da, dl, s, s, bd),
                           predict_directional_batch(a2, l2, c0, s, bd)],
                          dim=1)
        blocks = own_p.reshape(H // s, s, W // s, s).permute(0, 2, 1, 3)
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



def hme2_unpack(buf, n16r, n16c):
    nmv = n16r * n16c * 2
    mv16 = buf[:nmv].reshape(n16r, n16c, 2).astype(np.int16)
    sad = buf[nmv:].reshape(n16r, n16c)
    return mv16, sad


def _half_res(plane: torch.Tensor) -> torch.Tensor:
    """Rounded 2x2 mean over the last two dims."""
    return (plane[..., 0::2, 0::2] + plane[..., 0::2, 1::2] +
            plane[..., 1::2, 0::2] + plane[..., 1::2, 1::2] + 2) >> 2


def _edge_pad(plane: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate padding of the last two dims by r on every side, by
    clamped gathers (any dtype, any device)."""
    H, W = plane.shape[-2:]
    dev = plane.device
    rows = torch.arange(-r, H + r, device=dev).clamp_(0, H - 1)
    cols = torch.arange(-r, W + r, device=dev).clamp_(0, W - 1)
    return plane[..., rows[:, None], cols[None, :]]


def hme_planes(src: torch.Tensor, ref: torch.Tensor, search_range: int):
    """The inputs of the SAD scan: the rounded 2x2-mean decimation of src
    (H/2, W/2) and of ref, edge-padded by search_range, as contiguous
    int32 (H/2 + 2R, W/2 + 2R)."""
    sh = _half_res(src.to(torch.int32)).contiguous()
    rp = _edge_pad(_half_res(ref.to(torch.int32)), search_range)
    return sh, rp.contiguous()


def hme_search(src: torch.Tensor, ref: torch.Tensor,
               search_range: int = 12):
    """hme_search, the plain version of the K1 kernel: full
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



# --- two-level motion search, SAD tree, temporal filter ---------------------
#
# The JAX programs below slice windows whose starts are device values (the
# level-0 seeds, the global MVs, per-block MVs) with lax.dynamic_slice. The
# port gathers those windows with index arithmetic instead (_windows), so a
# launch never waits on the host for a start. Every start stays in range
# by construction (noted at each call): an index past the plane raises,
# where XLA would clamp it silently.

def _windows(plane: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
             hs: int, ws: int) -> torch.Tensor:
    """plane (B, Hp, Wp); y0, x0 (B, n) window starts. Returns the
    (B, n, hs, ws) windows plane[b, y0 + i, x0 + j] as one gather."""
    dev = plane.device
    rows = y0[..., None, None] + torch.arange(hs, device=dev)[:, None]
    cols = x0[..., None, None] + torch.arange(ws, device=dev)[None, :]
    bidx = torch.arange(plane.shape[0], device=dev).reshape(-1, 1, 1, 1)
    return plane[bidx, rows, cols]


def hme_search2(src: torch.Tensor, ref: torch.Tensor, r0: int = 16,
                r1: int = 7):
    """hme_search2: two-level full-pel ME. A quarter-res
    search over +-r0 seeds a per-block half-res search over +-r1 around
    2 * seed; then each block also tries +-2 half-res around each of the
    K_GLOB most-voted seeds of the frame (SVT_HME_GLOBK, default 4, read at
    each call; 0 turns the global candidates off).

    src, ref: (H, W) integer planes, or a batch (B, H, W) searched edge by
    edge; H, W multiples of 16. Every running min keeps the first minimum
    in dy-major scan order, as the reference's strict-< fori loops do.
    Returns (mv16 (..., H/16, W/16, 2) int16 full-pel, sad16 (..., H/16,
    W/16) int32 half-res 8x8 SAD)."""
    single = src.dim() == 2
    if single:
        src, ref = src[None], ref[None]
    pyr = _hme_pyramid(src, ref)
    seed = _hme_level0(pyr, r0)
    k_glob = K_GLOB
    glob_mv = _hme_global(_hme_votes(seed, r0), k_glob, r0) if k_glob \
        else None
    mv16, best_sad = _hme_level1(pyr, seed, glob_mv, r0, r1)
    if single:
        return mv16[0], best_sad[0]
    return mv16, best_sad


# hme_search2 in its parts, so that a width-sharded search
# (gop_search_sharded) can vote over the whole frame between level 0 and
# level 1

def _hme_pyramid(src: torch.Tensor, ref: torch.Tensor):
    """(sh, rh, sq, rq): the half- and quarter-res planes of a (B, H, W)
    batch."""
    sh = _half_res(src.to(torch.int32))
    rh = _half_res(ref.to(torch.int32))
    return sh, rh, _half_res(sh), _half_res(rh)


def _hme_level0(pyr, r0: int) -> torch.Tensor:
    """Level 0: one quarter-res 4x4 block per 16x16 block, full search over
    +-r0. Returns the seeds (B, n16r, n16c, 2) int32, quarter-res units."""
    _, _, sq, rq = pyr
    i32 = torch.int32
    B, Hq, Wq = sq.shape
    n16r, n16c = Hq // 4, Wq // 4
    dev = sq.device
    # each dy step scores every dx at once through an unfolded view of the
    # padded plane
    side0 = 2 * r0 + 1
    xshift0 = _edge_pad(rq, r0).unfold(2, Wq, 1)    # (B, Hq+2r0, side0, Wq)
    best_sad = torch.full((B, n16r, n16c), 1 << 30, dtype=i32, device=dev)
    best_mv = torch.zeros((B, n16r, n16c, 2), dtype=i32, device=dev)
    for i in range(side0):
        d = (sq[:, :, None, :] - xshift0[:, i:i + Hq]).abs()
        sad = d.reshape(B, n16r, 4, side0, n16c, 4).sum(dim=(2, 5),
                                                         dtype=i32)
        s_min, k = sad.min(dim=2)                   # first minimal dx
        better = s_min < best_sad
        cand = torch.stack([torch.full_like(s_min, i - r0),
                            k.to(i32) - r0], dim=-1)
        best_mv = torch.where(better[..., None], cand, best_mv)
        best_sad = torch.where(better, s_min, best_sad)
    return best_mv


def _hme_votes(seed: torch.Tensor, r0: int) -> torch.Tensor:
    """The histogram of level-0 seeds (B, ..., 2) over the (2r0+1)^2 bins
    of each batch entry: (B, (2r0+1)^2) int32."""
    side0 = 2 * r0 + 1
    seed = seed.reshape(seed.shape[0], -1, 2)
    vote = ((seed[..., 0] + r0) * side0 + seed[..., 1] + r0).long()
    votes = torch.zeros((seed.shape[0], side0 * side0), dtype=torch.int32,
                        device=seed.device)
    votes.scatter_add_(1, vote, torch.ones_like(vote, dtype=torch.int32))
    return votes


def _hme_global(votes: torch.Tensor, k_glob: int, r0: int) -> torch.Tensor:
    """The k_glob most-voted seeds of each batch entry (B, k_glob, 2)."""
    side0 = 2 * r0 + 1
    # lax.top_k order: more votes first, the lower bin first on ties
    top = torch.sort(votes, dim=1, descending=True,
                     stable=True).indices[:, :k_glob]
    return torch.stack([top // side0 - r0, top % side0 - r0],
                       dim=-1).to(torch.int32)


def _hme_level1(pyr, seed: torch.Tensor, glob_mv, r0: int, r1: int):
    """Level 1 and the global refine of hme_search2 from the seeds (B,
    n16r, n16c, 2) and the global MVs (B, K, 2), or None for none. Returns
    (mv16 (B, n16r, n16c, 2) int16, sad16 (B, n16r, n16c) int32)."""
    sh, rh, _, _ = pyr
    i32 = torch.int32
    B, Hh, Wh = sh.shape
    n16r, n16c = Hh // 8, Wh // 8
    nb = n16r * n16c
    dev = sh.device
    seed = seed.reshape(B, nb, 2)

    # level 1: half-res 8x8 blocks, +-r1 around 2 * seed. The window start
    # by*8 + 2*seed - r1 + P lies in [by*8 + 8, by*8 + 72] of the plane
    # padded by P = 2*r0 + r1 + 8, whose last window ends at Hh + 86.
    P = 2 * r0 + r1 + 8
    rp1 = _edge_pad(rh, P)
    side1 = 2 * r1 + 1
    wsz = 8 + 2 * r1
    bi = torch.arange(nb, device=dev)
    blks = sh.reshape(B, n16r, 8, n16c, 8).permute(0, 1, 3, 2, 4) \
        .reshape(B, nb, 8, 8)
    cy = (bi // n16c) * 8 + 2 * seed[..., 0] - r1 + P
    cx = (bi % n16c) * 8 + 2 * seed[..., 1] - r1 + P
    winx = _windows(rp1, cy, cx, wsz, wsz).unfold(3, 8, 1)
    best1 = torch.full((B, nb), 1 << 30, dtype=i32, device=dev)
    best_off = torch.zeros((B, nb, 2), dtype=i32, device=dev)
    for dy in range(side1):
        # (B, nb, 8 rows, side1 dx, 8 cols) against the source blocks
        sad = (winx[:, :, dy:dy + 8] - blks[:, :, :, None, :]).abs().sum(
            dim=(2, 4), dtype=i32)
        s_min, k = sad.min(dim=2)
        better = s_min < best1
        off = torch.stack([torch.full_like(s_min, dy - r1),
                           k.to(i32) - r1], dim=-1)
        best_off = torch.where(better[..., None], off, best_off)
        best1 = torch.where(better, s_min, best1)
    best_sad = best1.reshape(B, n16r, n16c)
    mv_h = (2 * seed + best_off).reshape(B, n16r, n16c, 2)

    # global refine: +-R1G half-res around 2 * each global MV, dense over
    # the plane; a block takes it only on a strictly lower SAD. Window
    # rows start at 2*g - R1G + P in [13, 81], ending at most at Hh + 85.
    if glob_mv is not None:
        R1G = 2
        sideg = 2 * R1G + 1
        for k in range(glob_mv.shape[1]):
            gy, gx = glob_mv[:, k, 0], glob_mv[:, k, 1]          # (B,)
            ox0 = 2 * gx - R1G
            win = _windows(rp1, (2 * gy - R1G + P)[:, None],
                           (ox0 + P)[:, None], Hh + 2 * R1G,
                           Wh + 2 * R1G)[:, 0]
            winx = win.unfold(2, Wh, 1)          # (B, Hh+2R1G, sideg, Wh)
            for t in range(sideg):
                d = (sh[:, :, None, :] - winx[:, t:t + Hh]).abs()
                sad = d.reshape(B, n16r, 8, sideg, n16c, 8).sum(
                    dim=(2, 5), dtype=i32)
                s_min, j = sad.min(dim=2)
                better = s_min < best_sad
                oy = (2 * gy + t - R1G)[:, None, None].expand_as(s_min)
                mv2 = torch.stack([oy, ox0[:, None, None] + j.to(i32)],
                                  dim=-1)
                mv_h = torch.where(better[..., None], mv2, mv_h)
                best_sad = torch.where(better, s_min, best_sad)
    return (2 * mv_h).to(torch.int16), best_sad


def _gather_sad_nodes(sh: torch.Tensor, rh: torch.Tensor, off: torch.Tensor,
                      bs: int, pad: int) -> torch.Tensor:
    """_gather_sad_nodes over a batch: the half-res SAD of
    every bs x bs node of sh (B, Hh, Wh) against rh (edge-padded by pad)
    shifted by the per-node offsets off (B, nr, nc, 2), clamped to
    +-pad. Returns (B, nr, nc) int32."""
    B, nr, nc = off.shape[:3]
    blocks = sh[:, :nr * bs, :nc * bs].reshape(B, nr, bs, nc, bs) \
        .permute(0, 1, 3, 2, 4).reshape(B, nr * nc, bs, bs)
    oy = off[..., 0].reshape(B, -1).clamp(-pad, pad)
    ox = off[..., 1].reshape(B, -1).clamp(-pad, pad)
    bi = torch.arange(nr * nc, device=sh.device)
    wins = _windows(rh, (bi // nc) * bs + oy + pad, (bi % nc) * bs + ox + pad,
                    bs, bs)
    return (wins - blocks).abs().sum(dim=(2, 3), dtype=torch.int32) \
        .reshape(B, nr, nc)


def hme_sad_tree(src: torch.Tensor, ref: torch.Tensor, mv16: torch.Tensor):
    """hme_sad_tree: the fullpel SAD tree above 16x16. Each
    32x32 (64x64) node takes the least half-res SAD over its four
    children's MVs; ties keep the first child in the order (0,0), (0,1),
    (1,0), (1,1). src, ref (H, W) or (B, H, W) with H, W multiples of 64;
    mv16 (..., H/16, W/16, 2) full-pel. Returns (sad32, sad64) int32."""
    single = src.dim() == 2
    if single:
        src, ref, mv16 = src[None], ref[None], mv16[None]
    sh = _half_res(src.to(torch.int32))
    rh = _half_res(ref.to(torch.int32))
    PAD = 48                                     # >= hme_search2 reach/2
    rhp = _edge_pad(rh, PAD)
    mvh = mv16.to(torch.int32) >> 1              # half-res units

    def level(off_child, bs):
        best = best_off = None
        for i in (0, 1):
            for j in (0, 1):
                off = off_child[:, i::2, j::2]
                sad = _gather_sad_nodes(sh, rhp, off, bs, PAD)
                if best is None:
                    best, best_off = sad, off
                else:
                    take = sad < best
                    best_off = torch.where(take[..., None], off, best_off)
                    best = torch.minimum(best, sad)
        return best, best_off

    sad32, mv32 = level(mvh, 16)
    sad64, _ = level(mv32, 32)
    if single:
        return sad32[0], sad64[0]
    return sad32, sad64


def _tf_align(center: torch.Tensor, neigh: torch.Tensor, mv16: torch.Tensor,
              sub: int, f32=torch.float32):
    """_tf_align: MC copy of neigh (H, W) onto center by the
    per-16x16 (luma units) full-pel MVs mv16 (n16r, n16c, 2) int32, at
    1 >> sub scale; the blocks tile the plane (H = n16r * (16 >> sub), as
    for the padded planes the encoder filters). Returns (aligned (H, W)
    int32, per-block mean squared error (n16r, n16c) float32)."""
    bs = 16 >> sub
    n16r, n16c = mv16.shape[:2]
    PAD = 96 >> sub          # >= hme_search2 full-pel reach (+-82)
    oy = (mv16[..., 0] >> sub).clamp(-PAD, PAD).reshape(-1)
    ox = (mv16[..., 1] >> sub).clamp(-PAD, PAD).reshape(-1)
    bi = torch.arange(n16r * n16c, device=center.device)
    wins = _windows(_edge_pad(neigh, PAD)[None],
                    ((bi // n16c) * bs + oy + PAD)[None],
                    ((bi % n16c) * bs + ox + PAD)[None], bs, bs)[0]
    out = wins.reshape(n16r, n16c, bs, bs).permute(0, 2, 1, 3) \
        .reshape(n16r * bs, n16c * bs)
    # the integer sum is exact; the reference's float32 sum of squares is
    # exact too while it stays below 2^24 (always at 8 bit), and / bs^2 is
    # a power-of-two division
    d = out - center
    err = (d * d).reshape(n16r, bs, n16c, bs).sum(
        dim=(1, 3), dtype=torch.int64).to(f32) / (bs * bs)
    return out, err


def tf_filter_device(win_y: torch.Tensor, win_u: torch.Tensor,
                     win_v: torch.Tensor, win_mask: torch.Tensor,
                     strength, bd: int = 8, f32=torch.float32):
    """tf_filter_device: the temporal filter of the window's
    LAST frame (the center) against the others. win_y (T, H, W),
    win_u/win_v (T, Hc, Wc) integer planes; win_mask (T,) float32 (0 = a
    padding slot); strength: a float or a float32 scalar tensor. Returns
    the filtered (y, u, v) int32 planes in [0, 2^bd).

    In the float type f32 throughout (float32 is the encoder's own
    arithmetic), in the reference's order of operations. The noise
    variance is jnp.var's two passes (mean, then mean of squared
    deviations), not a Welford torch.var; divisions by a count use a
    float32 tensor divisor, since a CUDA division by a Python scalar
    multiplies by its reciprocal."""
    T, H, W = win_y.shape
    i32 = torch.int32
    dev = win_y.device
    wy, wu, wv = (w.to(i32) for w in (win_y, win_u, win_v))
    cy, cu, cv = wy[T - 1], wu[T - 1], wv[T - 1]
    g = (cy[:, 1:] - cy[:, :-1]).to(f32)
    n = torch.tensor(g.numel(), dtype=f32, device=dev)
    gc = g - g.sum() / n
    sigma2 = torch.clamp_min((gc * gc).sum() / n / 8.0, 4.0)
    inv = 1.0 / (sigma2 * (1.0 + torch.as_tensor(strength, dtype=f32,
                                                 device=dev)))
    mask = torch.as_tensor(win_mask, dtype=f32, device=dev)
    acc_y, acc_u, acc_v = cy.to(f32), cu.to(f32), cv.to(f32)
    wt_y = torch.ones((H, W), dtype=f32, device=dev)
    wt_c = torch.ones(cu.shape, dtype=f32, device=dev)
    Hc, Wc = cu.shape
    # the neighbours' searches are independent: one batched call
    mvs, _ = hme_search2(cy.expand(T - 1, H, W), wy[:T - 1])
    for i in range(T - 1):
        mv16 = mvs[i].to(i32)
        ay, err = _tf_align(cy, wy[i], mv16, 0, f32)
        w_blk = torch.exp(-err * inv)
        w_blk = torch.where(err > 16.0 * sigma2, 0.0, w_blk) * mask[i]
        w_px = w_blk.repeat_interleave(16, 0).repeat_interleave(16, 1)[:H, :W]
        acc_y += w_px * ay
        wt_y += w_px
        au, _ = _tf_align(cu, wu[i], mv16, 1)
        av, _ = _tf_align(cv, wv[i], mv16, 1)
        w_pc = w_blk.repeat_interleave(8, 0).repeat_interleave(8, 1)[:Hc, :Wc]
        acc_u += w_pc * au
        acc_v += w_pc * av
        wt_c += w_pc
    hi = (1 << bd) - 1
    return tuple(torch.round(a / w).clamp(0, hi).to(i32)
                 for a, w in ((acc_y, wt_y), (acc_u, wt_c), (acc_v, wt_c)))



# --- the GoP program --------------------------------------------------------

EDGE_CHUNK = 8      # prediction edges searched per batched call



def _gop_pack(outs: list, dec: torch.Tensor) -> torch.Tensor:
    """gop_search's packed buffer from the (mv, sad, sad32, sad64) of each
    chunk of edges and the stacked decide buffers."""
    ints = torch.cat([torch.cat(part).to(torch.int32).reshape(-1)
                      for part in zip(*outs)])
    return torch.cat([ints.view(torch.uint8), dec.reshape(-1)])



def gop_search_unpack(buf: np.ndarray, n_frames: int, n_edges: int,
                      shape):
    """Host-side unpack of gop_search. shape = padded (H, W).

    Returns (mv (E, n16r, n16c, 2) int16 full-pel,
             sad (E, n16r, n16c) int32,
             sad32 (E, n32r, n32c) int32, sad64 (E, n64r, n64c) int32,
             decide (F, dsz) uint8 rows for intra_decide_unpack)."""
    H, W = shape
    n16r, n16c = H // 16, W // 16
    n16 = n16r * n16c
    nmv = n_edges * n16 * 2
    nsad = n_edges * n16
    n32 = n_edges * (n16 // 4)
    n64 = n_edges * (n16 // 16)
    tot = nmv + nsad + n32 + n64
    ints = np.frombuffer(buf[:4 * tot].tobytes(), np.int32)
    mv = ints[:nmv].reshape(n_edges, n16r, n16c, 2).astype(np.int16)
    sad = ints[nmv:nmv + nsad].reshape(n_edges, n16r, n16c).copy()
    sad32 = ints[nmv + nsad:nmv + nsad + n32].reshape(
        n_edges, n16r // 2, n16c // 2).copy()
    sad64 = ints[nmv + nsad + n32:tot].reshape(
        n_edges, n16r // 4, n16c // 4).copy()
    dec = buf[4 * tot:].reshape(n_frames, -1)
    return mv, sad, sad32, sad64, dec


def gop_search_tf_unpack(buf: np.ndarray, n_frames: int, n_edges: int,
                         shape, bd: int = 8, n_filtered: int = 1):
    """Host-side unpack of gop_search_tf: returns (mv, sad, sad32,
    sad64, dec, [(fy, fu, fv), ...]) where the first five match
    gop_search_unpack and each filtered anchor's planes are
    uint8/uint16 (H, W) / (Hc, Wc). n_filtered: 1 = ARF only,
    2 = ARF + depth-1 mid."""
    H, W = shape
    hc, wc = H // 2, W // 2
    npl = H * W + 2 * hc * wc
    nbytes = n_filtered * npl * (1 if bd == 8 else 2)
    mv, sad, sad32, sad64, dec = gop_search_unpack(
        buf[:-nbytes], n_frames, n_edges, shape)
    tail = buf[-nbytes:]
    if bd == 8:
        pl = tail
    else:
        pl = np.frombuffer(tail.tobytes(), np.uint16)
    out = []
    for k in range(n_filtered):
        o = k * npl
        fy = pl[o:o + H * W].reshape(H, W)
        fu = pl[o + H * W:o + H * W + hc * wc].reshape(hc, wc)
        fv = pl[o + H * W + hc * wc:o + npl].reshape(hc, wc)
        out.append((fy, fu, fv))
    return mv, sad, sad32, sad64, dec, out


def gop_search(frames: torch.Tensor, edges, split_bias: int, bd: int = 8,
               min_block: int = 8):
    """The GoP program's search part: (mv, sad, sad32, sad64) of every
    edge (E, ...) and the packed decide of every frame (F, dsz), for the
    (F, H, W) frame stack and its (E, 2) (src, ref) edges."""
    dec = torch.stack([intra_decide_packed(f, int(split_bias), bd,
                                           min_block) for f in frames])
    e = torch.as_tensor(np.asarray(edges), dtype=torch.long).to(
        frames.device)
    outs = []
    for chunk in e.split(EDGE_CHUNK):
        src, ref = frames[chunk[:, 0]], frames[chunk[:, 1]]
        mv, sad = hme_search2(src, ref)
        outs.append((mv, sad) + hme_sad_tree(src, ref, mv))
    mv, sad, sad32, sad64 = (torch.cat(part) for part in zip(*outs))
    return mv, sad, sad32, sad64, dec


# --- the loop-restoration search (one program per frame) -------------------

# {min, max} per free tap (spec wiener_taps_min / wiener_taps_max)
_TAP_MIN = (-5, -23, -17)
_TAP_MAX = (10, 8, 46)
_DISTS = (3, 2, 1)          # tap j filters the pixels at +-_DISTS[j]


def lr_unit_grid(pw: int, ph: int, usize: int, stripe_off: int):
    """Restoration-unit extents: columns tile plainly; unit rows are
    stripe-aligned, shifted up by 8 >> subY pixels (libaom's
    RESTORATION_UNIT_OFFSET)."""
    ucols = max((pw + (usize >> 1)) // usize, 1)
    urows = max((ph + (usize >> 1)) // usize, 1)
    xs = [min(uc * usize, pw) for uc in range(ucols)] + [pw]
    ys = [max(ur * usize - stripe_off, 0) for ur in range(urows)] + [ph]
    ys = [min(v, ph) for v in ys]
    return urows, ucols, ys, xs


def _shift2(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """a shifted by +d and -d along axis, edge-replicated, summed."""
    n = a.shape[axis]
    i = torch.arange(n, device=a.device)
    return (a.index_select(axis, (i + d).clamp(0, n - 1)) +
            a.index_select(axis, (i - d).clamp(0, n - 1)))


def _gram(basis: torch.Tensor, rv: torch.Tensor):
    """(B @ B.T, B @ rv) as products summed elementwise (no matmul, so no
    TF32 path)."""
    k = basis.shape[0]
    G = torch.stack([torch.stack([(basis[i] * basis[j]).sum()
                                  for j in range(k)]) for i in range(k)])
    return G, (basis * rv).sum(dim=1)


def lr_search(planes6, dims, bd: int = 8, unit_size=(64, 32, 32),
              f32=torch.float32) -> torch.Tensor:
    """The Wiener restoration search of one frame: for each of the three
    planes, the horizontal then the vertical tap solve on the recon
    against the source, the filtered plane, and the per-unit SSE without
    and with the filter. planes6: the recon's y, u, v then the source's,
    each at its exact (ph, pw) size; dims: [(pw, ph)] per plane. Returns
    per plane [vtaps (3) | htaps (3) | sse_none (n) | sse_wiener (n)],
    concatenated."""
    dev = planes6[0].device
    solve_t = out_t = torch.float64 if f32 == torch.float64 \
        else torch.float32
    hi = float((1 << bd) - 1)
    lo_t = torch.tensor(_TAP_MIN, dtype=f32, device=dev)
    hi_t = torch.tensor(_TAP_MAX, dtype=f32, device=dev)
    ridge = {k: torch.eye(k, dtype=f32, device=dev) * 1e-3 for k in (2, 3)}

    def solve_dir(dgd, src, axis, chroma):
        r = (src - dgd) * 128.0
        first = 1 if chroma else 0
        basis = [_shift2(dgd, d, axis) - 2.0 * dgd for d in _DISTS[first:]]
        B = torch.stack([b[3:-3, 3:-3].reshape(-1) for b in basis])
        G, c = _gram(B, r[3:-3, 3:-3].reshape(-1))
        # torch.linalg has no bfloat16 solve: the system is 2x2 or 3x3,
        # so it is solved in float32 from the (lower precision) sums
        sol, _ = torch.linalg.solve_ex((G + ridge[B.shape[0]]).to(solve_t),
                                       c.to(solve_t), check_errors=False)
        sol = sol.to(f32)
        taps = torch.cat([sol.new_zeros(first), sol])
        taps = torch.clamp(torch.round(taps), lo_t, hi_t)
        if chroma:
            taps = torch.cat([taps.new_zeros(1), taps[1:]])
        return taps

    def filt_dir(dgd, taps, axis):
        out = dgd * 128.0
        for j, d in enumerate(_DISTS):
            out = out + taps[j] * (_shift2(dgd, d, axis) - 2.0 * dgd)
        return out / 128.0

    def unit_sums(err2, ys, xs):
        c = F.pad(err2.cumsum(0).cumsum(1), (1, 0, 1, 0))
        return (c[ys[1:, None], xs[None, 1:]]
                - c[ys[:-1, None], xs[None, 1:]]
                - c[ys[1:, None], xs[None, :-1]]
                + c[ys[:-1, None], xs[None, :-1]])

    outs = []
    for plane in range(3):
        pw, ph = dims[plane]
        _, _, ys, xs = lr_unit_grid(pw, ph, unit_size[plane],
                                    8 >> (1 if plane else 0))
        ys = torch.tensor(ys, dtype=torch.long, device=dev)
        xs = torch.tensor(xs, dtype=torch.long, device=dev)
        dgd = planes6[plane].to(f32)
        src = planes6[3 + plane].to(f32)
        chroma = plane > 0
        ht = solve_dir(dgd, src, 1, chroma)
        dh = filt_dir(dgd, ht, 1)
        vt = solve_dir(dh, src, 0, chroma)
        filt = filt_dir(dh, vt, 0)
        fq = torch.clamp(torch.round(filt), 0.0, hi)
        sse_n = unit_sums((dgd - src) ** 2, ys, xs)
        sse_w = unit_sums((fq - src) ** 2, ys, xs)
        outs.append(torch.cat([vt, ht, sse_n.reshape(-1),
                               sse_w.reshape(-1)]).to(out_t))
    return torch.cat(outs)


# --- the lookahead's per-superblock q offsets -------------------------------

def _activity_halfres(yh: np.ndarray) -> np.ndarray:
    """Per-8x8 gradient activity of a half-res plane."""
    a = yh.astype(np.int32)
    gx = np.abs(np.diff(a, axis=1))
    gy = np.abs(np.diff(a, axis=0))
    act = np.zeros_like(a)
    act[:, :-1] += gx
    act[:-1, :] += gy
    hh, wh = a.shape
    n8r, n8c = hh // 8, wh // 8
    return act[:n8r * 8, :n8c * 8].reshape(n8r, 8, n8c, 8).sum((1, 3))


def _downsample2(y: np.ndarray) -> np.ndarray:
    a = y.astype(np.int32)
    h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
    a = a[:h2, :w2]
    return (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
            + a[1::2, 1::2] + 2) >> 2


def tpl_sb_offsets(cur_y: np.ndarray, future_ys, device, strength=4.0,
                   decay=0.7, max_hops=3, search=None) -> np.ndarray | None:
    """Per-superblock qindex offsets of cur_y from its lookahead frames:
    each future frame's 8x8 blocks credit the area of cur_y their motion
    vector points at with the activity their match saves, and a
    superblock's offset is -strength * log2(1 + credit / own activity),
    made zero-mean, rounded and clipped to +-12. The motion search is the
    single-level full search (hme_search) on `device`; search replaces
    it (the control)."""
    future_ys = [f for f in future_ys][:max_hops]
    if not future_ys:
        return None
    search = search or hme_search
    H, W = cur_y.shape
    ph = (H + 15) // 16 * 16
    pw = (W + 15) // 16 * 16

    def pad(p):
        return np.pad(np.asarray(p), ((0, ph - H), (0, pw - W)),
                      mode="edge")

    cp = pad(cur_y)
    credit = np.zeros((ph // 2, pw // 2), np.float64)
    for k, fy in enumerate(future_ys):
        fp = pad(fy)
        mv16, sad16 = search(torch.from_numpy(fp).to(device),
                             torch.from_numpy(cp).to(device))
        mv16 = mv16.cpu().numpy().astype(np.int64)
        sad16 = sad16.cpu().numpy().astype(np.int64)
        act = _activity_halfres(_downsample2(fp))
        ben = np.clip(act - sad16, 0, None).astype(np.float64) \
            * (decay ** (k + 1))
        n8r, n8c = ben.shape
        hh, wh = credit.shape
        for br in range(n8r):
            for bc in range(n8c):
                b = ben[br, bc]
                if b <= 0:
                    continue
                y0 = br * 8 + int(mv16[br, bc, 0]) // 2
                x0 = bc * 8 + int(mv16[br, bc, 1]) // 2
                y0 = max(0, min(y0, hh - 8))
                x0 = max(0, min(x0, wh - 8))
                credit[y0:y0 + 8, x0:x0 + 8] += b / 64.0

    self_cost = _activity_halfres(_downsample2(cp)).astype(np.float64)
    cost_px = np.repeat(np.repeat(self_cost / 64.0, 8, 0), 8, 1)
    sb_rows = (H + 63) // 64
    sb_cols = (W + 63) // 64

    def sb_sum(plane):
        p = np.zeros((sb_rows * 32, sb_cols * 32), np.float64)
        p[:plane.shape[0], :plane.shape[1]] = \
            plane[:sb_rows * 32, :sb_cols * 32]
        return p.reshape(sb_rows, 32, sb_cols, 32).sum((1, 3))

    cred_sb = sb_sum(credit)
    cost_sb = sb_sum(cost_px)
    r = cred_sb / np.maximum(cost_sb, 1.0)
    off = -strength * np.log2(1.0 + r)
    off -= off.mean()
    return np.clip(np.rint(off), -12, 12).astype(np.int32)
