"""Super-resolution: the normative horizontal upscaler + encoder downscale.

AV1 super-res codes the frame at a horizontally downscaled width
(FrameWidth = (UpscaledWidth * 8 + denom/2) / denom, denom 9..16) and
upscales the reconstruction back to UpscaledWidth between CDEF and loop
restoration (spec 7.16 av1_superres_upscale). The upscale is NORMATIVE:
a 64-phase 8-tap polyphase filter (constants/av1_tables.npz
``superres_filter``; spec Upscale_Filter) driven by 14-bit fixed-point
source positions. The encoder-side DOWNSCALE is non-normative (any
filter); we use a windowed box+linear kernel.

Reference counterparts (behavioral): Source/Lib/Codec/resize.c
(av1_upscale_normative_rows), super_res.{c,h}.
"""
from __future__ import annotations

import numpy as np

SUPERRES_NUM = 8
SUPERRES_DENOM_MIN = 9
SUPERRES_DENOM_MAX = 16
_SCALE_BITS = 14                      # RS_SCALE_SUBPEL_BITS
_SCALE_MASK = (1 << _SCALE_BITS) - 1
_EXTRA_BITS = 8                       # RS_SCALE_EXTRA_BITS
_FILTER_BITS = 7


def superres_coded_width(upscaled_w: int, denom: int) -> int:
    """spec 5.9.8 compute_superres_size."""
    return (upscaled_w * SUPERRES_NUM + denom // 2) // denom


def _cdiv(a: int, b: int) -> int:
    """C-style integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _upscale_params(down_w: int, up_w: int):
    step = ((down_w << _SCALE_BITS) + up_w // 2) // up_w
    err = up_w * step - (down_w << _SCALE_BITS)
    x0 = _cdiv(-((up_w - down_w) << (_SCALE_BITS - 1)) + up_w // 2,
               up_w) + (1 << (_EXTRA_BITS - 1)) - _cdiv(err, 2)
    return step, x0 & _SCALE_MASK


def superres_upscale_plane(plane: np.ndarray, up_w: int, denom: int,
                           bd: int = 8, tile_dx=None,
                           down_w: int = 0) -> np.ndarray:
    """Normative horizontal upscale of one plane (spec 7.16): every
    output column convolves 8 source taps selected by the 14-bit
    position accumulator, phases from the 64-entry Upscale_Filter.
    The position math runs per tile column with the subpel accumulator
    carried across tiles (ref resize.c av1_upscale_normative_rows);
    taps clamp at the PLANE edges — pass a plane covering the full mi
    area so taps past an odd display width read the real reconstructed
    pixels (matches dav1d). down_w: the coded display width the
    positions derive from (default: the plane width). tile_dx:
    downscaled x starts of the tile columns, ending with down_w."""
    from svt_av1_psy_tpu_torch.constants import tables
    filt = tables()["superres_filter"].astype(np.int32)     # (64, 8)
    avail_w = plane.shape[1]
    down_w = down_w or avail_w
    if down_w == up_w:
        return plane[:, :down_w].copy()
    if tile_dx is None:
        tile_dx = [0, down_w]
    step, x0_qn = _upscale_params(down_w, up_w)
    src = plane.astype(np.int32)
    out = np.zeros((plane.shape[0], up_w), plane.dtype)
    n_tiles = len(tile_dx) - 1
    for j in range(n_tiles):
        dx0, dx1 = tile_dx[j], tile_dx[j + 1]
        src_w = dx1 - dx0
        ux0 = (dx0 * denom) // SUPERRES_NUM
        ux1 = up_w if j == n_tiles - 1 else (dx1 * denom) // SUPERRES_NUM
        x_qn = x0_qn + np.arange(ux1 - ux0, dtype=np.int64) * step
        base = (x_qn >> _SCALE_BITS).astype(np.int64)
        phase = ((x_qn & _SCALE_MASK) >> _EXTRA_BITS).astype(np.int64)
        acc = np.zeros((plane.shape[0], ux1 - ux0), np.int32)
        # taps span [base-4, base+3]: the convolve recenters by
        # -(TAPS/2 - 1) AND its caller passes input - 1 (ref
        # super_res.c:56 src -= 3 + :131 "input - 1"), so the masked
        # x0_qn is defined against a -4 kernel origin. Taps clamp at
        # FRAME edges only; interior tile boundaries read the real
        # neighboring pixels (ref upscale_normative_rect pads only at
        # pad_left/pad_right = frame edges)
        for k in range(8):
            cols = np.clip(dx0 + base + k - 4, 0, avail_w - 1)
            acc += src[:, cols] * filt[phase, k][None, :]
        res = (acc + (1 << (_FILTER_BITS - 1))) >> _FILTER_BITS
        out[:, ux0:ux1] = np.clip(res, 0, (1 << bd) - 1)
        x0_qn += (ux1 - ux0) * step - (src_w << _SCALE_BITS)
    return out


def superres_upscale_frame(planes, up_w: int, denom: int, bd: int = 8,
                           tile_mi_starts=None, coded_w: int = 0):
    """Upscale (y, u, v) planes; chroma upscales to (up_w+1)//2.
    Pass planes covering the mi area (wider than coded_w) so edge taps
    read real pixels. coded_w: display width of the coded frame
    (default: luma plane width). tile_mi_starts: tile-column starts in
    mi units (ending at mi_cols), None = single tile."""
    y, u, v = planes
    cw = (up_w + 1) // 2
    dw = coded_w or y.shape[1]
    cdw = (dw + 1) // 2
    dy = du = None
    if tile_mi_starts is not None:
        dy = [min(m * 4, dw) for m in tile_mi_starts]
        dy[-1] = dw
        du = [min((m * 4) >> 1, cdw) for m in tile_mi_starts]
        du[-1] = cdw
    return (superres_upscale_plane(y, up_w, denom, bd, dy, dw),
            superres_upscale_plane(u, cw, denom, bd, du, cdw),
            superres_upscale_plane(v, cw, denom, bd, du, cdw))


def downscale_horiz(plane: np.ndarray, down_w: int) -> np.ndarray:
    """Encoder-side horizontal downscale (non-normative): box-average
    over the source span of each output column, linear-weighted at the
    span edges. Adequate low-pass for denoms 9..16 (scale <= 2)."""
    w = plane.shape[1]
    if down_w == w:
        return plane.copy()
    a = plane.astype(np.float64)
    scale = w / down_w
    out = np.zeros((plane.shape[0], down_w), np.float64)
    for x in range(down_w):
        lo = x * scale
        hi = lo + scale
        i0, i1 = int(np.floor(lo)), int(np.ceil(hi))
        idx = np.arange(i0, min(i1, w))
        wts = np.minimum(idx + 1, hi) - np.maximum(idx, lo)
        out[:, x] = (a[:, idx] * wts[None, :]).sum(1) / wts.sum()
    return np.clip(np.rint(out), 0,
                   np.iinfo(plane.dtype).max).astype(plane.dtype)
