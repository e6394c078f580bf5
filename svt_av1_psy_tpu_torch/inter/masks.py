"""Blend masks for masked compound + inter-intra prediction.

Normative AV1 constructions (spec 7.11.3.11-7.11.3.13):

- wedge masks: the 64x64 master ramps (`Wedge_Master_*`, normative spec
  constants) shifted/transposed into six directions, indexed through the
  per-shape 16-entry codebooks with the sign-flip rule derived from the
  boundary average (ref inter_prediction.c:1960-2126
  init_wedge_primary_masks / init_wedge_signs / get_wedge_mask_inplace).
- inter-intra smooth masks from the 1-D decay table (ref
  inter_prediction.c:2128 ii_weights1d / build_smooth_interintra_mask).
- DIFFWTD masks from intermediate-precision prediction differences (ref
  C_DEFAULT/inter_prediction_c.c diffwtd_mask_d16).
- the blend kernels: pixel-domain a64 blend (inter-intra) and the
  d16 (CONV_BUF) masked blend with compound rounding (ref
  svt_aom_lowbd_blend_a64_d16_mask semantics).

Everything is built once at import from the three 64-entry ramps; no mask
tables are stored.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from svt_av1_psy_tpu_torch.ops.mc import COMPOUND_ROUND1, FILTER_BITS, ROUND0

MASK_MASTER = 64

# Wedge_Master_Oblique_Odd / _Even / _Vertical (normative spec constants)
_RAMP_OBL_ODD = np.array(
    [0] * 28 + [1, 2, 6, 18, 37, 53, 60, 63] + [64] * 28, np.int32)
_RAMP_OBL_EVEN = np.array(
    [0] * 28 + [1, 4, 11, 27, 46, 58, 62, 63] + [64] * 28, np.int32)
_RAMP_VERT = np.array(
    [0] * 29 + [2, 7, 21, 43, 57, 62] + [64] * 29, np.int32)

# directions
_HORIZONTAL, _VERTICAL, _OBLIQUE27, _OBLIQUE63, _OBLIQUE117, _OBLIQUE153 = \
    range(6)


def _shift_copy(src: np.ndarray, shift: int) -> np.ndarray:
    w = len(src)
    dst = np.empty_like(src)
    if shift >= 0:
        dst[shift:] = src[:w - shift]
        dst[:shift] = src[0]
    else:
        shift = -shift
        dst[:w - shift] = src[shift:]
        dst[w - shift:] = src[-1]
    return dst


def _build_masters():
    """64x64 master masks per direction, [neg][direction] layout."""
    n = MASK_MASTER
    obl63 = np.zeros((n, n), np.int32)
    shift = n // 4
    for i in range(0, n, 2):
        obl63[i] = _shift_copy(_RAMP_OBL_EVEN, shift)
        shift -= 1
        obl63[i + 1] = _shift_copy(_RAMP_OBL_ODD, shift)
    vert = np.broadcast_to(_RAMP_VERT, (n, n)).copy()
    m = np.zeros((2, 6, n, n), np.int32)
    m[0, _OBLIQUE63] = obl63
    m[0, _OBLIQUE27] = obl63.T
    m[0, _OBLIQUE117] = 64 - obl63[:, ::-1]
    m[0, _OBLIQUE153] = 64 - obl63.T[::-1, :]
    m[0, _VERTICAL] = vert
    m[0, _HORIZONTAL] = vert.T
    m[1] = 64 - m[0]
    return m


_MASTERS = _build_masters()

# wedge codebooks (spec Wedge_Codebook): (direction, x_offset, y_offset)
_CB_HGTW = [  # taller than wide
    (_OBLIQUE27, 4, 4), (_OBLIQUE63, 4, 4), (_OBLIQUE117, 4, 4),
    (_OBLIQUE153, 4, 4), (_HORIZONTAL, 4, 2), (_HORIZONTAL, 4, 4),
    (_HORIZONTAL, 4, 6), (_VERTICAL, 4, 4), (_OBLIQUE27, 4, 2),
    (_OBLIQUE27, 4, 6), (_OBLIQUE153, 4, 2), (_OBLIQUE153, 4, 6),
    (_OBLIQUE63, 2, 4), (_OBLIQUE63, 6, 4), (_OBLIQUE117, 2, 4),
    (_OBLIQUE117, 6, 4)]
_CB_HLTW = [  # wider than tall
    (_OBLIQUE27, 4, 4), (_OBLIQUE63, 4, 4), (_OBLIQUE117, 4, 4),
    (_OBLIQUE153, 4, 4), (_VERTICAL, 2, 4), (_VERTICAL, 4, 4),
    (_VERTICAL, 6, 4), (_HORIZONTAL, 4, 4), (_OBLIQUE27, 4, 2),
    (_OBLIQUE27, 4, 6), (_OBLIQUE153, 4, 2), (_OBLIQUE153, 4, 6),
    (_OBLIQUE63, 2, 4), (_OBLIQUE63, 6, 4), (_OBLIQUE117, 2, 4),
    (_OBLIQUE117, 6, 4)]
_CB_HEQW = [  # square
    (_OBLIQUE27, 4, 4), (_OBLIQUE63, 4, 4), (_OBLIQUE117, 4, 4),
    (_OBLIQUE153, 4, 4), (_HORIZONTAL, 4, 2), (_HORIZONTAL, 4, 6),
    (_VERTICAL, 2, 4), (_VERTICAL, 6, 4), (_OBLIQUE27, 4, 2),
    (_OBLIQUE27, 4, 6), (_OBLIQUE153, 4, 2), (_OBLIQUE153, 4, 6),
    (_OBLIQUE63, 2, 4), (_OBLIQUE63, 6, 4), (_OBLIQUE117, 2, 4),
    (_OBLIQUE117, 6, 4)]

# bsize -> (w, h) for the wedge-capable sizes (AV1 BlockSize enum indices)
WEDGE_SIZES = {3: (8, 8), 4: (8, 16), 5: (16, 8), 6: (16, 16),
               7: (16, 32), 8: (32, 16), 9: (32, 32), 18: (8, 32),
               19: (32, 8)}


def wedge_used(bsize: int) -> bool:
    return bsize in WEDGE_SIZES


def interintra_wedge_used(bsize: int) -> bool:
    # is_interintra_wedge_used: the interintra-allowed range 8x8..32x32
    # (enum), all of which have wedge bits
    return 3 <= bsize <= 9


def _codebook(w: int, h: int):
    if h > w:
        return _CB_HGTW
    if h < w:
        return _CB_HLTW
    return _CB_HEQW


def _mask_inplace(bsize: int, windex: int, neg: int) -> np.ndarray:
    w, h = WEDGE_SIZES[bsize]
    direction, xo, yo = _codebook(w, h)[windex]
    woff = (xo * w) >> 3
    hoff = (yo * h) >> 3
    r0 = MASK_MASTER // 2 - hoff
    c0 = MASK_MASTER // 2 - woff
    return _MASTERS[neg, direction, r0:r0 + h, c0:c0 + w]


@lru_cache(maxsize=None)
def _signflip(bsize: int, windex: int) -> int:
    """init_wedge_signs rule: default sign 1 when the top/left boundary
    average of the primary mask is below 32."""
    w, h = WEDGE_SIZES[bsize]
    m = _mask_inplace(bsize, windex, 0)
    avg = int(m[0, :w].sum()) + int(m[1:h, 0].sum())
    avg = (avg + (w + h - 1) // 2) // (w + h - 1)
    return int(avg < 32)


@lru_cache(maxsize=None)
def get_wedge_mask(bsize: int, windex: int, sign: int) -> np.ndarray:
    """(h, w) int32 mask in [0, 64]; weight applies to prediction 0."""
    return _mask_inplace(bsize, windex, sign ^ _signflip(bsize, windex))


# --- inter-intra smooth masks -------------------------------------------

# ii_weights1d (normative; ref inter_prediction.c:2128)
II_WEIGHTS_1D = np.array([
    60, 58, 56, 54, 52, 50, 48, 47, 45, 44, 42, 41, 39, 38, 37, 35, 34,
    33, 32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 22, 21, 20, 19, 19,
    18, 18, 17, 16, 16, 15, 15, 14, 14, 13, 13, 12, 12, 12, 11, 11, 10,
    10, 10, 9, 9, 9, 8, 8, 8, 8, 7, 7, 7, 7, 6, 6, 6, 6, 6, 5, 5, 5, 5,
    5, 4, 4, 4, 4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1], np.int32)

II_DC, II_V, II_H, II_SMOOTH = range(4)


def smooth_interintra_mask(mode: int, w: int, h: int) -> np.ndarray:
    """(h, w) mask, weight on the INTRA prediction. size_scale =
    128 / max(dim) reproduces ii_size_scales[] exactly."""
    ss = 128 // max(w, h)
    if mode == II_V:
        return np.broadcast_to(
            II_WEIGHTS_1D[np.arange(h) * ss][:, None], (h, w)).copy()
    if mode == II_H:
        return np.broadcast_to(
            II_WEIGHTS_1D[np.arange(w) * ss][None, :], (h, w)).copy()
    if mode == II_SMOOTH:
        idx = np.minimum(np.arange(h)[:, None], np.arange(w)[None, :])
        return II_WEIGHTS_1D[idx * ss]
    return np.full((h, w), 32, np.int32)


def subsample_mask(mask: np.ndarray, subw: int, subh: int) -> np.ndarray:
    """blend_a64 mask subsampling for chroma planes."""
    if not subw and not subh:
        return mask
    if subw and subh:
        s = (mask[0::2, 0::2] + mask[0::2, 1::2] + mask[1::2, 0::2] +
             mask[1::2, 1::2])
        return (s + 2) >> 2
    if subw:
        return (mask[:, 0::2] + mask[:, 1::2] + 1) >> 1
    return (mask[0::2, :] + mask[1::2, :] + 1) >> 1


# --- blends ---------------------------------------------------------------

def blend_a64(mask: np.ndarray, p0: np.ndarray, p1: np.ndarray):
    """Pixel-domain blend: mask weights p0 (spec 7.11.3.14)."""
    return (mask * p0 + (64 - mask) * p1 + 32) >> 6


def blend_masked_d16(mask: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                     bd: int = 8) -> np.ndarray:
    """Masked blend of two CONV_BUF components + compound final rounding
    (ref svt_aom_lowbd/highbd_blend_a64_d16_mask)."""
    r0, r1 = ROUND0, COMPOUND_ROUND1
    offset_bits = bd + 2 * FILTER_BITS - r0
    round_offset = (1 << (offset_bits - r1)) + (1 << (offset_bits - r1 - 1))
    round_bits = 2 * FILTER_BITS - r0 - r1
    res = (mask * p0 + (64 - mask) * p1) >> 6
    res = res - round_offset
    res = (res + (1 << (round_bits - 1))) >> round_bits
    return np.clip(res, 0, (1 << bd) - 1)


DIFF_FACTOR = 16


def diffwtd_mask_d16(p0: np.ndarray, p1: np.ndarray, mask_type: int,
                     bd: int = 8) -> np.ndarray:
    """DIFFWTD_38 / DIFFWTD_38_INV mask from CONV_BUF predictions (ref
    diffwtd_mask_d16)."""
    rnd = 2 * FILTER_BITS - ROUND0 - COMPOUND_ROUND1 + (bd - 8)
    diff = np.abs(p0 - p1)
    diff = (diff + (1 << (rnd - 1))) >> rnd
    m = np.clip(38 + diff // DIFF_FACTOR, 0, 64)
    return 64 - m if mask_type else m
