"""Normative loop restoration — Wiener + self-guided filters (spec 7.17).

Kernel semantics mirror the reference C (ref restoration.c
selfguided_restoration_{fast_,}internal / svt_apply_selfguided_restoration_c
and convolve.c svt_av1_wiener_convolve_add_src_c), property-tested
bit-exact. 8-bit.
"""
from __future__ import annotations

import numpy as np

SGR_PARAMS = [(2, 140, 1, 3236), (2, 112, 1, 2158), (2, 93, 1, 1618), (2, 80, 1, 1438), (2, 70, 1, 1295), (2, 58, 1, 1177), (2, 47, 1, 1079), (2, 37, 1, 996), (2, 30, 1, 925), (2, 25, 1, 863), (0, -1, 1, 2589), (0, -1, 1, 1618), (0, -1, 1, 1177), (0, -1, 1, 925), (2, 56, 0, -1), (2, 22, 0, -1)]
X_BY_XPLUS1 = [1, 128, 171, 192, 205, 213, 219, 224, 228, 230, 233, 235, 236, 238, 239, 240, 241, 242, 243, 243, 244, 244, 245, 245, 246, 246, 247, 247, 247, 247, 248, 248, 248, 248, 249, 249, 249, 249, 249, 250, 250, 250, 250, 250, 250, 250, 251, 251, 251, 251, 251, 251, 251, 251, 251, 251, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 256]
ONE_BY_X = [4096, 2048, 1365, 1024, 819, 683, 585, 512, 455, 410, 372, 341, 315, 293, 273, 256, 241, 228, 216, 205, 195, 186, 178, 171, 164]


SGRPROJ_RST_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_SGR_BITS = 8
SGRPROJ_SGR = 1 << SGRPROJ_SGR_BITS
SGRPROJ_RECIP_BITS = 12
FILTER_BITS = 7
WIENER_ROUND0 = 3
WIENER_ROUND1 = 2 * FILTER_BITS - WIENER_ROUND0

_XB = np.array(X_BY_XPLUS1, np.int64)
_OB = np.array(ONE_BY_X, np.int64)


def _r2(v, n):
    return (v + (1 << (n - 1))) >> n


def _boxsum(img: np.ndarray, r: int, sqr: bool) -> np.ndarray:
    """(2r+1)^2 windowed sums over an already-padded image; output has the
    same shape, valid where the window fits."""
    x = img.astype(np.int64)
    if sqr:
        x = x * x
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    H, W = img.shape
    out = np.zeros((H, W), np.int64)
    ys0 = np.clip(np.arange(H) - r, 0, H)
    ys1 = np.clip(np.arange(H) + r + 1, 0, H)
    xs0 = np.clip(np.arange(W) - r, 0, W)
    xs1 = np.clip(np.arange(W) + r + 1, 0, W)
    out = (c[ys1[:, None], xs1[None, :]] - c[ys0[:, None], xs1[None, :]]
           - c[ys1[:, None], xs0[None, :]] + c[ys0[:, None], xs0[None, :]])
    return out


def _sgr_ab(dgd_ext: np.ndarray, r: int, s: int, bd: int):
    """A/B fields over the extended grid (valid on [1:-1] of the interior
    +-1 ring, matching the reference border handling)."""
    Bs = _boxsum(dgd_ext, r, False)
    As = _boxsum(dgd_ext, r, True)
    n = (2 * r + 1) ** 2
    a = _r2(As, 2 * (bd - 8)) if bd > 8 else As
    b = _r2(Bs, bd - 8) if bd > 8 else Bs
    p = np.maximum(a * n - b * b, 0)
    z = _r2(p * s, SGRPROJ_MTABLE_BITS)
    A = _XB[np.minimum(z, 255)]
    B = _r2((SGRPROJ_SGR - A) * Bs * _OB[n - 1], SGRPROJ_RECIP_BITS)
    return A, B


def sgr_filters(dgd_ext: np.ndarray, w: int, h: int, ep: int,
                bd: int = 8):
    """flt0/flt1 for one processing unit. dgd_ext: (h+6, w+6) with the unit
    at [3:3+h, 3:3+w] and 3-px borders (ref selfguided_restoration_c)."""
    r0, s0, r1, s1 = SGR_PARAMS[ep]
    flt0 = flt1 = None
    d = dgd_ext.astype(np.int64)
    if r0 > 0:
        A, B = _sgr_ab(d, r0, s0, bd)
        flt0 = np.zeros((h, w), np.int64)
        # rows -1..h computed on the 3-offset grid; weights per parity
        for i in range(h):
            ky = 3 + i
            if not (i & 1):
                a = ((A[ky - 1, 2:w + 4] + A[ky + 1, 2:w + 4]))
                # cross/diag weights on rows above/below (fast path)
                ac = (A[ky - 1, 3:w + 3] + A[ky + 1, 3:w + 3]) * 6 + \
                     (A[ky - 1, 2:w + 2] + A[ky + 1, 2:w + 2] +
                      A[ky - 1, 4:w + 4] + A[ky + 1, 4:w + 4]) * 5
                bc = (B[ky - 1, 3:w + 3] + B[ky + 1, 3:w + 3]) * 6 + \
                     (B[ky - 1, 2:w + 2] + B[ky + 1, 2:w + 2] +
                      B[ky - 1, 4:w + 4] + B[ky + 1, 4:w + 4]) * 5
                nb = 5
            else:
                ac = A[ky, 3:w + 3] * 6 + \
                    (A[ky, 2:w + 2] + A[ky, 4:w + 4]) * 5
                bc = B[ky, 3:w + 3] * 6 + \
                    (B[ky, 2:w + 2] + B[ky, 4:w + 4]) * 5
                nb = 4
            v = ac * d[ky, 3:w + 3] + bc
            flt0[i] = _r2(v, SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS)
    if r1 > 0:
        A, B = _sgr_ab(d, r1, s1, bd)
        nb = 5
        ac = ((A[2:h + 2, 3:w + 3] + A[4:h + 4, 3:w + 3] +
               A[3:h + 3, 2:w + 2] + A[3:h + 3, 4:w + 4] +
               A[3:h + 3, 3:w + 3]) * 4 +
              (A[2:h + 2, 2:w + 2] + A[2:h + 2, 4:w + 4] +
               A[4:h + 4, 2:w + 2] + A[4:h + 4, 4:w + 4]) * 3)
        bc = ((B[2:h + 2, 3:w + 3] + B[4:h + 4, 3:w + 3] +
               B[3:h + 3, 2:w + 2] + B[3:h + 3, 4:w + 4] +
               B[3:h + 3, 3:w + 3]) * 4 +
              (B[2:h + 2, 2:w + 2] + B[2:h + 2, 4:w + 4] +
               B[4:h + 4, 2:w + 2] + B[4:h + 4, 4:w + 4]) * 3)
        v = ac * d[3:h + 3, 3:w + 3] + bc
        flt1 = _r2(v, SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS)
    return flt0, flt1


def apply_sgr(dgd_ext: np.ndarray, w: int, h: int, ep: int, xqd,
              bd: int = 8) -> np.ndarray:
    """Self-guided restoration of one unit (ref
    svt_apply_selfguided_restoration_c)."""
    r0, s0, r1, s1 = SGR_PARAMS[ep]
    flt0, flt1 = sgr_filters(dgd_ext, w, h, ep, bd)
    if r0 == 0:
        xq = (0, (1 << SGRPROJ_PRJ_BITS) - xqd[1])
    elif r1 == 0:
        xq = (xqd[0], 0)
    else:
        xq = (xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1])
    u = dgd_ext[3:3 + h, 3:3 + w].astype(np.int64) << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if r0 > 0:
        v = v + xq[0] * (flt0 - u)
    if r1 > 0:
        v = v + xq[1] * (flt1 - u)
    out = _r2(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)


def apply_wiener(src_ext: np.ndarray, w: int, h: int, taps_h, taps_v,
                 bd: int = 8) -> np.ndarray:
    """Wiener restoration of one unit. src_ext: (h+6, w+6), unit at
    [3:3+h, 3:3+w] (ref svt_av1_wiener_convolve_add_src_c)."""
    h0, h1, h2 = taps_h
    v0, v1, v2 = taps_v
    hf = np.array([h0, h1, h2, -2 * (h0 + h1 + h2), h2, h1, h0],
                  np.int64)
    vf = np.array([v0, v1, v2, -2 * (v0 + v1 + v2), v2, v1, v0],
                  np.int64)
    s = src_ext.astype(np.int64)
    clamp_hi = (1 << (bd + 1 + FILTER_BITS - WIENER_ROUND0)) - 1
    # horizontal over rows -3..h+2 of the unit
    ih = h + 6
    tmp = np.zeros((ih, w), np.int64)
    acc = sum(int(hf[k]) * s[:, k:k + w] for k in range(7))
    acc = acc + (s[:, 3:3 + w] << FILTER_BITS) + (1 << (bd + FILTER_BITS - 1))
    tmp = np.clip(_r2(acc - (1 << (WIENER_ROUND0 - 1)) +
                      (1 << (WIENER_ROUND0 - 1)), WIENER_ROUND0), 0,
                  clamp_hi)
    # vertical
    acc2 = sum(int(vf[k]) * tmp[k:k + h, :] for k in range(7))
    acc2 = acc2 + (tmp[3:3 + h, :] << FILTER_BITS) - \
        (1 << (bd + WIENER_ROUND1 - 1))
    out = _r2(acc2, WIENER_ROUND1)
    return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)


def _unit_ext(cdef_plane, deblock_plane, x0, y0, w, h, pw, ph,
              stripe_base):
    """Build the (h+6, w+6) extended input for a stripe-piece: interior
    from the CDEF output; rows outside the stripe come from the deblocked
    frame (2 rows, third duplicated); frame edges replicate
    (spec 7.17.2 / ref setup_processing_stripe_boundary)."""
    ext = np.zeros((h + 6, w + 6), np.int32)
    ys = np.arange(y0 - 3, y0 + h + 3)
    xs = np.clip(np.arange(x0 - 3, x0 + w + 3), 0, pw - 1)
    s_top, s_bot = stripe_base            # stripe row range [s_top, s_bot)
    for i, y in enumerate(ys):
        if s_top <= y < s_bot:
            src = cdef_plane
            yy = y
        elif y < s_top:
            yy = max(s_top - 2, 0) if y <= s_top - 2 else y
            if s_top == 0:
                src = cdef_plane
                yy = 0
            else:
                src = deblock_plane
                yy = min(max(y, s_top - 2), s_top - 1)
        else:
            if s_bot >= ph:
                src = cdef_plane
                yy = ph - 1
            else:
                src = deblock_plane
                yy = min(y, s_bot + 1)
        ext[i] = src[yy, xs]
    return ext


def apply_lr_frame(cdef_planes, deblock_planes, dims, lr_type, unit_size,
                   units, bd: int = 8):
    """Loop restoration over the whole frame, in place on cdef_planes.

    cdef_planes: post-CDEF recon (list of 3 arrays, padded ok);
    deblock_planes: post-deblock pre-CDEF copies (for stripe boundaries);
    dims: [(w, h)]*3; units: per-plane {(ur, uc): info} from the parser.
    Stripes are 64 px tall, offset so that the first is 56 px
    (spec 7.17: StripeStartY = -8 alignment), unit-clipped.
    """
    out_planes = [p.copy() for p in cdef_planes]
    for plane in range(3):
        if not lr_type[plane] or not units[plane]:
            continue
        sub = 1 if plane else 0
        pw, ph = dims[plane]
        usize = unit_size[plane]
        ucols = max((pw + (usize >> 1)) // usize, 1)
        urows = max((ph + (usize >> 1)) // usize, 1)
        stripe_h = 64 >> sub
        stripe_off = 8 >> sub
        for (ur, uc), info in units[plane].items():
            if info["type"] == 0:
                continue
            ux0 = uc * usize
            # unit ROWS are stripe-aligned: shifted up by 8>>subY px
            # (libaom RESTORATION_UNIT_OFFSET; dav1d lr_apply), so unit
            # row r spans [r*usize - off, (r+1)*usize - off), last row
            # extended to the plane bottom
            uy0 = max(ur * usize - stripe_off, 0)
            uy1 = (ur + 1) * usize - stripe_off
            ux1 = min(ux0 + usize, pw) if uc < ucols - 1 else pw
            if uc == ucols - 1:
                ux1 = pw
            if ur == urows - 1 or uy1 > ph:
                uy1 = ph
            # walk stripes covering [uy0, uy1)
            y = uy0
            while y < uy1:
                # stripe containing y (stripes are aligned to
                # multiples of stripe_h shifted up by stripe_off)
                s_idx = (y + stripe_off) // stripe_h
                s_top = s_idx * stripe_h - stripe_off
                s_bot = s_top + stripe_h
                s_top = max(s_top, 0)
                seg_top = max(y, s_top)
                seg_bot = min(uy1, s_bot)
                h = seg_bot - seg_top
                w = ux1 - ux0
                ext = _unit_ext(cdef_planes[plane], deblock_planes[plane],
                                ux0, seg_top, w, h, pw, ph,
                                (s_top, min(s_bot, ph)))
                if info["type"] == 1:
                    res = apply_wiener(ext, w, h, info["hfilter"],
                                       info["vfilter"], bd)
                else:
                    res = apply_sgr(ext, w, h, info["ep"], info["xqd"], bd)
                out_planes[plane][seg_top:seg_bot, ux0:ux1] = res
                y = seg_bot
        cdef_planes[plane][:ph, :pw] = out_planes[plane][:ph, :pw]
