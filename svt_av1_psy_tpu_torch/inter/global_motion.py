"""Global motion: translation estimation + parameter coding helpers.

The reference estimates global motion with FAST corners + RANSAC
(ref Source/Lib/Codec/global_me.c:126, corner_detect.c, ransac.c) and
codes the params with bool-coded finite subexponential deltas against
the primary reference frame's params
(ref entropy_coding.c:2958 write_global_motion_params,
definitions.h:1963-1988 GM_* constants).

TPU-native stance: the corner+RANSAC pipeline is replaced by a robust
fit over the dense per-16x16 HME motion field the device already
produces — a median/inlier-consensus translation (the dominant use of
GM at fast presets). The field comes straight from
ops/jax_backend.hme_search; no extra device work is needed.

Units: wmmat translation params are 1/(1<<16) px (WARPEDMODEL_PREC_BITS);
motion vectors are 1/8 px (mv8 = wmmat >> 13).
"""
from __future__ import annotations

import numpy as np

WARPEDMODEL_PREC_BITS = 16
GM_TRANS_PREC_BITS = 6
GM_ABS_TRANS_BITS = 12
GM_ABS_TRANS_ONLY_BITS = GM_ABS_TRANS_BITS - GM_TRANS_PREC_BITS + 3  # 9
GM_TRANS_PREC_DIFF = WARPEDMODEL_PREC_BITS - GM_TRANS_PREC_BITS
GM_TRANS_ONLY_PREC_BITS = 3
GM_TRANS_ONLY_PREC_DIFF = WARPEDMODEL_PREC_BITS - GM_TRANS_ONLY_PREC_BITS
SUBEXPFIN_K = 3

IDENTITY, TRANSLATION, ROTZOOM, AFFINE = 0, 1, 2, 3


# --- bool-coded finite subexponential (spec 5.9.26-5.9.29) -------------------

def _recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def _inv_recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _recenter_finite_nonneg(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _recenter_nonneg(r, v)
    return _recenter_nonneg(n - 1 - r, n - 1 - v)


def _inv_recenter_finite_nonneg(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _inv_recenter_nonneg(r, v)
    return n - 1 - _inv_recenter_nonneg(n - 1 - r, v)


def _ceil_log2(n: int) -> int:
    return max(n - 1, 0).bit_length()


def write_primitive_quniform(w, n: int, v: int) -> None:
    if n <= 1:
        return
    ll = _ceil_log2(n)
    m = (1 << ll) - n
    if v < m:
        w.f(v, ll - 1)
    else:
        w.f(m + ((v - m) >> 1), ll - 1)
        w.f((v - m) & 1, 1)


def read_primitive_quniform(r, n: int) -> int:
    if n <= 1:
        return 0
    ll = _ceil_log2(n)
    m = (1 << ll) - n
    v = r.f(ll - 1)
    return v if v < m else (v << 1) - m + r.f(1)


def write_primitive_subexpfin(w, n: int, k: int, v: int) -> None:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            write_primitive_quniform(w, n - mk, v - mk)
            return
        t = int(v >= mk + a)
        w.f(t, 1)
        if t:
            i += 1
            mk += a
        else:
            w.f(v - mk, b)
            return


def read_primitive_subexpfin(r, n: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return read_primitive_quniform(r, n - mk) + mk
        if r.f(1):
            i += 1
            mk += a
        else:
            return r.f(b) + mk


def write_signed_primitive_refsubexpfin(w, n: int, k: int, ref: int,
                                        v: int) -> None:
    ref += n - 1
    v += n - 1
    sn = (n << 1) - 1
    write_primitive_subexpfin(w, sn, k, _recenter_finite_nonneg(sn, ref, v))


def read_signed_primitive_refsubexpfin(r, n: int, k: int, ref: int) -> int:
    ref += n - 1
    sn = (n << 1) - 1
    v = _inv_recenter_finite_nonneg(sn, ref,
                                    read_primitive_subexpfin(r, sn, k))
    return v - n + 1


# --- translation param coding (spec 5.9.24/5.9.25 for idx 0,1) ---------------

def trans_coding_params(allow_hp: bool):
    trans_bits = GM_ABS_TRANS_ONLY_BITS - (0 if allow_hp else 1)
    prec_diff = GM_TRANS_ONLY_PREC_DIFF + (0 if allow_hp else 1)
    return trans_bits, prec_diff


def write_translation_params(w, wm01, prev01, allow_hp: bool) -> None:
    """wm01/prev01: (wmmat[0], wmmat[1]) in WARPEDMODEL units."""
    trans_bits, prec_diff = trans_coding_params(allow_hp)
    for idx in range(2):
        write_signed_primitive_refsubexpfin(
            w, (1 << trans_bits) + 1, SUBEXPFIN_K,
            prev01[idx] >> prec_diff, wm01[idx] >> prec_diff)


def read_translation_params(r, prev01, allow_hp: bool):
    trans_bits, prec_diff = trans_coding_params(allow_hp)
    out = []
    for idx in range(2):
        v = read_signed_primitive_refsubexpfin(
            r, (1 << trans_bits) + 1, SUBEXPFIN_K,
            prev01[idx] >> prec_diff)
        out.append(v << prec_diff)
    return tuple(out)


def gm_mv8(wm01, allow_hp: bool = False, force_int: bool = False):
    """gm_get_motion_vector for TRANSLATION (spec 7.10.2): 1/8-px mv
    with precision lowering (spec lower_mv_precision)."""
    mr = wm01[0] >> (WARPEDMODEL_PREC_BITS - 3)
    mc = wm01[1] >> (WARPEDMODEL_PREC_BITS - 3)

    def lower(v):
        if force_int:
            mod = v % 8 if v >= 0 else -((-v) % 8)
            if mod:
                v -= mod
                if abs(mod) > 4:
                    v += 8 if mod > 0 else -8
            return v
        if not allow_hp and (v & 1):
            return v + (-1 if v > 0 else 1)
        return v

    return lower(mr), lower(mc)


def mv8_to_wm01(mv8_row: int, mv8_col: int):
    return (mv8_row << (WARPEDMODEL_PREC_BITS - 3),
            mv8_col << (WARPEDMODEL_PREC_BITS - 3))


# --- ROTZOOM param coding (spec 5.9.24/5.9.25 idx 2,3 then 0,1) --------------

GM_ABS_ALPHA_BITS = 12
GM_ALPHA_PREC_BITS = 15
GM_ALPHA_PREC_DIFF = WARPEDMODEL_PREC_BITS - GM_ALPHA_PREC_BITS   # 1
GM_TRANS_PREC_BITS_FULL = 6
GM_TRANS_PREC_DIFF_FULL = WARPEDMODEL_PREC_BITS - GM_TRANS_PREC_BITS_FULL


def norm_gm6(wm):
    """Normalize a stored gm value (None / (wm0, wm1) translation /
    6-tuple mat) to a full 6-param affine mat."""
    if wm is None:
        return (0, 0, 1 << WARPEDMODEL_PREC_BITS, 0, 0,
                1 << WARPEDMODEL_PREC_BITS)
    if len(wm) == 2:
        return (wm[0], wm[1], 1 << WARPEDMODEL_PREC_BITS, 0, 0,
                1 << WARPEDMODEL_PREC_BITS)
    return tuple(wm)


def write_rotzoom_params(w, mat, prev, allow_hp: bool) -> None:
    """mat: 6-tuple (mat[4] = -mat[3], mat[5] = mat[2] for ROTZOOM);
    prev: previous-frame gm in any stored form. allow_hp unused for
    non-translation types (kept for signature symmetry)."""
    p = norm_gm6(prev)
    n_a = (1 << GM_ABS_ALPHA_BITS) + 1
    sub = 1 << GM_ALPHA_PREC_BITS
    write_signed_primitive_refsubexpfin(
        w, n_a, SUBEXPFIN_K,
        (p[2] >> GM_ALPHA_PREC_DIFF) - sub,
        (mat[2] >> GM_ALPHA_PREC_DIFF) - sub)
    write_signed_primitive_refsubexpfin(
        w, n_a, SUBEXPFIN_K,
        p[3] >> GM_ALPHA_PREC_DIFF, mat[3] >> GM_ALPHA_PREC_DIFF)
    n_t = (1 << GM_ABS_TRANS_BITS) + 1
    for idx in range(2):
        write_signed_primitive_refsubexpfin(
            w, n_t, SUBEXPFIN_K,
            p[idx] >> GM_TRANS_PREC_DIFF_FULL,
            mat[idx] >> GM_TRANS_PREC_DIFF_FULL)


def read_rotzoom_params(r, prev):
    """Returns the full 6-tuple mat (ROTZOOM: mat4 = -mat3,
    mat5 = mat2)."""
    p = norm_gm6(prev)
    n_a = (1 << GM_ABS_ALPHA_BITS) + 1
    sub = 1 << GM_ALPHA_PREC_BITS
    v2 = read_signed_primitive_refsubexpfin(
        r, n_a, SUBEXPFIN_K, (p[2] >> GM_ALPHA_PREC_DIFF) - sub)
    m2 = (v2 << GM_ALPHA_PREC_DIFF) + (1 << WARPEDMODEL_PREC_BITS)
    v3 = read_signed_primitive_refsubexpfin(
        r, n_a, SUBEXPFIN_K, p[3] >> GM_ALPHA_PREC_DIFF)
    m3 = v3 << GM_ALPHA_PREC_DIFF
    n_t = (1 << GM_ABS_TRANS_BITS) + 1
    tr = []
    for idx in range(2):
        v = read_signed_primitive_refsubexpfin(
            r, n_t, SUBEXPFIN_K, p[idx] >> GM_TRANS_PREC_DIFF_FULL)
        tr.append(v << GM_TRANS_PREC_DIFF_FULL)
    return (tr[0], tr[1], m2, m3, -m3, m2)


def gm_block_mv8(mat, mi_row: int, mi_col: int, w4: int, h4: int,
                 allow_hp: bool = False, force_int: bool = False):
    """gm_get_motion_vector for non-translational models
    (spec 7.10.2.1): block-center-dependent 1/8-px mv with precision
    lowering. mat: 6-tuple."""
    x = mi_col * 4 + w4 * 2 - 1
    y = mi_row * 4 + h4 * 2 - 1
    xc = (mat[2] - (1 << WARPEDMODEL_PREC_BITS)) * x + mat[3] * y + mat[0]
    yc = mat[4] * x + (mat[5] - (1 << WARPEDMODEL_PREC_BITS)) * y + mat[1]

    def round2signed(v, n):
        # ROUND_POWER_OF_TWO_SIGNED
        if v < 0:
            return -((-v + (1 << (n - 1))) >> n)
        return (v + (1 << (n - 1))) >> n

    if allow_hp:
        mr = round2signed(yc, WARPEDMODEL_PREC_BITS - 3)
        mc = round2signed(xc, WARPEDMODEL_PREC_BITS - 3)
    else:
        mr = round2signed(yc, WARPEDMODEL_PREC_BITS - 2) * 2
        mc = round2signed(xc, WARPEDMODEL_PREC_BITS - 2) * 2
    if force_int:
        def toint(v):
            mod = v % 8 if v >= 0 else -((-v) % 8)
            if mod:
                v -= mod
                if abs(mod) > 4:
                    v += 8 if mod > 0 else -8
            return v
        mr, mc = toint(mr), toint(mc)
    return mr, mc


def estimate_rotzoom(mv_field: np.ndarray, *, unit_mv8: int = 8,
                     block: int = 16, min_inlier_frac: float = 0.5):
    """LSQ ROTZOOM fit over the dense per-16x16 HME motion field
    (TPU-native replacement for the reference's corner+RANSAC
    global_me.c pipeline, run on the field the device already
    produced). Model (px): mv_x = s*x + b*y + tx, mv_y = -b*x + s*y
    + ty. Two robust refinement rounds; returns the coded-precision
    6-tuple mat or None when the fit is degenerate, out of coded
    range, or no better than a pure translation."""
    mv = np.asarray(mv_field, np.float64)
    rows, cols = mv.shape[:2]
    if rows * cols < 16:
        return None
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float64)
    xs = (xx * block + block / 2 - 1).reshape(-1)
    ys = (yy * block + block / 2 - 1).reshape(-1)
    vr = mv[..., 0].reshape(-1) * (unit_mv8 / 8.0)   # px
    vc = mv[..., 1].reshape(-1) * (unit_mv8 / 8.0)
    keep = np.ones(xs.shape, bool)
    sol = None
    for _ in range(3):
        if keep.sum() < 16:
            return None
        x, y = xs[keep], ys[keep]
        r_, c_ = vr[keep], vc[keep]
        # unknowns (s, b, tx, ty); rows: vc = s*x + b*y + tx;
        #                                vr = -b*x + s*y + ty
        n = x.size
        A = np.zeros((2 * n, 4))
        rhs = np.empty(2 * n)
        A[:n, 0] = x; A[:n, 1] = y; A[:n, 2] = 1.0
        rhs[:n] = c_
        A[n:, 0] = y; A[n:, 1] = -x; A[n:, 3] = 1.0
        rhs[n:] = r_
        sol, *_ = np.linalg.lstsq(A, rhs, rcond=None)
        s, b, tx, ty = sol
        pc = s * xs + b * ys + tx
        pr = -b * xs + s * ys + ty
        res = np.maximum(np.abs(pc - vc), np.abs(pr - vr))
        keep = res <= max(1.0, float(np.median(res[keep])) * 2.0)
    # FINAL acceptance at a FIXED 1-px tolerance over the whole field:
    # the adaptive refinement tolerance above scales with the fit's own
    # residual, so a garbage fit on piecewise motion (scrolling bands,
    # independent objects) can declare itself "consistent" — measured on
    # the text class it produced wild models (|b| ~ 0.08 rotations on
    # pure scroll). A true global model explains >= 60% of blocks to
    # within full-pel quantization; anything else is not global motion.
    if float((res <= 1.0).mean()) < 0.6:
        return None
    if keep.mean() < min_inlier_frac:
        return None
    s, b, tx, ty = sol
    one = 1 << WARPEDMODEL_PREC_BITS
    # quantize to coded precision
    m2 = ((round((1.0 + s) * one) - one) >> 0)
    m2 = ((m2 >> GM_ALPHA_PREC_DIFF) << GM_ALPHA_PREC_DIFF) + one
    m3 = (round(b * one) >> GM_ALPHA_PREC_DIFF) << GM_ALPHA_PREC_DIFF
    m0 = (round(tx * one) >> GM_TRANS_PREC_DIFF_FULL) << \
        GM_TRANS_PREC_DIFF_FULL
    m1 = (round(ty * one) >> GM_TRANS_PREC_DIFF_FULL) << \
        GM_TRANS_PREC_DIFF_FULL
    # coded-range checks (values are centered subexp-coded)
    lim_a = (1 << GM_ABS_ALPHA_BITS) << GM_ALPHA_PREC_DIFF
    lim_t = (1 << GM_ABS_TRANS_BITS) << GM_TRANS_PREC_DIFF_FULL
    if abs(m2 - one) >= lim_a or abs(m3) >= lim_a or \
            abs(m0) >= lim_t or abs(m1) >= lim_t:
        return None
    if m2 == one and m3 == 0:
        return None          # pure translation: cheaper coded as such
    mat = (m0, m1, m2, m3, -m3, m2)
    from svt_av1_psy_tpu_torch.inter.warp import _shear_params
    wm = {"mat": list(mat)}
    if not _shear_params(wm):
        return None
    return mat


# --- estimation --------------------------------------------------------------

def estimate_translation(mv_field: np.ndarray, *, unit_mv8: int = 8,
                         min_inlier_frac: float = 0.45,
                         tol_units: int = 1, allow_hp: bool = False):
    """Robust translation fit over the per-16x16 HME motion field
    (shape (rows, cols, 2), each component in units of unit_mv8/8 px —
    full-pel for the device HME seed map).

    Replaces the reference's FAST-corner + RANSAC pipeline
    (ref global_me.c:126) with an inlier-consensus median over the
    dense motion field the device already produces.

    Returns (mv8_row, mv8_col) quantized to the coded precision, or
    None when no dominant translation exists (static scenes with a
    zero median are also None — identity is cheaper to signal)."""
    mv = np.asarray(mv_field, np.int32).reshape(-1, 2)
    if mv.shape[0] < 4:
        return None
    med = np.median(mv, axis=0).round().astype(np.int32)
    if med[0] == 0 and med[1] == 0:
        return None
    inliers = np.abs(mv - med).max(axis=1) <= tol_units
    if inliers.mean() < min_inlier_frac:
        return None
    # refine on inliers, convert to 1/8 px, quantize to the coded
    # precision (quarter-pel when allow_hp == 0)
    fit = np.median(mv[inliers], axis=0)
    mv8 = (fit * float(unit_mv8)).round().astype(np.int64)
    _, prec_diff = trans_coding_params(allow_hp)
    step = 1 << max(prec_diff - 13, 0)      # mv8 quantum (2 for hp off)
    mv8 = (mv8 // step) * step
    if mv8[0] == 0 and mv8[1] == 0:
        return None
    # representable range check
    trans_bits, _ = trans_coding_params(allow_hp)
    lim = ((1 << trans_bits)) * step
    if abs(int(mv8[0])) >= lim or abs(int(mv8[1])) >= lim:
        return None
    return int(mv8[0]), int(mv8[1])
