"""Film-grain estimation: AR noise model fit from flat blocks.

The encoder-side half of AV1 film-grain synthesis: estimate the source
noise (strength per intensity + AR correlation structure), signal it in
film_grain_params (spec 5.9.30), and encode the DENOISED-ish signal
normally; the decoder re-synthesizes grain. Reference counterpart:
Source/Lib/Codec/noise_model.c (AR equations svt_aom_noise_model_update)
with the PSY adaptive block size (noise_model.c:2132). This is a
simplified single-pass fit: flat-block selection by gradient energy,
per-intensity-bin scaling points, lag-2 AR coefficients via least
squares on the high-pass noise field.
"""

from __future__ import annotations

import numpy as np

from svt_av1_psy_tpu_torch.bitstream.headers import FilmGrainParams

# lag-2 AR neighborhood in grain raster order (spec shift positions):
# all (dy, dx) with dy in [-2..0], dx in [-2..2], preceding (0, 0)
_AR_POS = [(-2, -2), (-2, -1), (-2, 0), (-2, 1), (-2, 2),
           (-1, -2), (-1, -1), (-1, 0), (-1, 1), (-1, 2),
           (0, -2), (0, -1)]


def _highpass(y: np.ndarray) -> np.ndarray:
    """Noise proxy: residual after a 3x3 box blur."""
    f = y.astype(np.float64)
    k = np.ones((3, 3)) / 9.0
    from numpy.lib.stride_tricks import sliding_window_view
    pad = np.pad(f, 1, mode="edge")
    win = sliding_window_view(pad, (3, 3))
    blur = (win * k).sum(axis=(2, 3))
    return f - blur


def _flat_mask(y: np.ndarray, block: int = 16) -> np.ndarray:
    """Blocks with low structural gradient (keeps noise, drops edges)."""
    gy = np.abs(np.diff(y.astype(np.int32), axis=0, prepend=y[:1]))
    gx = np.abs(np.diff(y.astype(np.int32), axis=1, prepend=y[:, :1]))
    g = (gx + gy).astype(np.float64)
    H, W = y.shape
    nh, nw = H // block, W // block
    gb = g[:nh * block, :nw * block].reshape(nh, block, nw, block)
    gmean = gb.mean(axis=(1, 3))
    thr = np.percentile(gmean, 40)
    return gmean <= thr


def estimate_film_grain(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                        bd: int = 8, seed: int = 7391,
                        adaptive_block: bool = True,
                        noise_field: np.ndarray | None = None):
    """Fit grain params from one frame. Returns FilmGrainParams or None
    when the content carries no measurable grain.

    noise_field: when given, fit THIS field (e.g. source - denoised,
    the portion the encoder removed and synthesis must restore — ref
    noise_model.c models the denoiser residual) instead of the
    high-pass noise proxy; intensity binning still follows y."""
    shift = bd - 8
    y8 = (y >> shift).astype(np.uint8) if shift else y
    H, W = y8.shape
    block = 32 if (adaptive_block and max(H, W) <= 1920) else 64
    block = min(block, H // 4, W // 4)
    if block < 8:
        return None
    noise = _highpass(y8) if noise_field is None else \
        (noise_field.astype(np.float64) / (1 << shift) if shift
         else noise_field.astype(np.float64))
    mask = _flat_mask(y8, block)
    nh, nw = mask.shape
    flat_noise = []
    flat_lum = []
    for by in range(nh):
        for bx in range(nw):
            if mask[by, bx]:
                sl = (slice(by * block, (by + 1) * block),
                      slice(bx * block, (bx + 1) * block))
                flat_noise.append(noise[sl])
                flat_lum.append(float(y8[sl].mean()))
    if not flat_noise:
        return None
    sigmas = np.array([n.std() for n in flat_noise])
    if np.median(sigmas) < 0.8:
        return None                           # clean source: no grain

    # scaling points: piecewise sigma per intensity (up to 8 points)
    lum = np.array(flat_lum)
    pts = []
    for lo in range(0, 256, 48):
        sel = (lum >= lo) & (lum < lo + 48)
        if sel.sum() == 0:
            continue
        s = float(np.median(sigmas[sel]))
        # scaling value units: grain is scaled by scaling/ (2^grain_scaling)
        # with grain values ~ N(0, 1) * 2^(bitdepth-8)... empirical gain
        pts.append((min(lo + 24, 255), int(np.clip(s * 10.0, 1, 255))))
    if not pts:
        return None
    if pts[0][0] > 0:
        pts.insert(0, (0, pts[0][1]))

    # AR(2) coefficient fit by least squares over flat-block noise
    A_rows, b_rows = [], []
    for n in flat_noise[:64]:
        h, w = n.shape
        cols = [n[2 + dy:h - 2 + dy + 1 if dy else h - 2 + 1,
                  2 + dx:w - 2 + dx].ravel()
                for (dy, dx) in _AR_POS]
        # uniform slicing: rebuild with explicit indices
        cols = []
        tgt = n[2:h - 2, 2:w - 2]
        for (dy, dx) in _AR_POS:
            cols.append(n[2 + dy:h - 2 + dy, 2 + dx:w - 2 + dx].ravel())
        A_rows.append(np.stack(cols, axis=1))
        b_rows.append(tgt.ravel())
    A = np.concatenate(A_rows)
    b = np.concatenate(b_rows)
    try:
        sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    except np.linalg.LinAlgError:
        sol = np.zeros(len(_AR_POS))
    ar_shift = 7
    coeffs = np.clip(np.round(sol * (1 << ar_shift)), -128,
                     127).astype(int).tolist()

    return FilmGrainParams(
        apply_grain=True, grain_seed=seed & 0xFFFF,
        scaling_y=pts[:14], scaling_cb=[], scaling_cr=[],
        chroma_scaling_from_luma=False,
        grain_scaling=8, ar_coeff_lag=2,
        ar_coeffs_y=coeffs, ar_coeffs_cb=coeffs + [0],
        ar_coeffs_cr=coeffs + [0],
        ar_coeff_shift=ar_shift, grain_scale_shift=0,
        overlap_flag=True, clip_to_restricted_range=False)


def load_fgs_table(path: str) -> FilmGrainParams:
    """Parse an aom film-grain table file ("filmgrn1" text format; the
    --fgs-table surface, ref App/app_config.c:2654 read_fgs_table) and
    return the FIRST entry's parameters (applied sequence-wide)."""
    with open(path) as f:
        text = f.read()
    if not text.startswith("filmgrn1"):
        raise ValueError(f"invalid grain table magic in {path}")
    toks = text.split()[1:]
    pos = 0

    def take(n):
        nonlocal pos
        out = toks[pos:pos + n]
        pos += n
        return out

    def expect(t):
        nonlocal pos
        if pos >= len(toks) or toks[pos] != t:
            raise ValueError(f"grain table: expected {t!r} at token {pos}")
        pos += 1

    expect("E")
    _, _, apply_grain, seed, update = take(5)
    if not int(update):
        raise ValueError("grain table: first entry carries no parameters")
    expect("p")
    (lag, shift, gss, scaling_shift, csfl, overlap, cb_mult, cb_luma,
     cb_off, cr_mult, cr_luma, cr_off) = [int(x) for x in take(12)]

    def points(tag):
        expect(tag)
        n = int(take(1)[0])
        vals = [int(x) for x in take(2 * n)]
        return [(vals[2 * i], vals[2 * i + 1]) for i in range(n)]

    sy = points("sY")
    scb = points("sCb")
    scr = points("sCr")
    n_y_coeffs = 2 * lag * (lag + 1)
    expect("cY")
    cy = [int(x) for x in take(n_y_coeffs)]
    expect("cCb")
    ccb = [int(x) for x in take(n_y_coeffs + 1)]
    expect("cCr")
    ccr = [int(x) for x in take(n_y_coeffs + 1)]
    return FilmGrainParams(
        apply_grain=bool(int(apply_grain)), grain_seed=int(seed) & 0xFFFF,
        scaling_y=sy, scaling_cb=scb, scaling_cr=scr,
        chroma_scaling_from_luma=bool(csfl), grain_scaling=scaling_shift,
        ar_coeff_lag=lag, ar_coeffs_y=cy, ar_coeffs_cb=ccb,
        ar_coeffs_cr=ccr, ar_coeff_shift=shift, grain_scale_shift=gss,
        cb_mult=cb_mult, cb_luma_mult=cb_luma, cb_offset=cb_off,
        cr_mult=cr_mult, cr_luma_mult=cr_luma, cr_offset=cr_off,
        overlap_flag=bool(overlap))
