"""Quality metrics for the stat report (ref Source/Lib/Codec/svt_psnr.c
and the app's --enable-stat-report output: PSNR + SSIM per frame).

SSIM follows the libaom/reference windowing (8x8 windows stepped by 4,
ssim.c aom_ssim2 analog), computed vectorized in float64 — the constants
are the standard (0.01 K1 / 0.03 K2) choices scaled to the bit depth.
"""
from __future__ import annotations

import math

import numpy as np


def psnr(a, b, bd: int = 8) -> float:
    peak = float((1 << bd) - 1) ** 2
    m = float(np.mean((np.asarray(a, np.float64) -
                       np.asarray(b, np.float64)) ** 2))
    return 10 * math.log10(peak / max(m, 1e-12))


def _window_sums(x: np.ndarray, w: int, step: int) -> np.ndarray:
    """Sums over all w x w windows stepped by `step` (integral image)."""
    ii = np.zeros((x.shape[0] + 1, x.shape[1] + 1), np.float64)
    np.cumsum(np.cumsum(x, 0), 1, out=ii[1:, 1:])
    r = np.arange(0, x.shape[0] - w + 1, step)
    c = np.arange(0, x.shape[1] - w + 1, step)
    return (ii[r[:, None] + w, c[None, :] + w] -
            ii[r[:, None] + w, c[None, :]] -
            ii[r[:, None], c[None, :] + w] +
            ii[r[:, None], c[None, :]])


def ssim_plane(a, b, bd: int = 8, win: int = 8, step: int = 4) -> float:
    """Mean SSIM over win x win windows stepped by `step`
    (aom_ssim2 analog, ref ssim.c windowing)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape[0] < win or a.shape[1] < win:
        return 1.0
    n = float(win * win)
    peak = float((1 << bd) - 1)
    c1 = (0.01 * peak) ** 2 * n * n
    c2 = (0.03 * peak) ** 2 * n * n
    s1 = _window_sums(a, win, step)
    s2 = _window_sums(b, win, step)
    s11 = _window_sums(a * a, win, step)
    s22 = _window_sums(b * b, win, step)
    s12 = _window_sums(a * b, win, step)
    num = (2.0 * s1 * s2 + c1) * (2.0 * (n * s12 - s1 * s2) + c2)
    den = (s1 * s1 + s2 * s2 + c1) * \
        (n * s11 - s1 * s1 + n * s22 - s2 * s2 + c2)
    return float(np.mean(num / den))
