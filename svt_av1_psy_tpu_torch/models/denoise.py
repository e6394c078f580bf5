"""Source denoising for the film-grain-synthesis path.

The reference estimates its AR grain model from the source and then
ENCODES THE DENOISED signal (ref Source/Lib/Codec/noise_model.c:2132
av1_denoise_and_model_run: estimate -> wiener denoise -> encode
denoised + signal film_grain_params; --film-grain-denoise). Round 4
coded the NOISY source while also synthesizing grain on top — the
decoder output then carries both the coded grain remnants and the
synthesized field, which measured ~6.5 dB below the reference at
matched rates on the grain class.

This module provides the denoise half: a local adaptive (Lee/Wiener)
filter — flat areas collapse to their local mean, structured areas
pass through — implemented with cumulative-sum box filters (O(n),
vectorized numpy; the host-side pre-analysis stage, SURVEY §2.4)."""

from __future__ import annotations

import numpy as np


def _box(a: np.ndarray, r: int) -> np.ndarray:
    """Box mean with radius r via padded cumsum (edge-replicated)."""
    p = np.pad(a, r, mode="edge").astype(np.float64)
    c = p.cumsum(0).cumsum(1)
    c = np.pad(c, ((1, 0), (1, 0)))
    k = 2 * r + 1
    s = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])
    return s / (k * k)


def estimate_noise_sigma(y: np.ndarray, bd: int = 8) -> float:
    """Noise std estimate from the quietest blocks' high-pass energy
    (the flat-block selection role of noise_model.c's
    svt_aom_flat_block_finder)."""
    f = y.astype(np.float64)
    hp = f - _box(f, 1)
    H, W = f.shape
    b = 16
    stds = []
    for r in range(0, H - b, b):
        for c in range(0, W - b, b):
            stds.append(float(hp[r:r + b, c:c + b].std()))
    stds.sort()
    # lower quartile of block stds ~ pure-noise blocks; the 3x3 box
    # high-pass of white noise has std ~= 0.943 sigma
    n = max(1, len(stds) // 4)
    return float(np.mean(stds[:n])) / 0.943


def lee_denoise(plane: np.ndarray, sigma: float, radius: int = 2,
                bd: int = 8) -> np.ndarray:
    """Local adaptive (Lee/Wiener) denoise: y' = mu + max(0, v - n) /
    max(v, n) * (y - mu) with mu/v over a (2r+1)^2 window and n the
    noise variance. Flat areas -> local mean; edges pass through."""
    f = plane.astype(np.float64)
    mu = _box(f, radius)
    m2 = _box(f * f, radius)
    v = np.maximum(m2 - mu * mu, 0.0)
    n = sigma * sigma
    g = np.maximum(v - n, 0.0) / np.maximum(v, 1e-6)
    out = mu + g * (f - mu)
    hi = (1 << bd) - 1
    dt = plane.dtype
    return np.clip(np.rint(out), 0, hi).astype(dt)


def denoise_frame(y, u, v, sigma: float, bd: int = 8):
    """Denoise a full frame; chroma uses half the luma noise level
    (4:2:0 averaging; matches the grain model's chroma scaling shape)."""
    return (lee_denoise(np.asarray(y), sigma, bd=bd),
            lee_denoise(np.asarray(u), max(sigma * 0.5, 0.5), bd=bd),
            lee_denoise(np.asarray(v), max(sigma * 0.5, 0.5), bd=bd))
