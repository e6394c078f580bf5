"""Synthetic test frames for the port's own runs (chip_smoke.py, the CLI
on a y4m it writes): make_frame is tools/make_test_clip.py's, copied so
that a run of the port never imports that tool, whose y4m writer comes
from svt_av1_psy_tpu. tests/test_torch_standalone.py holds the copy equal
to the tool's function.
"""

import numpy as np


def make_frame(w, h, t, bit_depth=8, noise=0.0, rng=None):
    hi = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # moving diagonal gradient
    y = (xx + yy + 4 * t) % 256 / 255.0
    # moving bright square with texture
    bx, by = (32 + 5 * t) % max(1, w - 64), (24 + 3 * t) % max(1, h - 64)
    sq = (xx >= bx) & (xx < bx + 64) & (yy >= by) & (yy < by + 64)
    tex = 0.15 * np.sin(xx * 0.7) * np.sin(yy * 0.9)
    y = np.where(sq, 0.8 + tex, 0.2 + 0.6 * y)
    if noise > 0 and rng is not None:
        y = y + rng.normal(0, noise, y.shape).astype(np.float32)
    y = np.clip(y * hi, 0, hi)
    u = np.full((h // 2, w // 2), 0.5 * hi) + 0.1 * hi * np.sin(0.05 * t)
    v = np.full((h // 2, w // 2), 0.5 * hi) - 0.1 * hi * np.cos(0.05 * t)
    dt = np.uint16 if bit_depth > 8 else np.uint8
    return y.astype(dt), np.clip(u, 0, hi).astype(dt), np.clip(v, 0, hi).astype(dt)
