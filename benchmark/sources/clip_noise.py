"""clip_noise: the repo's synthetic test clip (the formulas of
tools/make_test_clip.py make_frame), built on the device from the seed.

Each frame: a diagonal gradient moving `grad_step` pixels per frame, a
64x64 textured square moving `square_step` (x, y) pixels per frame, and
Gaussian noise of `noise` of full scale from a torch.Generator seeded with
the run's seed and the frame's index, so the same seed gives the same
frames, and frame t is the same whenever it is asked for (the stream
check makes the window's frames again after the window); chroma is flat
and drifts slowly. Every seed gives the same content and the same sizes:
only the noise differs. The parts that do not move (the texture of the
square) are made once, in numpy float32 as make_frame makes them, so that
with noise 0 the frames equal make_frame's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


class Source:
    def __init__(self, params: dict, config: dict, seed: int, device):
        self.w, self.h = int(config["width"]), int(config["height"])
        self.bd = int(config["bit_depth"])
        self.hi = (1 << self.bd) - 1
        self.noise = float(params.get("noise", 0.02))
        self.grad_step = int(params.get("grad_step", 4))
        self.sq_x, self.sq_y = (int(v) for v in
                                params.get("square_step", (5, 3)))
        self.device = torch.device(device)
        yy, xx = np.mgrid[0:self.h, 0:self.w].astype(np.float32)
        tex = 0.15 * np.sin(xx * 0.7) * np.sin(yy * 0.9)
        dev = self.device
        self._xy = torch.from_numpy(xx + yy).to(dev)
        self._xx = torch.from_numpy(xx).to(dev)
        self._yy = torch.from_numpy(yy).to(dev)
        self._sq = torch.from_numpy((0.8 + tex).astype(np.float32)).to(dev)
        self._gen = torch.Generator(device=dev)
        self._seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._dtype = torch.uint8 if self.bd == 8 else torch.int16
        self._np_dtype = np.uint8 if self.bd == 8 else np.uint16

    def frame(self, t: int):
        """Frame t as (y, u, v) host numpy planes in the pixel type."""
        w, h, hi = self.w, self.h, self.hi
        # the float32 arithmetic of make_frame, term by term
        y = (self._xy + np.float32(self.grad_step * t)) % 256 / 255.0
        bx = (32 + self.sq_x * t) % max(1, w - 64)
        by = (24 + self.sq_y * t) % max(1, h - 64)
        sq = (self._xx >= bx) & (self._xx < bx + 64) & \
            (self._yy >= by) & (self._yy < by + 64)
        y = torch.where(sq, self._sq, 0.2 + 0.6 * y)
        if self.noise > 0:
            s = np.random.SeedSequence([self._seed, t]).generate_state(
                2, np.uint32)
            self._gen.manual_seed((int(s[0]) << 32) | int(s[1]))
            y = y + torch.randn(y.shape, generator=self._gen,
                                device=self.device) * self.noise
        y = torch.clamp(y * hi, 0, hi).to(self._dtype)
        yh = y.cpu().numpy()
        if self.bd > 8:
            yh = yh.view(np.uint16)
        u0 = 0.5 * hi + 0.1 * hi * np.sin(0.05 * t)
        v0 = 0.5 * hi - 0.1 * hi * np.cos(0.05 * t)
        cshape = (h // 2, w // 2)
        u = np.full(cshape, np.clip(u0, 0, hi), np.float64).astype(
            self._np_dtype)
        v = np.full(cshape, np.clip(v0, 0, hi), np.float64).astype(
            self._np_dtype)
        return yh, u, v
