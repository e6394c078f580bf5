"""The fast path's loop-restoration search with its program in PyTorch.

DeviceLrSearch subclasses svt_av1_psy_tpu.models.lr_search.DeviceLrSearch
and overrides the two methods that call JAX: _build, which returns the
per-frame search program (the Wiener tap solve of each plane and the
per-unit SSE with and without the filter, packed into one float32 vector
in the reference's layout), and dispatch, which uploads the planes to
``self.device`` and starts the copy of that vector home. The unit grid,
the decision rule (finish) and the LrDecision are the reference's.

The program keeps the reference's float32 math and order of operations.
Its sums (the Gram products, the integral image) run in another order
than XLA's, so a solved tap near x.5 may round the other way: the
reference states the same +-1 tap bound between its own two paths.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from svt_av1_psy_tpu.models import lr_search
from svt_av1_psy_tpu.models.lr_search import _TAP_MAX, _TAP_MIN
from svt_av1_psy_tpu_torch.utils.device import HostCopy, resolve_device

_DISTS = (3, 2, 1)          # tap j filters the pixels at +-_DISTS[j]


def _upload(plane: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a uint8/uint16 pixel plane on ``device``, never a view of
    it: the caller rewrites the recon in place right after dispatch. On
    CUDA the bytes go through pinned memory and a non_blocking copy, so
    the upload never waits for the device. 16-bit pixels travel as int16
    (AV1 pixels are < 2^12) because torch.uint16 has almost no kernels."""
    if plane.dtype == np.uint16:
        plane, dtype = plane.view(np.int16), torch.int16
    elif plane.dtype == np.uint8:
        dtype = torch.uint8
    else:
        raise TypeError(f"pixel plane must be uint8 or uint16, "
                        f"got {plane.dtype}")
    host = torch.empty(plane.shape, dtype=dtype,
                       pin_memory=device.type == "cuda")
    host.numpy()[...] = plane
    return host.to(device, non_blocking=True)


def _shift2(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """a shifted by +d and -d along axis, edge-replicated, summed."""
    n = a.shape[axis]
    i = torch.arange(n, device=a.device)
    return (a.index_select(axis, (i + d).clamp(0, n - 1)) +
            a.index_select(axis, (i - d).clamp(0, n - 1)))


def _gram(basis: torch.Tensor, rv: torch.Tensor):
    """(B @ B.T, B @ rv) as products summed elementwise in float32: no
    matmul, so no TF32 path, whatever torch.set_float32_matmul_precision
    says (TF32 would widen the +-1 tap bound to many taps)."""
    k = basis.shape[0]
    G = torch.stack([torch.stack([(basis[i] * basis[j]).sum()
                                  for j in range(k)]) for i in range(k)])
    return G, (basis * rv).sum(dim=1)


class DeviceLrSearch(lr_search.DeviceLrSearch):
    """The Wiener LR search of one frame as one PyTorch program on
    ``device`` ("cpu" or "cuda[:N]"); dispatch returns a HostCopy of its
    packed result, which the reference's finish reads."""

    def __init__(self, dims, bd: int = 8, unit_size=(64, 32, 32), *,
                 device):
        self.device = resolve_device(device)
        super().__init__(dims, bd, unit_size)

    def _build(self):
        """The per-frame program over the three planes: for each, the
        horizontal then the vertical tap solve, the filtered plane, and
        the per-unit SSE without and with the filter. Its constants (tap
        bounds, ridge, unit boundaries) go to the device once, here."""
        dev = self.device
        hi = float((1 << self.bd) - 1)
        lo_t = torch.tensor(_TAP_MIN, dtype=torch.float32, device=dev)
        hi_t = torch.tensor(_TAP_MAX, dtype=torch.float32, device=dev)
        ridge = {k: torch.eye(k, dtype=torch.float32, device=dev) * 1e-3
                 for k in (2, 3)}
        bounds = [(torch.tensor(ys, dtype=torch.long, device=dev),
                   torch.tensor(xs, dtype=torch.long, device=dev))
                  for _, _, ys, xs in self.grids]

        def solve_dir(dgd, src, axis, chroma):
            r = (src - dgd) * 128.0
            first = 1 if chroma else 0
            basis = [_shift2(dgd, d, axis) - 2.0 * dgd
                     for d in _DISTS[first:]]
            B = torch.stack([b[3:-3, 3:-3].reshape(-1) for b in basis])
            G, c = _gram(B, r[3:-3, 3:-3].reshape(-1))
            # check_errors=False: checking info would sync with the host
            # (G + ridge is never singular)
            sol, _ = torch.linalg.solve_ex(G + ridge[B.shape[0]], c,
                                           check_errors=False)
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

        def program(*planes6):
            outs = []
            for plane in range(3):
                dgd = planes6[plane].to(torch.float32)
                src = planes6[3 + plane].to(torch.float32)
                chroma = plane > 0
                ht = solve_dir(dgd, src, 1, chroma)
                dh = filt_dir(dgd, ht, 1)
                vt = solve_dir(dh, src, 0, chroma)
                filt = filt_dir(dh, vt, 0)
                fq = torch.clamp(torch.round(filt), 0.0, hi)
                ys, xs = bounds[plane]
                sse_n = unit_sums((dgd - src) ** 2, ys, xs)
                sse_w = unit_sums((fq - src) ** 2, ys, xs)
                outs.append(torch.cat([vt, ht, sse_n.reshape(-1),
                                       sse_w.reshape(-1)]))
            return torch.cat(outs)

        return program

    def dispatch(self, src_planes, recon_planes) -> HostCopy:
        """Launch the search on the exact-dim planes and start the copy of
        its packed result home; returns the HostCopy that finish reads.
        No host sync."""
        args = []
        for planes in (recon_planes, src_planes):
            for plane in range(3):
                pw, ph = self.dims[plane]
                args.append(_upload(np.asarray(planes[plane])[:ph, :pw],
                                    self.device))
        return HostCopy(self._fn(*args))
