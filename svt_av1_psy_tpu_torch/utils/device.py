"""Device selection and device-to-host copies for the port.

The JAX package probes its TPU transport and falls back to the CPU
(svt_av1_psy_tpu/utils/device.py select_platform). The port does neither:
the caller names the device, and asking for a GPU that is not there is an
error, never a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cpu"`` or ``"cuda[:N]"`` as a ``torch.device``.

    Raises RuntimeError for a CUDA device when ``torch.cuda.is_available()``
    is False, and ValueError for any other device type."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but "
                "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r}: "
                         "expected 'cpu' or 'cuda[:N]'")
    return dev


class HostCopy:
    """The host copy of a device result, started at once and waited for
    only when read.

    On CUDA the constructor queues a non_blocking copy into pinned host
    memory behind the kernels that compute ``t`` and records a CUDA event
    after it; nothing waits. ``numpy()`` (and ``np.asarray``, through
    ``__array__``) waits for that event alone, so the device goes on with
    work queued later while the host reads. A CPU tensor is already on
    the host."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def numpy(self):
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)
