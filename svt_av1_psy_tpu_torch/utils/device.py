"""Device selection for the port.

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
