"""Device selection and device-to-host copies for the port.

The JAX package probes its TPU transport and falls back to the CPU
(svt_av1_psy_tpu/utils/device.py select_platform). The port does neither:
the caller names the device, and asking for a GPU that is not there is an
error, never a silent CPU run. Several devices that share one program
(the reference's device meshes) are a DeviceGroup: a list of devices,
which may repeat one, each entry with a CUDA stream of its own.
"""

from __future__ import annotations

import contextlib

import numpy as np
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


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, with no host sync: on CUDA
    the bytes go through pinned memory and a non_blocking copy queued on
    the current stream (the pinned block is not reused before the copy
    has run). On the CPU the tensor shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HostStitch:
    """The host copies of one result's shards, joined when read: ``join``
    takes their numpy arrays in shard order and returns the whole result.
    Read like a HostCopy (``numpy()``, ``np.asarray``)."""

    def __init__(self, copies: list, join):
        self._copies = copies
        self._join = join

    def numpy(self):
        return self._join([c.numpy() for c in self._copies])

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)


class DeviceGroup:
    """Devices that run one program together, one column shard each: the
    port's form of a device mesh. The list may repeat a device; on CUDA
    every entry has a stream of its own, so the shards of one card run as
    concurrent streams. A tensor made on one entry's stream reaches
    another through ``hand``."""

    def __init__(self, devices):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a device group needs at least one device")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"a device group mixes device types: "
                             f"{[str(d) for d in self.devices]}")
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    def __len__(self) -> int:
        return len(self.devices)

    def stream(self, i: int):
        """Context in which work is queued on entry i's stream (a no-op on
        the CPU)."""
        s = self.streams[i]
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def hand(self, t: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """t, made on entry i's stream, for use on entry j's: entry j's
        stream waits for entry i's, and the caching allocator is told that
        j uses t (record_stream), so t's memory is not reused under it. A
        copy when the two devices differ."""
        si, sj = self.streams[i], self.streams[j]
        if sj is None:
            return t.to(self.devices[j])
        if si is not sj:
            sj.wait_stream(si)
        with torch.cuda.stream(sj), torch.cuda.stream(si):
            out = t.to(self.devices[j], non_blocking=True)
        out.record_stream(sj)
        return out
