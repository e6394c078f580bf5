"""K1: the full-pel SAD-scan motion search, written by hand for Hopper.

hme_search_kernel() replaces the Pallas kernel hme_search_pallas of
svt_av1_psy_tpu/ops/jax_backend.py. The CUDA source is
csrc/hme_sad_scan.cu; its plain PyTorch version is
ops/torch_backend.hme_search, which the wrapper runs for CPU tensors and
which the tests and chip_smoke.py hold the kernel against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from svt_av1_psy_tpu_torch.kernels import build
from svt_av1_psy_tpu_torch.ops.torch_backend import hme_planes, hme_search

_PIXEL_DTYPES = (torch.uint8, torch.int16, torch.int32)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("hme_sad_scan").hme_sad_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hme_search_kernel(src: torch.Tensor, ref: torch.Tensor,
                      search_range: int = 12):
    """Full-pel ME per 16x16 block: (mv16 (H/16, W/16, 2) int16 full-pel,
    sad16 (H/16, W/16) int32), equal to hme_search.

    src, ref: (H, W) contiguous pixel planes (uint8, int16 or int32), H and
    W multiples of 16, pixels < 2^12. CPU tensors run the plain version;
    CUDA tensors launch the kernel (the decimation and the edge pad run as
    PyTorch ops first, as they sit outside the Pallas call in JAX). Any
    other placement raises."""
    if src.device.type == "cpu" and ref.device.type == "cpu":
        return hme_search(src, ref, search_range)
    if src.device.type != "cuda" or ref.device != src.device:
        raise ValueError(f"hme_search_kernel: src on {src.device}, ref on "
                         f"{ref.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    if src.dtype not in _PIXEL_DTYPES or ref.dtype not in _PIXEL_DTYPES:
        raise TypeError(f"hme_search_kernel: pixel dtypes {src.dtype}, "
                        f"{ref.dtype}; expected one of {_PIXEL_DTYPES}")
    if src.dim() != 2 or src.shape != ref.shape or \
            src.shape[0] % 16 or src.shape[1] % 16:
        raise ValueError(f"hme_search_kernel: shapes {tuple(src.shape)}, "
                         f"{tuple(ref.shape)}; expected one (H, W) with H, "
                         "W multiples of 16")
    if not (src.is_contiguous() and ref.is_contiguous()):
        raise ValueError("hme_search_kernel: planes must be contiguous")
    side = 2 * search_range + 1
    if search_range < 0 or side * side > 1024:
        raise ValueError(f"hme_search_kernel: search_range {search_range} "
                         "outside [0, 15]")
    sh, rp = hme_planes(src, ref, search_range)
    n16r, n16c = sh.shape[0] // 8, sh.shape[1] // 8
    sad = torch.empty((n16r, n16c), dtype=torch.int32, device=src.device)
    mv = torch.empty((n16r, n16c, 2), dtype=torch.int32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = _entry()(sh.data_ptr(), rp.data_ptr(), sad.data_ptr(),
                   mv.data_ptr(), n16r, n16c, search_range,
                   src.device.index, stream)
    if err != 0:
        raise RuntimeError(f"hme_sad_scan launch failed: cudaError {err}")
    hme_search_kernel.launches += 1
    return (2 * mv).to(torch.int16), sad


# launches of the CUDA kernel (CPU calls run the plain version and do not
# count); callers reset it to 0 to count one run
hme_search_kernel.launches = 0
