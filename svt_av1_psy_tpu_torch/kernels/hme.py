"""K1: the full-pel SAD-scan motion search, written by hand for Hopper.

hme_search_kernel() replaces the Pallas kernel hme_search_pallas of
svt_av1_psy_tpu/ops/jax_backend.py, with the decimation and the edge pad
that surround it there fused in. The CUDA source is csrc/hme_sad_scan.cu;
its plain PyTorch version is ops/torch_backend.hme_search, which the
wrapper runs for CPU tensors and which the tests and chip_smoke.py hold
the kernel against.
"""

from __future__ import annotations

import ctypes
import functools
import typing

import torch

from svt_av1_psy_tpu_torch.kernels import build
from svt_av1_psy_tpu_torch.ops.torch_backend import hme_search

_PIXEL_DTYPES = (torch.uint8, torch.int16, torch.int32)

# blocks (16x16 full-res, 8x8 half-res) per CTA: one shared window serves
# TILE_ROWS x TILE_COLS of them. 1088x1920 is 17 x 15 tiles exactly.
TILE_ROWS, TILE_COLS = 4, 8
MAX_THREADS = 512           # kMaxThreads of the CUDA source
MAX_SMEM_BYTES = 48 * 1024  # static limit: the kernel asks for no more


class LaunchGeometry(typing.NamedTuple):
    """How hme_sad_scan is launched on one plane size."""
    tile: tuple         # (rows, cols): blocks per CTA
    grid: tuple         # (x, y): CTAs; the last may reach past the frame
    window: tuple       # (rows, cols): the half-res pixels a CTA stages
    search_range: int
    threads: int
    smem_bytes: int

    def window_origin(self, gy: int, gx: int):
        """The first half-res (y, x) of the window of tile (gy, gx). It
        may lie outside the plane by up to search_range: the kernel
        clamps each coordinate to the half-res plane (the edge pad)."""
        return (8 * self.tile[0] * gy - self.search_range,
                8 * self.tile[1] * gx - self.search_range)


@functools.lru_cache(maxsize=None)
def launch_geometry(h: int, w: int, search_range: int,
                    pixel_bytes: int) -> LaunchGeometry:
    """The launch of hme_sad_scan on an (h, w) pair of planes with
    pixel_bytes (1 or 2) per pixel. Tile (gy, gx) covers block rows
    gy*rows .. and block columns gx*cols .. (the kernel skips the blocks
    of a last tile that lie past the frame). Threads: one per (block, dx)
    pair of a tile, in as many equal rounds as keep it <= MAX_THREADS,
    rounded up to whole warps. Shared memory: the packed window (one spare
    word per row), the packed source tile and one best-key word per
    block."""
    side = 2 * search_range + 1
    per_word = 4 // pixel_bytes
    n16r, n16c = h // 16, w // 16
    win_h = 8 * TILE_ROWS + 2 * search_range
    win_w = 8 * TILE_COLS + 2 * search_range
    stride = -(-win_w // per_word) + 1
    n_blk = TILE_ROWS * TILE_COLS
    words = win_h * stride + 8 * TILE_ROWS * TILE_COLS * (8 // per_word) + \
        n_blk
    items = n_blk * side
    rounds = -(-items // MAX_THREADS)
    threads = -(-(-(-items // rounds)) // 32) * 32
    return LaunchGeometry(
        tile=(TILE_ROWS, TILE_COLS),
        grid=(-(-n16c // TILE_COLS), -(-n16r // TILE_ROWS)),
        window=(win_h, win_w), search_range=search_range, threads=threads,
        smem_bytes=4 * words)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("hme_sad_scan").hme_sad_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hme_search_kernel(src: torch.Tensor, ref: torch.Tensor,
                      search_range: int = 12):
    """Full-pel ME per 16x16 block: (mv16 (H/16, W/16, 2) int16 full-pel,
    sad16 (H/16, W/16) int32), equal to hme_search.

    src, ref: (H, W) contiguous pixel planes, H and W multiples of 16,
    pixels in [0, 2^12). CPU tensors run the plain version. CUDA tensors
    launch the kernel, once, and nothing else: uint8 planes take its 8-bit
    path and int16 planes its 16-bit path; the decimation, the edge pad,
    the doubling of the MVs and the int16 cast all happen inside it. An
    int32 plane (or a pair of mixed types) is first narrowed to int16 by
    one PyTorch cast and takes the 16-bit path: the wrapper cannot tell
    the bit depth of int32 pixels without a host sync, so callers on the
    K1 route upload planes in their pixel width. Any other placement
    raises."""
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
    if src.dtype != ref.dtype or src.dtype == torch.int32:
        src, ref = src.to(torch.int16), ref.to(torch.int16)
    if src.data_ptr() % 8 or ref.data_ptr() % 8:
        raise ValueError("hme_search_kernel: planes must be 8-byte aligned")
    h, w = src.shape
    geo = launch_geometry(h, w, search_range, src.element_size())
    sad = torch.empty((h // 16, w // 16), dtype=torch.int32,
                      device=src.device)
    mv = torch.empty((h // 16, w // 16, 2), dtype=torch.int16,
                     device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = _entry()(src.data_ptr(), ref.data_ptr(), sad.data_ptr(),
                   mv.data_ptr(), h, w, search_range, src.element_size(),
                   *geo.tile, *geo.grid, geo.threads, geo.smem_bytes,
                   src.device.index, stream)
    if err != 0:
        raise RuntimeError(f"hme_sad_scan launch failed: cudaError {err}")
    hme_search_kernel.launches += 1
    return mv, sad


# launches of the CUDA kernel (CPU calls run the plain version and do not
# count); callers reset it to 0 to count one run
hme_search_kernel.launches = 0
