"""k1_roofline (%, torch.profiler): the K1 kernel's (hme_sad_scan, the
single-level full search) share of its roofline over the window: the
least time one launch can take, summed over the window's launches, over
their kernel time.

The least time is set by bytes: both planes read once in their pixel
width and the MVs (2 x int16) and SADs (int32) of every 16x16 block
written once, at the card's HBM peak (peaks.json); its operations
(8160 blocks x 625 offsets x 129 at 1088x1920, about 6.6e8) at the int8
peak take a quarter of that. Every launch of a cell searches the
configuration's frame padded to whole superblocks of 64."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")
KERNEL = "hme_sad_scan"


def bytes_moved(h: int, w: int, pixel_bytes: int) -> int:
    n16 = (h // 16) * (w // 16)
    return 2 * h * w * pixel_bytes + n16 * (2 * 2 + 4)


def bound_s(h: int, w: int, pixel_bytes: int, peaks: dict) -> float:
    return bytes_moved(h, w, pixel_bytes) / peaks["hbm_bytes_per_s"]


def read(ctx):
    dt = ctx.device_trace
    if dt is None or ctx.device_kind is None:
        return None
    with open(PEAKS) as f:
        peaks = json.load(f).get(ctx.device_kind)
    if peaks is None:
        return None
    times = [op[2] for op in dt.device_ops if KERNEL in op[0]]
    if not times:
        return None
    c = ctx.config
    h = -(-c["height"] // 64) * 64
    w = -(-c["width"] // 64) * 64
    px = 1 if c["bit_depth"] == 8 else 2
    return 100.0 * len(times) * bound_s(h, w, px, peaks) / (sum(times) / 1e9)
