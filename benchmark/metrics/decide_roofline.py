"""decide_roofline (%, SVT_TRACE device span `decide_program` against the
algorithm's work): the decide's share of its roofline, the least time
one decide of the configuration's frame can take (_decide_work.least_s:
operations at the card's integer-lane peak, bytes at its HBM peak from
peaks.json; at 1080p the operations bound it) over decide_device_ms, the
mean device time of the window's decides."""

import json
import os

import harness

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")
MIN_BLOCK = 8      # FastIntraEncoder's decide runs down to 8x8


def read(ctx):
    if ctx.device_kind is None:
        return None
    device_ms = harness.load_module("metrics", "decide_device_ms").read(ctx)
    if not device_ms:
        return None
    work = harness.load_module("metrics", "_decide_work")
    ops_peak = work.INT_OPS_PER_S.get(ctx.device_kind)
    with open(PEAKS) as f:
        peaks = json.load(f).get(ctx.device_kind)
    if peaks is None or ops_peak is None:
        return None
    c = ctx.config
    h, w = work.padded(c["height"], c["width"])
    px = 1 if c["bit_depth"] == 8 else 2
    least = work.least_s(h, w, px, MIN_BLOCK, peaks["hbm_bytes_per_s"],
                         ops_peak)
    return 100.0 * least * 1e3 / device_ms
