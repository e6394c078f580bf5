"""decide_device_ms (ms, SVT_TRACE device span `decide_program`): the
device's time for one decide (FastIntraEncoder._decide_dispatch, CUDA
events around the plane's upload, the intra_decide_packed program and
the start of its result's copy home, read without a sync), prefetched or
launched inline: the mean over the window's decides."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_program_spans").mean_device_ms(
        ctx, "decide_program")
