"""lr_device_ms (ms, SVT_TRACE device span `lr_program`): the device's
time from the loop-restoration search program's first launch to its last
result (DeviceLrSearch.dispatch, CUDA events, read without a sync): the
mean over the window's dispatches."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_program_spans").mean_device_ms(
        ctx, "lr_program")
