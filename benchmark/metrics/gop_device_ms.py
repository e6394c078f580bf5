"""gop_device_ms (ms, SVT_TRACE device span `gop_program`): the device's
time from the GoP program's first launch to its last result
(RaDriver._dispatch_gop, CUDA events on the program's stream, read
without a sync), per mini-GoP: the mean over the window's dispatches.
Against gop_dispatch_ms (the host's launching) and gop_kernel_ms (the
kernels' own time) it says whether the program is launch-bound."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_program_spans").mean_device_ms(
        ctx, "gop_program")
