"""decide_wait_ms (ms, SVT_TRACE stage `device_search` of key frames):
the encoder thread's wait for the frame's decide (FastIntraEncoder.
_take_decide: the prefetched result's host copy, or a decide launched
there and then, and its unpacking), per key frame: the mean over the
window's key frames."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_intra_spans").key_mean(
        ctx, "device_search")
