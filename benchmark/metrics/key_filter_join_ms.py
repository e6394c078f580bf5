"""key_filter_join_ms (ms, SVT_TRACE span `filter_join` of key frames):
the encoder thread's wait, before a key frame's walk, for the deferred
in-loop filter (DLF and CDEF on a background thread,
FastIntraEncoder._deferred_filter_task) of the frame two back, whose
recon buffer the walk rewrites: the mean over the window's key frames."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_intra_spans").key_span_mean_ms(
        ctx, "filter_join")
