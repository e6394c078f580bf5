"""filter_join_ms (ms, SVT_TRACE span `filter_join`): the encoder thread's
wait, before an inter walk, for the deferred in-loop filter of a leaf
frame two frames back (FastIntraEncoder._encode_p), per inter frame: the
mean over the window's joins."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_program_spans").mean_ms(
        ctx, "filter_join")
