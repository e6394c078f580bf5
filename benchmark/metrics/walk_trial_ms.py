"""walk_trial_ms (ms, native phase bucket 6 `trial_total` as the SVT_TRACE
frame counter `walk.trial_total`): the C walk's intra RD trials
(native/commit_backend.c intra_trial), summed over the tile threads, per
inter frame: the mean over the window's inter frames."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_program_spans") \
        .frame_counter_mean(ctx, "walk.trial_total")
