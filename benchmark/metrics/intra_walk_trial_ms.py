"""intra_walk_trial_ms (ms, native phase bucket 6 `trial_total` as the
SVT_TRACE frame counter `walk.trial_total`): the intra walk's RD trials
(native/commit_backend.c intra_trial), summed over the tile threads, per
key frame: the mean over the window's key frames."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_intra_spans").key_mean(
        ctx, "walk.trial_total")
