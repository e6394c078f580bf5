"""walk_commit_ms (ms, native phase bucket 5 `commit_ec` as the SVT_TRACE
frame counter `walk.commit_ec`): the C walk's commit of intra-chosen
blocks (native/commit_backend.c intra_write_commit: the chosen mode's
transform, recon and symbol write), summed over the tile threads, per
inter frame: the mean over the window's inter frames."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_program_spans") \
        .frame_counter_mean(ctx, "walk.commit_ec")
