"""intra_walk_commit_ms (ms, native phase bucket 5 `commit_ec` as the
SVT_TRACE frame counter `walk.commit_ec`): the intra walk's final commit
with its entropy coding (native/commit_backend.c intra_write_commit),
summed over the tile threads, per key frame: the mean over the window's
key frames."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_intra_spans").key_mean(
        ctx, "walk.commit_ec")
