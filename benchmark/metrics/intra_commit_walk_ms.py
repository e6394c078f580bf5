"""intra_commit_walk_ms (ms, SVT_TRACE stage `intra_commit_walk`): the
key frame's tile-parallel commit walk (FastIntraEncoder._encode_key: mode
and TX split trials, the commit, entropy coding), per key frame: the mean
over the window's key frames."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_intra_spans").key_mean(
        ctx, "intra_commit_walk")
