"""walk_search_ms (ms, native phase buckets 8-11 as the SVT_TRACE frame
counters walk.mc_singleref, walk.mc_compound, walk.masked_search and
walk.motion_modes): the C inter walk's candidate search
(native/inter_backend.c encode_block_p: single-reference MC and trials,
compound, masked compound, motion modes; four disjoint phases), summed
over the tile threads, per inter frame: the mean over the window's inter
frames. Buckets 5 and 6 (walk_commit_ms, walk_trial_ms) time the intra
path only, which inter frames rarely take."""

import harness

BUCKETS = ("walk.mc_singleref", "walk.mc_compound", "walk.masked_search",
           "walk.motion_modes")


def read(ctx):
    return harness.load_module("metrics", "_program_spans") \
        .frame_counter_mean(ctx, *BUCKETS)
