"""dlf_search_ms (ms, SVT_TRACE span `dlf_search`): the deblocking level
trials (5 luma and 2 x 3 chroma dlf_try_level calls,
FastIntraEncoder._pick_and_apply_dlf) without the applies, per frame that
searched: the mean over the window's searches."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_program_spans").mean_ms(
        ctx, "dlf_search")
