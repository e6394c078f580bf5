"""decide_prefetch_share (%, SVT_TRACE frame counter `decide.prefetched`):
the share of the window's key frames whose decide was dispatched during
the frame before (FastIntraEncoder.prefetch_decide) and taken by
_take_decide, against a decide launched when the frame came (0). Below
100 the prefetch misses and the frame waits for a whole decide."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_intra_spans").key_share(
        ctx, "decide.prefetched")
