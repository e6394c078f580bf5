"""cdef_search_ms (ms, SVT_TRACE span `cdef_search`): CDEF's strength
ladder (11 subsampled trials, FastIntraEncoder._search_apply_cdef)
without its apply, per frame that searched: the mean over the window's
searches (keys and every cdef_search_interval-th frame)."""

import harness


def read(ctx):
    return harness.load_module("metrics", "_program_spans").mean_ms(
        ctx, "cdef_search")
