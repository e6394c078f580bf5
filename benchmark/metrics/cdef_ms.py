"""cdef_ms (ms, SVT_TRACE stage `cdef`): the native CDEF search and apply,
per frame; the mean over the window's per-frame records that hold the
stage."""


def read(ctx):
    return ctx.stage_mean_ms("cdef")
