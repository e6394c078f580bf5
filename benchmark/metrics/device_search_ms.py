"""device_search_ms (ms, SVT_TRACE stage `device_search`): the frame
pipeline's device stage (FastIntraEncoder), per P frame: the launches and
the wait for their host copies; the mean over the window's per-frame
records that hold the stage."""


def read(ctx):
    return ctx.stage_mean_ms("device_search")
