"""gop_fetch_ms (ms, SVT_TRACE stage `gop_fetch`): host time waiting for a
mini-GoP's packed result (RaDriver._walk_gop), per mini-GoP; the mean over
the window's per-frame records that hold the stage."""


def read(ctx):
    return ctx.stage_mean_ms("gop_fetch")
