"""gop_dispatch_ms (ms, SVT_TRACE stage `gop_dispatch`): host time to launch
a mini-GoP's device program (RaDriver._dispatch_gop), per mini-GoP; the
mean over the window's per-frame records that hold the stage."""


def read(ctx):
    return ctx.stage_mean_ms("gop_dispatch")
