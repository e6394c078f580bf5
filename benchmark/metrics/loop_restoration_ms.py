"""loop_restoration_ms (ms, SVT_TRACE stage `loop_restoration`): the loop-
restoration stage (DeviceLrSearch dispatch and finish, and the apply), per
filtered frame; the mean over the window's per-frame records that hold the
stage."""


def read(ctx):
    return ctx.stage_mean_ms("loop_restoration")
