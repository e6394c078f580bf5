"""inter_commit_walk_ms (ms, SVT_TRACE stage `inter_commit_walk`): the native
inter commit walk (native/*.c through native.py), per inter frame; the
mean over the window's per-frame records that hold the stage."""


def read(ctx):
    return ctx.stage_mean_ms("inter_commit_walk")
