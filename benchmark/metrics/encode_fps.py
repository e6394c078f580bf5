"""encode_fps (frames/s, host clock): whole frames whose packets came back
inside the window, over the time from the window's opening to the last of
those returns. In random access a mini-GoP's packets return together, so
only whole mini-GoPs count."""


def read(ctx):
    if not ctx.frames or ctx.t_last is None or ctx.t_last <= ctx.t_open:
        return None
    return ctx.frames / (ctx.t_last - ctx.t_open)
