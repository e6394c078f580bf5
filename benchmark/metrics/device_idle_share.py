"""device_idle_share (%, torch.profiler): the share of the traced window
in which no kernel, copy or set ran on the card: 100 * (1 - the union of
the device intervals / the window)."""


def read(ctx):
    dt = ctx.device_trace
    if dt is None or ctx.device_kind is None or dt.window[0] is None:
        return None
    span = dt.window[1] - dt.window[0]
    if span <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_ns() / span)
