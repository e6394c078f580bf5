"""gop_kernel_ms (ms, torch.profiler): the device time of the kernels,
copies and sets launched inside the SVT_TRACE stage `gop_dispatch` (the
GoP program: decide, two-level search, SAD tree, temporal filter), summed
over the window and divided by the number of mini-GoPs dispatched in
it."""


def read(ctx):
    dt = ctx.device_trace
    if dt is None:
        return None
    lo, hi = dt.window
    n = sum(1 for s, e in dt.ranges.get("stage.gop_dispatch", [])
            if lo <= s < hi)
    ops = dt.launched_in("stage.gop_dispatch")
    if not n or not ops:
        return None
    return sum(op[2] for op in ops) / 1e6 / n
