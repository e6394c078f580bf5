"""What the new per-layer readers share: the program's own span records
(svt_av1_psy_tpu_torch/utils/trace.py records()) that start inside the
window, [ctx.t_open, ctx.t_last] on the program clock (perf_counter).

Everything here returns None, and raises nothing, where the program has
no span records to give: a run without --trace 1, or a program whose
trace module predates records()."""


def window(ctx, name=None):
    """The window's span records (all, or those called name), or None."""
    tm = getattr(ctx, "_trace_mod", None)
    read = getattr(tm, "records", None)
    if read is None or ctx.t_open is None or ctx.t_last is None:
        return None
    recs = read(int(ctx.t_open * 1e9), int(ctx.t_last * 1e9))
    return recs if name is None else [r for r in recs if r["span"] == name]


def mean_ms(ctx, name):
    """The mean host milliseconds of the window's spans called name."""
    spans = window(ctx, name)
    if not spans:
        return None
    return sum(r["t1"] - r["t0"] for r in spans) / 1e6 / len(spans)


def mean_device_ms(ctx, name):
    """The mean CUDA-event milliseconds of the window's device spans
    called name (those resolved by the time the reader asks)."""
    vals = [r["device_ms"] for r in window(ctx, name) or ()
            if r.get("device_ms") is not None]
    if not vals:
        return None
    return sum(vals) / len(vals)


def inter_tiles(ctx):
    """{walk span id: [its walk_tile spans]} for the window's inter
    walks (stage inter_commit_walk), or None."""
    recs = window(ctx)
    if not recs:
        return None
    walks = {r["id"]: [] for r in recs if r["span"] == "inter_commit_walk"}
    for r in recs:
        if r["span"] == "walk_tile" and r["parent"] in walks:
            walks[r["parent"]].append(r)
    walks = {k: v for k, v in walks.items() if v}
    return walks or None


def frame_counter_mean(ctx, *names):
    """The mean of per-frame counters, summed, over the window's inter
    frames (records that hold the stage inter_commit_walk and each
    counter)."""
    vals = [sum(r[n] for n in names) for r in ctx.records
            if "inter_commit_walk" in r and all(n in r for n in names)]
    if not vals:
        return None
    return sum(vals) / len(vals)
