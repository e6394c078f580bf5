"""What the all-intra cell's readers share: the window's key frames, read
from the program's per-frame records (ctx.records, one per frame, holding
each stage's milliseconds and each counter) and its span records
(_program_spans.window). A key frame is a record that holds the stage
intra_commit_walk (FastIntraEncoder._encode_key).

Everything here returns None, and raises nothing, where the program gives
nothing to read: a run without --trace 1, a window with no key frame, or
a program that lacks the span or counter asked for."""

import harness


def _program_spans():
    return harness.load_module("metrics", "_program_spans")


def key_records(ctx):
    """The window's per-frame records of key frames."""
    return [r for r in getattr(ctx, "records", None) or ()
            if "intra_commit_walk" in r]


def key_mean(ctx, name):
    """The mean of a stage's milliseconds or a counter over the window's
    key frames that hold it."""
    vals = [r[name] for r in key_records(ctx) if name in r]
    if not vals:
        return None
    return sum(vals) / len(vals)


def key_share(ctx, name):
    """100 x the mean of a 0 / 1 frame counter over the window's key
    frames, a frame without it counting 0; None where no frame has it."""
    recs = key_records(ctx)
    if not any(name in r for r in recs):
        return None
    return 100.0 * sum(r.get(name, 0) for r in recs) / len(recs)


def key_span_mean_ms(ctx, name):
    """The mean host milliseconds of the window's spans called name that
    belong to a key frame."""
    keys = {r["frame"] for r in key_records(ctx)}
    spans = [s for s in _program_spans().window(ctx, name) or ()
             if s["frame"] in keys]
    if not spans:
        return None
    return sum(s["t1"] - s["t0"] for s in spans) / 1e6 / len(spans)


def key_tiles(ctx):
    """{walk span id: [its walk_tile spans]} for the window's intra walks
    (stage intra_commit_walk), or None."""
    recs = _program_spans().window(ctx)
    if not recs:
        return None
    walks = {r["id"]: [] for r in recs if r["span"] == "intra_commit_walk"}
    for r in recs:
        if r["span"] == "walk_tile" and r["parent"] in walks:
            walks[r["parent"]].append(r)
    walks = {k: v for k, v in walks.items() if v}
    return walks or None
