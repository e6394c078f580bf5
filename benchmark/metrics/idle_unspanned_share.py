"""idle_unspanned_share (%, torch.profiler and SVT_TRACE spans): the share
of the window's device-idle time in which the encoder thread was inside
no program span: 100 * (idle ns outside every encoder-thread span / idle
ns), split by interval overlap, not by a gap's midpoint.

The program's spans are on its own clock (perf_counter_ns); the
profiler's device gaps on the profiler's. One offset maps the first onto
the second: the median, over the window, of (start of a profiler range
stage.<name>, which the harness opens around each stage, - start of the
same stage's program span), the two matched by name and order. No match,
no reading.

The helpers (clock_offset, flatten, split_gaps, encoder_spans) are the
mapping and the overlap attribution whole, for any reader that splits the
device's idle time by what the host was doing."""

import statistics

MATCH_NS = 2_000_000        # a range and its span start this close


def encoder_spans(recs):
    """The host spans of the thread that runs the stages (the encoder
    thread): device spans left out."""
    threads = [r["thread"] for r in recs if r["kind"] == "stage"]
    if not threads:
        return []
    enc = statistics.mode(threads)
    return [r for r in recs if r["thread"] == enc and r["kind"] != "device"]


def clock_offset(ranges, spans, coarse):
    """(offset, residuals): program clock + offset = profiler clock, as
    the median over matched (range, span) pairs of their starts'
    difference, and each pair's difference from it; None without a pair.

    ranges: {name: sorted [(start, end)]} of the profiler; spans: program
    span records; coarse: a first guess of the offset (the window's)
    that puts each span within MATCH_NS of its range."""
    by_name: dict = {}
    for r in spans:
        if r["kind"] == "stage":
            by_name.setdefault(r["span"], []).append(r["t0"])
    diffs = []
    for name, starts in by_name.items():
        rs = ranges.get("stage." + name, [])
        starts.sort()
        j = 0
        for a, _ in rs:
            while j < len(starts) and starts[j] + coarse < a - MATCH_NS:
                j += 1
            if j < len(starts) and abs(starts[j] + coarse - a) <= MATCH_NS:
                diffs.append(a - starts[j])
                j += 1
    if not diffs:
        return None
    off = statistics.median(diffs)
    return off, [d - off for d in diffs]


def flatten(intervals):
    """Nested (start, end, label) intervals of one thread as disjoint
    segments, each instant labelled by the innermost interval open then."""
    segs, stack, cur = [], [], None

    def emit(upto):
        nonlocal cur
        if upto > cur:
            segs.append((cur, upto, stack[-1][1]))
            cur = upto

    for s, e, label in sorted(intervals, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        if stack:
            emit(s)
            e = min(e, stack[-1][0])
        cur = s if cur is None else max(cur, s)
        stack.append((e, label))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return segs


def split_gaps(gaps, segs):
    """{label: ns} of the sorted, disjoint gaps, by overlap with the
    sorted, disjoint segments; the time no segment covers under None."""
    out: dict = {}
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered = 0
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0) + hi - lo
                covered += hi - lo
            k += 1
        out[None] = out.get(None, 0) + (b - a) - covered
    return out


def idle_split(ctx, label=lambda r: r["span"]):
    """({label: idle ns}, residuals) for the traced window, or None."""
    dt = ctx.device_trace
    tm = getattr(ctx, "_trace_mod", None)
    read = getattr(tm, "records", None)
    if dt is None or read is None or dt.window[0] is None or \
            ctx.t_open is None:
        return None
    spans = encoder_spans(read())
    fit = clock_offset(dt.ranges, spans,
                       dt.window[0] - int(ctx.t_open * 1e9))
    if fit is None:
        return None
    off, residuals = fit
    lo, hi = dt.window
    mapped = [(r["t0"] + off, r["t1"] + off, label(r)) for r in spans
              if r["t1"] + off > lo and r["t0"] + off < hi]
    return split_gaps(dt.gaps(), flatten(mapped)), residuals


def read(ctx):
    if ctx.device_kind is None:
        return None
    got = idle_split(ctx)
    if got is None:
        return None
    split = got[0]
    idle = sum(split.values())
    if idle <= 0:
        return None
    return 100.0 * split.get(None, 0) / idle
