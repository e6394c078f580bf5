"""The readers of the program's own spans and counters on synthetic
records: device spans, the native phase counters, the tile spans, the
filter searches and joins, and the split of the device's idle time by
interval overlap with the clock offset that maps the program's spans onto
the profiler's."""

import random
import types

import pytest

import harness


class _Trace:
    """A stand-in for the program's trace module: records(t0, t1) as
    utils/trace.py gives them."""

    def __init__(self, recs):
        self._recs = recs

    def records(self, t0=None, t1=None):
        return [r for r in self._recs if (t0 is None or r["t0"] >= t0) and
                (t1 is None or r["t0"] <= t1)]


_ids = iter(range(1, 10 ** 6))


def _span(name, t0, t1, kind="span", thread=1, parent=None, **kw):
    return {"span": name, "kind": kind, "id": next(_ids), "parent": parent,
            "thread": thread, "frame": 0, "t0": t0, "t1": t1, **kw}


def _ctx(recs=(), records=(), t_open=0.0, t_last=1.0, trace=True, **kw):
    base = dict(records=list(records), spans={}, device_trace=None,
                t_open=t_open, t_last=t_last, device_kind=None,
                _trace_mod=_Trace(list(recs)) if trace else None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


NEW = ("gop_device_ms", "lr_device_ms", "walk_commit_ms", "walk_trial_ms",
       "walk_search_ms", "walk_tile_cpu_share", "walk_tile_imbalance", "filter_join_ms",
       "cdef_search_ms", "dlf_search_ms", "idle_unspanned_share")


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_without_records(name):
    """No span records (a program whose trace module has no records(), or
    an untraced run): no reading, and nothing raised."""
    for ctx in (_ctx(trace=False), _ctx(trace=False, t_last=None),
                _ctx(_trace_mod=types.SimpleNamespace(_frames=[])), _ctx()):
        assert _read(name, ctx) is None


def test_device_span_readers():
    recs = [_span("gop_program", 100, 200, kind="device", device_ms=600.0),
            _span("gop_program", 300, 400, kind="device", device_ms=700.0),
            # starts outside the window
            _span("gop_program", 2_000_000_000, 2_000_000_100, kind="device",
                  device_ms=9.0),
            _span("lr_program", 500, 510, kind="device", device_ms=20.0)]
    ctx = _ctx(recs)
    assert _read("gop_device_ms", ctx) == pytest.approx(650.0)
    assert _read("lr_device_ms", ctx) == pytest.approx(20.0)
    # the window is [t_open, t_last] in perf_counter seconds
    assert _read("gop_device_ms", _ctx(recs, t_open=0, t_last=2.5)) == \
        pytest.approx(1309 / 3)


def test_counter_readers_average_inter_frames():
    records = [{"frame": 0, "intra_commit_walk": 50.0, "walk.commit_ec": 9.0,
                "walk.trial_total": 99.0},
               {"frame": 1, "inter_commit_walk": 300.0,
                "walk.commit_ec": 2.0, "walk.trial_total": 10.0},
               {"frame": 2, "inter_commit_walk": 280.0,
                "walk.commit_ec": 4.0, "walk.trial_total": 30.0},
               {"frame": 3, "inter_commit_walk": 290.0}]
    search = {"walk.mc_singleref": 100.0, "walk.mc_compound": 50.0,
              "walk.masked_search": 20.0, "walk.motion_modes": 30.0}
    records[1].update(search)
    records[2].update({k: 2 * v for k, v in search.items()})
    records[0].update(search)                 # a key frame: not counted
    ctx = _ctx(records=records)
    assert _read("walk_commit_ms", ctx) == pytest.approx(3.0)
    assert _read("walk_trial_ms", ctx) == pytest.approx(20.0)
    assert _read("walk_search_ms", ctx) == pytest.approx(300.0)
    for name in ("walk_commit_ms", "walk_search_ms"):
        assert _read(name, _ctx(records=records[3:])) is None


def test_tile_readers():
    w1 = _span("inter_commit_walk", 0, 1000, kind="stage")
    w2 = _span("inter_commit_walk", 2000, 3000, kind="stage")
    k = _span("intra_commit_walk", 4000, 5000, kind="stage")
    recs = [w1, w2, k,
            _span("walk_tile", 10, 110, kind="tile", thread=7,
                  parent=w1["id"], tile=0, cpu_ns=100),
            _span("walk_tile", 10, 310, kind="tile", thread=8,
                  parent=w1["id"], tile=1, cpu_ns=150),
            _span("walk_tile", 2010, 2210, kind="tile", thread=9,
                  parent=w2["id"], tile=0, cpu_ns=200),
            _span("walk_tile", 2010, 2210, kind="tile", thread=10,
                  parent=w2["id"], tile=1, cpu_ns=200),
            # an intra walk's tile is not counted
            _span("walk_tile", 4010, 9010, kind="tile", thread=7,
                  parent=k["id"], tile=0, cpu_ns=1)]
    ctx = _ctx(recs)
    assert _read("walk_tile_cpu_share", ctx) == pytest.approx(
        100 * 650 / 800)
    # walk 1: slowest 300 against a mean of 200 (+50%); walk 2: even
    assert _read("walk_tile_imbalance", ctx) == pytest.approx(25.0)
    assert _read("walk_tile_cpu_share", _ctx(recs[2:3])) is None


def test_span_mean_readers():
    recs = [_span("filter_join", 0, 1_000_000),
            _span("filter_join", 5, 3_000_005),
            _span("cdef_search", 10, 40_000_010, parent=3),
            _span("dlf_search", 20, 5_000_020)]
    ctx = _ctx(recs)
    assert _read("filter_join_ms", ctx) == pytest.approx(2.0)
    assert _read("cdef_search_ms", ctx) == pytest.approx(40.0)
    assert _read("dlf_search_ms", ctx) == pytest.approx(5.0)
    assert _read("cdef_search_ms", _ctx(recs[:2])) is None


def _idle():
    return harness.load_module("metrics", "idle_unspanned_share")


def test_overlap_splits_a_gap_the_midpoint_gives_to_one_stage():
    """A device gap that spans two stages: the harness's midpoint rule
    gives it whole to one of them; the overlap split gives each stage its
    share, and the part under no span to nobody."""
    ops = [("k_a", 0, 100, 0), ("k_b", 1000, 100, 950)]
    ranges = {"bench.window": [(0, 1100)],
              "stage.inter_commit_walk": [(150, 500)],
              "stage.dlf": [(500, 950)]}
    dt = harness.DeviceTrace(ops, ranges, (0, 1100), 1.1e-6)
    assert dt.gaps() == [(100, 1000)]
    assert dt.breakdown()["idle_gaps"] == [["stage.dlf", 900 / 1e9]]
    # the program's spans: the same stages on a clock 10_000 ns behind,
    # a tile span inside the walk, a span on another thread
    recs = [_span("inter_commit_walk", -9850, -9500, kind="stage"),
            _span("walk_tile", -9800, -9600, kind="tile", tile=0,
                  cpu_ns=1),
            _span("dlf", -9500, -9050, kind="stage"),
            _span("leaf_filter", -9900, -9000, thread=2)]
    ctx = _ctx(recs, t_open=-10e-6, device_trace=dt,
               device_kind="NVIDIA H100 80GB HBM3")
    split, res = _idle().idle_split(ctx)
    assert split == {"inter_commit_walk": 150, "walk_tile": 200,
                     "dlf": 450, None: 100}
    assert res == [0, 0]
    assert _read("idle_unspanned_share", ctx) == pytest.approx(
        100 * 100 / 900)
    # no device on the CPU, no reading
    ctx.device_kind = None
    assert _read("idle_unspanned_share", ctx) is None


def test_offset_fit_finds_a_planted_offset():
    rng = random.Random(5)
    off = 1_700_000_000_123_456_789 - 5_000_000_000
    spans, ranges = [], {}
    t = 5_000_000_000
    for i in range(300):
        name = ("inter_commit_walk", "cdef", "dlf")[i % 3]
        d = rng.randrange(1_000_000, 50_000_000)
        spans.append(_span(name, t, t + d, kind="stage"))
        j = rng.randrange(-20_000, 20_000)          # up to 20 us of jitter
        ranges.setdefault("stage." + name, []).append(
            (t + off + j, t + d + off + j))
        t += d + rng.randrange(0, 3_000_000)
    # the profiler ran over the middle of the spans only
    for k in ranges:
        ranges[k] = sorted(ranges[k])[10:-10]
    coarse = off + 800_000                  # a first guess 0.8 ms out
    got, res = _idle().clock_offset(ranges, spans, coarse)
    assert abs(got - off) < 5_000
    assert len(res) == 300 - 60
    assert max(abs(r) for r in res) <= 40_000
    # a guess farther out than the matching tolerance finds no pair
    assert _idle().clock_offset(ranges, spans, off + 100 * 10 ** 9) is None


def test_flatten_gives_each_instant_to_the_innermost_span():
    segs = _idle().flatten([(0, 100, "a"), (10, 30, "b"), (20, 25, "c"),
                            (50, 60, "d"), (200, 300, "e")])
    assert segs == [(0, 10, "a"), (10, 20, "b"), (20, 25, "c"),
                    (25, 30, "b"), (30, 50, "a"), (50, 60, "d"),
                    (60, 100, "a"), (200, 300, "e")]
    assert _idle().split_gaps([(5, 22), (90, 250)], segs) == {
        "a": 15, "b": 10, "c": 2, "e": 50, None: 100}
