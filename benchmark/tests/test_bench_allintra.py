"""The all-intra cell's files: a tiny copy of ai_p12_1080p run through
run_cell on the CPU comes out correct and its control does not, a broken
decide is caught; each of the cell's per-layer readers gives its number
from planted records and nothing without them; and the decide's work
model gives the bytes and operations counted by hand."""

import json
import os
import shutil
import time
import types

import pytest
import torch

import harness

BENCH = os.path.dirname(harness.__file__)
ROOT = os.path.dirname(BENCH)
H100 = "NVIDIA H100 80GB HBM3"


def _tiny_checkout(tmp_path):
    """A copy of the benchmark with a 192x128 CPU copy of ai_p12_1080p
    (every sample kept, the decide prefetch on) and its cell."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    cfg = json.loads((root / "benchmark" / "configs" /
                      "ai_p12_1080p.json").read_text())
    cfg.update(name="tiny_ai", width=192, height=128,
               env={"SVT_PREFETCH_CPU": "1"})
    cfg["argv"] = ["cpu" if a == "cuda" else a for a in cfg["argv"]]
    for c in cfg["checks"].values():
        c["every"] = 1
    (root / "benchmark" / "configs" / "tiny_ai.json").write_text(
        json.dumps(cfg))
    cell = "tiny_ai.clip_noise"
    m["configs"].append({"name": "tiny_ai", "source": "test",
                         "file": "benchmark/configs/tiny_ai.json",
                         "reduced": ["width", "height"], "why": "test"})
    m["workloads"].append({"name": cell, "config": "tiny_ai",
                           "traffic": "clip_noise", "chips": 1,
                           "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root, cell


def _run(root, cell, control=False, seconds=6.0):
    spec = harness.CellSpec.load(str(root), cell,
                                 bench=str(root / "benchmark"))
    harness.pin_caches(str(root), spec)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run_cell(spec, seed=2 ** 31 + 113, seconds=seconds,
                                trace=0, device="cpu",
                                process_start=time.time(), control=control)
    finally:
        torch.set_num_threads(threads)
        os.environ.pop("SVT_PREFETCH_CPU", None)


def test_tiny_allintra_cell_is_correct_and_its_control_is_not(tmp_path):
    root, cell = _tiny_checkout(tmp_path)
    r = _run(root, cell, control=True)
    assert r["correct"], r["compared"]
    assert r["control_correct"] is False, r["compared"]
    assert set(r["compared"]) == {
        "decide_mismatch", "stream_recon_mismatch",
        "control.decide_mismatch", "control.stream_recon_mismatch"}
    for k in ("control.decide_mismatch", "control.stream_recon_mismatch"):
        c = r["compared"][k]
        assert c["value"] > c["limit"], r["compared"]
    assert r["attempted"] > 0
    assert 20 < r["metrics"]["psnr_y_db"]["value"] < 60


def test_tiny_allintra_cell_catches_a_broken_decide(tmp_path):
    import svt_av1_psy_tpu_torch.models.fast_intra as fi
    root, cell = _tiny_checkout(tmp_path)
    orig = fi.intra_decide_packed

    def broken(*a, **k):
        out = orig(*a, **k).clone()
        out[-1] ^= 1
        return out

    fi.intra_decide_packed = broken
    try:
        r = _run(root, cell)
    finally:
        fi.intra_decide_packed = orig
    assert not r["correct"], r["compared"]
    c = r["compared"]["decide_mismatch"]
    assert c["value"] is not None and c["value"] > c["limit"], r["compared"]


# --- the readers, on planted records -----------------------------------------

class _Trace:
    def __init__(self, recs):
        self._recs = recs

    def records(self, t0=None, t1=None):
        return [r for r in self._recs if (t0 is None or r["t0"] >= t0) and
                (t1 is None or r["t0"] <= t1)]


_ids = iter(range(1, 10 ** 6))


def _span(name, t0, t1, kind="span", frame=0, parent=None, **kw):
    return {"span": name, "kind": kind, "id": next(_ids), "parent": parent,
            "thread": 1, "frame": frame, "t0": t0, "t1": t1, **kw}


def _ctx(recs=(), records=(), trace=True, **kw):
    base = dict(records=list(records), spans={}, device_trace=None,
                t_open=0.0, t_last=1.0, device_kind=H100,
                config={"width": 1920, "height": 1080, "bit_depth": 8},
                _trace_mod=_Trace(list(recs)) if trace else None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


NEW = ("intra_commit_walk_ms", "intra_walk_trial_ms", "intra_walk_commit_ms",
       "intra_walk_tile_imbalance", "decide_wait_ms", "decide_device_ms",
       "decide_prefetch_share", "key_filter_join_ms", "decide_roofline")


def _planted():
    w0 = _span("intra_commit_walk", 0, 1000, kind="stage", frame=5)
    w1 = _span("intra_commit_walk", 2000, 3000, kind="stage", frame=6)
    p = _span("inter_commit_walk", 4000, 5000, kind="stage", frame=7)
    recs = [w0, w1, p,
            _span("walk_tile", 10, 110, kind="tile", frame=5,
                  parent=w0["id"], tile=0),
            _span("walk_tile", 10, 310, kind="tile", frame=5,
                  parent=w0["id"], tile=1),
            _span("walk_tile", 2010, 2210, kind="tile", frame=6,
                  parent=w1["id"], tile=0),
            _span("walk_tile", 2010, 2210, kind="tile", frame=6,
                  parent=w1["id"], tile=1),
            # an inter walk's tile is not counted
            _span("walk_tile", 4010, 9010, kind="tile", frame=7,
                  parent=p["id"], tile=0),
            _span("filter_join", 100, 1_000_100, frame=5),
            _span("filter_join", 2100, 3_002_100, frame=6),
            # a P frame's join is not counted
            _span("filter_join", 4100, 90_004_100, frame=7),
            _span("decide_program", 50, 60, kind="device", frame=5,
                  device_ms=6.0),
            _span("decide_program", 1050, 1060, kind="device", frame=6,
                  device_ms=8.0)]
    records = [{"frame": 5, "intra_commit_walk": 400.0, "device_search": 1.5,
                "walk.trial_total": 900.0, "walk.commit_ec": 300.0,
                "decide.prefetched": 0},
               {"frame": 6, "intra_commit_walk": 600.0, "device_search": 0.5,
                "walk.trial_total": 1100.0, "walk.commit_ec": 500.0,
                "decide.prefetched": 1},
               {"frame": 7, "inter_commit_walk": 300.0, "device_search": 9.0,
                "walk.trial_total": 5.0, "walk.commit_ec": 5.0,
                "decide.prefetched": 1}]
    return recs, records


def test_allintra_readers_read_planted_records():
    recs, records = _planted()
    ctx = _ctx(recs, records)
    assert _read("intra_commit_walk_ms", ctx) == pytest.approx(500.0)
    assert _read("intra_walk_trial_ms", ctx) == pytest.approx(1000.0)
    assert _read("intra_walk_commit_ms", ctx) == pytest.approx(400.0)
    # walk 0: slowest 300 against a mean of 200 (+50%); walk 1: even
    assert _read("intra_walk_tile_imbalance", ctx) == pytest.approx(25.0)
    assert _read("decide_wait_ms", ctx) == pytest.approx(1.0)
    assert _read("decide_device_ms", ctx) == pytest.approx(7.0)
    assert _read("decide_prefetch_share", ctx) == pytest.approx(50.0)
    assert _read("key_filter_join_ms", ctx) == pytest.approx(2.0)
    work = harness.load_module("metrics", "_decide_work")
    least_ms = 1e3 * work.least_s(1088, 1920, 1, 8, 3.35e12,
                                  work.INT_OPS_PER_S[H100])
    assert _read("decide_roofline", ctx) == pytest.approx(
        100 * least_ms / 7.0)
    assert 0 < _read("decide_roofline", ctx) <= 100


@pytest.mark.parametrize("name", NEW)
def test_allintra_readers_give_nothing_without_records(name):
    """No records (an untraced run, a program without the span or
    counter, a window without a key frame): no reading, nothing raised."""
    recs, records = _planted()
    inter_only = [r for r in records if "inter_commit_walk" in r]
    for ctx in (_ctx(trace=False), _ctx(trace=False, t_last=None),
                _ctx(_trace_mod=types.SimpleNamespace(_frames=[])), _ctx(),
                _ctx([r for r in recs if r["frame"] == 7], inter_only)):
        assert _read(name, ctx) is None


def test_prefetch_share_absent_where_the_program_has_no_counter():
    recs, records = _planted()
    for r in records:
        r.pop("decide.prefetched")
    assert _read("decide_prefetch_share", _ctx(recs, records)) is None


def test_decide_roofline_needs_the_card():
    recs, records = _planted()
    assert _read("decide_roofline", _ctx(recs, records,
                                         device_kind=None)) is None
    assert _read("decide_roofline", _ctx(recs, records,
                                         device_kind="a card")) is None


def test_decide_work_counted_by_hand():
    """A 128 x 64 plane, 8-bit, down to 8x8 blocks: 8,192 pixels; 4
    block sizes x 8,192 pixels x (86 + 39) operations plus 6 for each of
    the 2 + 8 + 32 split nodes above 8x8; the plane read once (8,192
    bytes) and the packed result written once (42 split flags, 3 x 170
    modes)."""
    work = harness.load_module("metrics", "_decide_work")
    assert work.PRED_OPS == 86 and work.SAD_OPS == 39
    assert work.operations(128, 64, 8) == 4 * 8192 * 125 + 6 * 42 == \
        4_096_252
    assert work.bytes_moved(128, 64, 1) == 8192 + 42 + 3 * 170 == 8744
    # down to 16x16: 3 sizes, split nodes at 64 and 32 only
    assert work.operations(128, 64, 16) == 3 * 8192 * 125 + 6 * 10
    assert work.padded(1080, 1920) == (1088, 1920)
    peak = work.INT_OPS_PER_S[H100]
    assert peak == pytest.approx(64 * 132 * 1.98e9)
    # at 1080p the operations bound the decide, not the bytes
    ops_s = work.operations(1088, 1920, 8) / peak
    assert work.least_s(1088, 1920, 1, 8, 3.35e12, peak) == ops_s
    assert work.bytes_moved(1088, 1920, 1) / 3.35e12 < ops_s / 50
