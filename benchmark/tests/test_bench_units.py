"""Unit tests of the harness on the CPU: the frame generator, the metric
readers' arithmetic on recorded spans and profiler intervals, the
window's counting rule, the scan for JAX modules, and run.py without a
card."""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import harness

BENCH = os.path.dirname(harness.__file__)
ROOT = os.path.dirname(BENCH)


def test_frames_equal_make_frame_without_noise():
    from svt_av1_psy_tpu_torch.utils.test_clip import make_frame
    src = harness.load_module("sources", "clip_noise").Source(
        {"noise": 0.0}, {"width": 176, "height": 144, "bit_depth": 8},
        seed=3, device="cpu")
    for t in (0, 1, 7, 40):
        for a, b in zip(src.frame(t), make_frame(176, 144, t, 8)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_frames_follow_the_seed():
    mod = harness.load_module("sources", "clip_noise")
    cfg = {"width": 176, "height": 144, "bit_depth": 8}
    big = 2 ** 31 + 12345
    a = [mod.Source({}, cfg, big, "cpu").frame(t)[0] for t in range(2)]
    b = [mod.Source({}, cfg, big, "cpu").frame(t)[0] for t in range(2)]
    c = mod.Source({}, cfg, big + 1, "cpu").frame(0)[0]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c)
    # frame t does not depend on the frames asked for before it
    again = mod.Source({}, cfg, big, "cpu")
    assert np.array_equal(again.frame(1)[0], a[1])
    assert np.array_equal(again.frame(0)[0], a[0])
    assert not np.array_equal(a[0], a[1])


def _ctx(**kw):
    base = dict(records=[], spans={}, device_trace=None, frames=0,
                bytes=0, t_open=0.0, t_last=None, device_kind=None,
                config={"width": 1920, "height": 1080, "bit_depth": 8})
    base.update(kw)
    ctx = types.SimpleNamespace(**base)
    ctx.stage_mean_ms = lambda s: harness.Ctx.stage_mean_ms(ctx, s)
    return ctx


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_stage_readers_average_the_records_that_hold_the_stage():
    recs = [{"frame": 0, "inter_commit_walk": 100.0, "cdef": 10.0},
            {"frame": 1, "inter_commit_walk": 300.0},
            {"frame": 2, "gop_dispatch": 900.0, "gop_fetch": 5.0}]
    ctx = _ctx(records=recs)
    assert _read("inter_commit_walk_ms", ctx) == 200.0
    assert _read("cdef_ms", ctx) == 10.0
    assert _read("gop_dispatch_ms", ctx) == 900.0
    assert _read("gop_fetch_ms", ctx) == 5.0
    assert _read("loop_restoration_ms", ctx) is None
    assert _read("device_search_ms", ctx) is None


def _trace():
    # window 0..1000 ns; kernels at [100, 300) and [200, 400) (overlap),
    # [600, 700), a K1 launch [800, 900); launches at 50, 60, 550, 750
    ops = [("k_a", 100, 200, 50), ("k_b", 200, 200, 60),
           ("k_c", 600, 100, 550), ("hme_sad_scan_kernel<uchar>", 800, 100,
                                    750)]
    ranges = {"bench.window": [(0, 1000)],
              "stage.gop_dispatch": [(40, 70), (540, 560)],
              "stage.inter_commit_walk": [(400, 600)]}
    return harness.DeviceTrace(ops, ranges, (0, 1000), 1e-6)


def test_device_trace_arithmetic():
    dt = _trace()
    assert dt.busy_ns() == 300 + 100 + 100
    assert dt.gaps() == [(0, 100), (400, 600), (700, 800), (900, 1000)]
    b = dt.breakdown()
    # each gap goes to the innermost range at its midpoint
    assert sorted(b["idle_gaps"]) == [["host outside any span", 200 / 1e9],
                                      ["stage.gop_dispatch", 100 / 1e9],
                                      ["stage.inter_commit_walk", 200 / 1e9]]
    assert b["device_ops"][0] == ["k_a", 200 / 1e9]
    kind = "NVIDIA H100 80GB HBM3"
    ctx = _ctx(device_trace=dt, device_kind=kind)
    assert _read("device_idle_share", ctx) == pytest.approx(50.0)
    # three ops launched inside the two gop_dispatch ranges, 500 ns / 2
    assert _read("gop_kernel_ms", ctx) == pytest.approx(250 / 1e6)
    k1 = harness.load_module("metrics", "k1_roofline")
    want = 100 * (2 * 1088 * 1920 + 8160 * 8) / 3.35e12 / 100e-9
    assert _read("k1_roofline", ctx) == pytest.approx(want)
    assert k1.bytes_moved(1088, 1920, 1) == 4243200
    assert _read("device_idle_share", _ctx(device_trace=dt)) is None


def test_tpl_span_reader():
    ctx = _ctx(spans={"tpl_sb_offsets": [0.1, 0.2]})
    assert _read("tpl_sb_offsets_ms", ctx) == pytest.approx(150.0)
    assert _read("tpl_sb_offsets_ms", _ctx()) is None


def _spec():
    return harness.CellSpec.load(ROOT, "vod_ra_p6_1080p.clip_noise")


def test_window_counts_whole_batches_inside_it(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(harness.time, "perf_counter", lambda: now[0])
    monkeypatch.setattr(harness.time, "time", lambda: now[0])
    ctx = harness.Ctx(_spec(), 1, 40.0, 0, "cpu", process_start=70.0)
    ctx.complete(32, 999)                 # before the window: not counted
    ctx.open_window()
    assert ctx.setup_s == 30.0
    now[0] = 111.0
    ctx.complete(32, 3200)
    now[0] = 122.0
    ctx.tick()
    ctx.complete(32, 3200)
    now[0] = 139.0
    ctx.tick()
    assert ctx.in_window
    now[0] = 141.0                        # a batch that ends past the end
    ctx.complete(32, 3200)
    assert not ctx.in_window and ctx.frames == 64 and ctx.bytes == 6400
    assert _read("encode_fps", ctx) == pytest.approx(64 / 22.0)
    assert _read("kbytes_per_frame", ctx) == pytest.approx(100 / 1024)


def test_sampling_follows_the_seed():
    def picks(seed):
        ctx = harness.Ctx(_spec(), seed, 1.0, 0, "cpu", 0.0)
        ctx.in_window = True
        out = []
        for i in range(64):
            if ctx.take("k1", 8):
                ctx.keep("k1", i)
                out.append(i)
        return out
    a, b = picks(2 ** 31 + 5), picks(2 ** 31 + 5)
    assert a == b and a[0] == 0 and 2 < len(a) < 24
    assert a != picks(7)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "svt_av1_psy_tpu" not in harness.forbidden_modules()
    import svt_av1_psy_tpu_torch  # noqa: F401  (the port is allowed)
    assert harness.forbidden_modules() == [] or \
        "svt_av1_psy_tpu_torch" not in harness.forbidden_modules()
    for name in ("jax.numpy", "svt_av1_psy_tpu.ops", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert {"jax", "svt_av1_psy_tpu", "jaxlib", "flax"} <= set(found)
    assert "svt_av1_psy_tpu_torch" not in found


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "vod_ra_p6_1080p.clip_noise",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_run_exits_nonzero_on_an_unknown_workload():
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "no_such.cell", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def test_manifest_names_files_that_exist():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    for c in m["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert os.path.isfile(os.path.join(BENCH, "drivers",
                                           cfg["driver"] + ".py"))
        for name in cfg.get("checks", {}):
            assert os.path.isfile(os.path.join(BENCH, "checks",
                                               name + ".py"))
    for w in m["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for m_ in m["end_to_end"] + m["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m_["name"] + ".py"))


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "live_ld_p10_1080p.clip_noise",
                        "--seed", str(2 ** 31 + 9), "--seconds", "15",
                        "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["metrics"]["encode_fps"]["value"] > 0
