"""The port's trace (svt_av1_psy_tpu_torch/utils/trace.py): span records
with ids, parents, threads and frames on one clock; per-frame records and
the summary derived from them; runtime control and windowed reads; spans
handed to worker threads; CUDA-event device spans resolved without a
sync; and the encoder's instrumented sites, which must not change a byte.

Imports nothing of JAX, so the cuda test also runs where JAX is not
installed (``--noconftest -m cuda``).
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch import native
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
from svt_av1_psy_tpu_torch.utils import trace
from svt_av1_psy_tpu_torch.utils.test_clip import make_frame

ROOT = pathlib.Path(__file__).resolve().parent.parent

RA_TF = EncoderConfig(enc_mode=10, qp=30, hierarchical_levels=3,
                      intra_period_length=-1, enable_tf=1, tf_strength=1)
LD = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                   pred_structure=PredStructure.LOW_DELAY_B)


@pytest.fixture
def tr(monkeypatch):
    """The trace module, off and empty, restored afterwards; one torch
    thread; SVT_NATIVE_PROF unset for the test and put back after it."""
    was = trace.ENABLED
    monkeypatch.setenv("SVT_NATIVE_PROF", "unset")
    monkeypatch.delenv("SVT_NATIVE_PROF")
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL", "SVT_HME_GLOBK",
                 "SVT_TILE_SEQ"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()
    if was:
        trace.enable()
    torch.set_num_threads(n)


def _frames(w, h, n, seed=7):
    rng = np.random.default_rng(seed)
    return [make_frame(w, h, t, 8, 0.02, rng) for t in range(n)]


def _encode_ra(frames, w=176, h=144):
    enc = Encoder(RA_TF, w, h, device="cpu")
    try:
        pkts = [p for f in frames for p in enc.send_picture(*f)]
        return [p.payload for p in pkts + enc.flush()]
    finally:
        enc.close()


def _encode_ld(frames, w=176, h=144):
    enc = Encoder(LD, w, h, device="cpu")
    try:
        return [enc.encode(*f).payload for f in frames]
    finally:
        enc.close()


# --- the module alone -------------------------------------------------------

def test_off_path_records_nothing(tr, monkeypatch):
    """Off: every site returns at once, with no record, no event, no CPU
    clock, no native profiler and SVT_NATIVE_PROF left alone."""
    def boom(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(native, "prof_get", boom)
    monkeypatch.setattr(trace.time, "thread_time_ns", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    with tr.stage("a"):
        with tr.span("b"):
            pass
    walk = tr.walk_begin()
    with tr.tile_span(walk, 0):
        pass
    tr.walk_end(walk)
    tr.count("c", 1.0)
    assert tr.handoff() is None
    tr.device_end(tr.device_begin("d", "cuda"))
    tr.next_frame()
    assert tr._store == [] and tr._frames == [] and tr._pending == []
    assert tr.records() == [] and tr.summary() == {}
    assert "SVT_NATIVE_PROF" not in os.environ


def test_off_encode_calls_no_native_profiler(tr, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(native, "prof_get", boom)
    monkeypatch.setattr(trace.time, "thread_time_ns", boom)
    _encode_ra(_frames(176, 144, 9))
    assert tr._store == [] and tr._frames == []
    assert "SVT_NATIVE_PROF" not in os.environ


def test_enable_reset_and_windowed_reads(tr):
    tr.enable()
    assert os.environ["SVT_NATIVE_PROF"] == "1"
    host = tr.host()
    assert host["cpu_count"] == os.cpu_count()
    assert host["torch_threads"] == 1 and host["affinity"] >= 1
    t = []
    for name in ("a", "b", "c"):
        t.append(time.perf_counter_ns())
        with tr.stage(name):
            time.sleep(0.002)
    t.append(time.perf_counter_ns())
    assert [r["span"] for r in tr.records()] == ["a", "b", "c"]
    assert [r["span"] for r in tr.records(t[1], t[3] - 1)] == ["b", "c"]
    assert [r["span"] for r in tr.records(None, t[1] - 1)] == ["a"]
    assert tr.records(t[3]) == []
    tr.next_frame()
    tr.disable()
    with tr.stage("d"):
        pass
    assert len(tr.records()) == 3 and len(tr._frames) == 1
    tr.reset()
    assert tr.records() == [] and tr._frames == [] and tr.summary() == {}
    tr.enable()
    with tr.stage("e"):
        pass
    tr.next_frame()
    assert tr._frames[0]["frame"] == 0 and "e" in tr._frames[0]


def test_enable_keeps_a_set_native_profiler(tr, monkeypatch):
    monkeypatch.setenv("SVT_NATIVE_PROF", "0")
    tr.enable()
    assert os.environ["SVT_NATIVE_PROF"] == "0"


def test_frames_keep_their_shape_and_the_summary_derives(tr):
    """Per frame: the frame number, each stage's ms summed, the counters;
    spans of other kinds stay out of _frames but not out of summary()."""
    tr.enable()
    for f in range(2):
        for _ in range(2):
            with tr.stage("walk"):
                time.sleep(0.001)
        with tr.span("join"):
            pass
        tr.count("walk.trial_total", 1.5)
        tr.count("walk.trial_total", 2.0)
        tr.next_frame()
    tr.next_frame()                       # nothing new: no record
    assert len(tr._frames) == 2
    for f, rec in enumerate(tr._frames):
        assert list(rec) == ["frame", "walk", "walk.trial_total"]
        assert rec["frame"] == f and rec["walk"] >= 2.0
        assert rec["walk.trial_total"] == 3.5
    s = tr.summary()
    assert s["walk"]["calls"] == 4 and s["join"]["calls"] == 2
    assert s["walk"]["total_ms"] == pytest.approx(
        sum(r["walk"] for r in tr._frames), abs=0.01)
    assert set(s["walk"]) == {"total_ms", "calls", "mean_ms"}


def test_ids_parents_and_threads(tr):
    """Parents are the innermost open span of the thread; a worker thread
    takes its parent and frame from a handed-over token, while the
    encoder thread closes the frame under it."""
    tr.enable()
    ready, go = threading.Event(), threading.Event()
    box = {}

    def worker(token):
        ready.set()
        go.wait(10)
        with tr.span("leaf", token) as rec:
            box["tid"] = threading.get_native_id()
            with tr.span("inner"):
                pass
            box["leaf"] = rec

    with tr.stage("outer"):
        with tr.span("filter"):
            token = tr.handoff()
            th = threading.Thread(target=worker, args=(token,))
            th.start()
            ready.wait(10)
    tr.next_frame()
    tr.next_frame()                       # the worker's spans: no frame
    with tr.stage("next"):
        go.set()
        th.join(10)
    tr.next_frame()
    by = {r["span"]: r for r in tr.records()}
    assert len({r["id"] for r in tr.records()}) == 5
    me = threading.get_native_id()
    assert by["outer"]["parent"] is None and by["outer"]["thread"] == me
    assert by["filter"]["parent"] == by["outer"]["id"]
    assert by["leaf"]["parent"] == by["filter"]["id"]
    assert by["leaf"]["frame"] == 0 and by["next"]["frame"] == 1
    assert by["leaf"]["thread"] == box["tid"] != me
    assert by["inner"]["parent"] == by["leaf"]["id"]
    assert by["inner"]["frame"] == 0 and by["inner"]["thread"] == box["tid"]
    assert [f["frame"] for f in tr._frames] == [0, 1]


def test_spans_from_many_threads_lose_nothing(tr):
    """More threads than cores, switching every microsecond, open nested
    spans under a handed-over token while the encoder thread closes
    frames: every span is kept once, with an id of its own, the token's
    frame, and a parent on its own thread."""
    tr.enable()
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 50
    errors = []
    with tr.stage("walk"):
        token = tr.handoff()

    def work():
        try:
            for _ in range(n_spans):
                with tr.span("outer", token) as outer:
                    with tr.span("inner") as inner:
                        assert inner["parent"] == outer["id"]
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in ths:
            th.start()
        for _ in range(20):
            with tr.stage("step"):
                pass
            tr.next_frame()
        for th in ths:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths) and errors == []
    recs = tr.records()
    assert len({r["id"] for r in recs}) == len(recs)
    outer = {r["id"]: r for r in recs if r["span"] == "outer"}
    inner = [r for r in recs if r["span"] == "inner"]
    assert len(outer) == len(inner) == n_threads * n_spans
    assert all(r["frame"] == 0 and r["parent"] == token[0]
               for r in outer.values())
    assert all(r["frame"] == 0 and
               outer[r["parent"]]["thread"] == r["thread"] for r in inner)
    assert [f["frame"] for f in tr._frames] == list(range(20))


def test_tile_spans_and_native_buckets(tr, monkeypatch):
    """A walk's tiles take the walk's token, record their thread's CPU
    time, and the native buckets' growth lands as frame counters."""
    names = native._PROF_NAMES
    reads = iter([{k: 0.0 for k in names},
                  {k: float(i) for i, k in enumerate(names)}])
    monkeypatch.setattr(native, "prof_get", lambda: next(reads))
    lib = types.SimpleNamespace(tpuc_prof_enabled=lambda: 1)
    monkeypatch.setattr(native, "get_lib", lambda: lib)
    tr.enable()
    with tr.stage("inter_commit_walk"):
        walk = tr.walk_begin()

        def tile(i):
            with tr.tile_span(walk, i):
                sum(range(20000))

        ths = [threading.Thread(target=tile, args=(i,)) for i in range(3)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        tr.walk_end(walk)
    tr.next_frame()
    recs = tr.records()
    w = next(r for r in recs if r["span"] == "inter_commit_walk")
    tiles = [r for r in recs if r["span"] == "walk_tile"]
    assert sorted(r["tile"] for r in tiles) == [0, 1, 2]
    assert all(r["parent"] == w["id"] and r["kind"] == "tile" and
               0 < r["cpu_ns"] and r["frame"] == 0 for r in tiles)
    rec = tr._frames[0]
    assert [rec["walk." + k] for k in names] == list(range(12))


def test_device_spans_resolve_by_query_only(tr, monkeypatch):
    """On the CPU a device span is nothing; on a CUDA device its end event
    is queried, never waited for, and the record gains device_ms."""
    tr.enable()
    assert tr.device_begin("gop_program", "cpu") is None
    tr.device_end(None)

    class Ev:
        done = False

        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self, stream=None):
            pass

        def query(self):
            return Ev.done

        def elapsed_time(self, end):
            return 12.5

        def synchronize(self):
            raise AssertionError("a device span never waits")

    monkeypatch.setattr(torch.cuda, "Event", Ev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    rec = tr.device_begin("gop_program", torch.device("cuda", 0))
    with tr.stage("after"):
        pass
    tr.device_end(rec)
    tr.next_frame()
    assert tr._pending and "gop_program" not in tr.summary()
    assert [r["span"] for r in tr.records()] == ["after"]
    Ev.done = True
    got = [r for r in tr.records() if r["span"] == "gop_program"]
    assert len(got) == 1 and got[0]["device_ms"] == 12.5
    assert got[0]["kind"] == "device" and got[0]["t0"] < got[0]["t1"]
    assert not any(k.startswith("_") for k in got[0])
    assert tr._pending == [] and tr.summary()["gop_program"]["calls"] == 1


# --- the encoder's sites ----------------------------------------------------

def test_wrapped_stage_survives_an_ra_encode(tr, monkeypatch):
    """A one-argument wrapper patched over stage (as a benchmark harness
    does to open a profiler range) sees every stage of a random-access
    encode with leaf frames, and _frames keeps its per-frame shape."""
    tr.enable()
    seen = []
    orig = tr.stage

    def wrapped(name):
        seen.append(name)
        return orig(name)

    monkeypatch.setattr(tr, "stage", wrapped)
    _encode_ra(_frames(176, 144, 17))
    assert {"gop_dispatch", "inter_commit_walk", "cdef", "dlf"} <= set(seen)
    assert len(tr._frames) == 17
    for f, rec in enumerate(tr._frames):
        assert rec["frame"] == f
        assert all(isinstance(v, float) for k, v in rec.items()
                   if k != "frame")
    names = {r["span"] for r in tr.records()}
    assert {"walk_tile", "filter_join", "leaf_filter", "cdef_search",
            "dlf_search"} <= names
    assert set(seen) <= names


@pytest.mark.parametrize("kind", ["ra_tf", "ld"])
def test_bytes_equal_with_tracing_on_and_off(tr, kind):
    encode, n = (_encode_ra, 9) if kind == "ra_tf" else (_encode_ld, 4)
    frames = _frames(176, 144, n, seed=11)
    off = encode(frames)
    tr.enable()
    on = encode(frames)
    assert on == off
    assert any(r["span"] == "walk_tile" for r in tr.records())


def test_trace_file_from_a_subprocess(tmp_path):
    """SVT_TRACE=<path> in a fresh process (the native buckets switch on
    before the library's first walk): the host facts first, per-frame
    lines with the walk.* counters, and span lines for every new site."""
    path = tmp_path / "trace.jsonl"
    code = (
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig\n"
        "from svt_av1_psy_tpu_torch.utils.test_clip import make_frame\n"
        "rng = np.random.default_rng(7)\n"
        "cfg = EncoderConfig(enc_mode=10, qp=30, hierarchical_levels=3,\n"
        "                    intra_period_length=-1)\n"
        "enc = Encoder(cfg, 176, 144, device='cpu')\n"
        "for t in range(17):\n"
        "    enc.send_picture(*make_frame(176, 144, t, 8, 0.02, rng))\n"
        "enc.flush()\n"
        "enc.close()\n")
    env = dict(os.environ, SVT_TRACE=str(path), PYTHONPATH=str(ROOT))
    env.pop("SVT_NATIVE_PROF", None)
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert set(lines[0]) == {"host"}
    assert lines[0]["host"]["tiles"][0] >= 1
    assert "summary" in lines[-1]
    frames = [ln for ln in lines if "frame" in ln and "span" not in ln]
    spans = [ln for ln in lines if "span" in ln]
    assert [f["frame"] for f in frames] == list(range(17))
    inter = [f for f in frames if "inter_commit_walk" in f]
    assert inter and all(
        "walk." + k in f for f in inter for k in native._PROF_NAMES)
    assert sum(f["walk.mc_singleref"] for f in inter) > 0
    names = {s["span"] for s in spans}
    assert {"walk_tile", "filter_join", "leaf_filter", "cdef_search",
            "dlf_search", "inter_commit_walk", "intra_commit_walk"} <= names
    ids = {s["id"]: s for s in spans}
    for s in spans:
        if s["span"] == "walk_tile":
            assert ids[s["parent"]]["span"] in ("inter_commit_walk",
                                                "intra_commit_walk")
            assert ids[s["parent"]]["frame"] == s["frame"]
        if s["span"] in ("cdef_search", "dlf_search") and \
                s["parent"] is not None:
            assert ids[s["parent"]]["span"] in ("cdef", "dlf")
    leaf = [s for s in spans if s["span"] == "leaf_filter"]
    enc_thread = next(s["thread"] for s in spans
                      if s["span"] == "inter_commit_walk")
    assert leaf and all(s["thread"] != enc_thread for s in leaf)


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_device_spans_resolve_without_a_sync(tr):
    """The gop_program and lr_program spans of an RA preset-6 encode on the
    card gain their device time; under sync debug mode "error" the GoP
    program (its inputs on the card) and the LR search's dispatch open,
    close and read back their device spans without a host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from svt_av1_psy_tpu_torch.models.lr_search import DeviceLrSearch
    from svt_av1_psy_tpu_torch.ops import torch_backend as tb
    dev = torch.device("cuda")
    tr.enable()
    cfg = EncoderConfig(enc_mode=6, qp=30, hierarchical_levels=3,
                        intra_period_length=-1, enable_tf=1, tf_strength=1)
    frames = _frames(352, 288, 17)
    enc = Encoder(cfg, 352, 288, device="cuda")
    try:
        for f in frames:
            enc.send_picture(*f)
        enc.flush()
    finally:
        enc.close()
    torch.cuda.synchronize()
    got = {r["span"]: r for r in tr.records() if r["kind"] == "device"}
    assert got["gop_program"]["device_ms"] > 0
    assert got["lr_program"]["device_ms"] > 0
    # the GoP program takes planes padded to whole superblocks
    planes = tb.plane_tensor(np.stack([
        np.pad(f[0], ((0, 32), (0, 32)), mode="edge") for f in frames[:3]]),
        dev)
    edges = torch.tensor([[1, 0], [2, 1]], dtype=torch.long, device=dev)
    w, h = 352, 288
    lr = DeviceLrSearch([(w, h)] + [(w // 2, h // 2)] * 2, 8, device=dev)
    torch.cuda.synchronize()
    tr.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = tr.device_begin("gop_program", dev)
        tb.gop_search(planes, edges, 700, 8, 8)
        tr.device_end(rec)
        lr.dispatch(frames[0], frames[1])
        deadline = time.time() + 30
        while len(tr.records()) < 2 and time.time() < deadline:
            time.sleep(0.001)
        got = tr.records()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sorted(r["span"] for r in got) == ["gop_program", "lr_program"]
    assert all(r["device_ms"] > 0 for r in got)
