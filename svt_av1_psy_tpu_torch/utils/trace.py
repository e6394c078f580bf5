"""Pipeline tracing: span records on one program clock, per-frame sums
derived from them, and CUDA-event spans for the device programs.

Off by default, and then each instrumented site costs a test of the
module's ENABLED flag (and a call that returns at once): no records, no
events, no CPU-clock reads, no native profiler reads. On at import with
SVT_TRACE=1 (summary to stderr at exit) or SVT_TRACE=path.jsonl, or at
run time with enable() / disable() / reset().

Every span is one record in one store: name, id, parent id, thread id
(the native one), frame number, and start and end in
time.perf_counter_ns(), which on Linux is CLOCK_MONOTONIC, the clock of
the native phase profiler (native/commit_backend.c prof_now) too.

- stage(name) times a pipeline stage on the encoder thread. Its parent is
  the innermost span open on the thread and its frame the open frame.
  Keep its one argument and import it at call time (``from ...trace
  import stage as _tstage`` inside the function): a benchmark may patch
  the module's ``stage`` with a one-argument wrapper that also opens a
  profiler range.
- span(name, token) is a span no wrapper sees: on the encoder thread
  (token None) or on a worker thread, which takes its parent and frame
  from a token that the encoder thread handed over (handoff()), never
  from the open frame, which next_frame() moves meanwhile.
- walk_begin() / tile_span(walk, i) / walk_end(walk) trace one tile-
  parallel commit walk: a span per tile with the CPU time its thread
  spent (time.thread_time_ns), and the native phase buckets' growth over
  the walk as frame counters ``walk.<bucket>`` (native.py _PROF_NAMES,
  milliseconds summed over the tile threads).
- count(name, value) adds a number into the open frame's record.
- device_begin(name, device) / device_end(handle) put CUDA events on the
  current stream around a device program (only on a CUDA device). They
  are resolved with Event.query() at next_frame() and when records()
  reads, never by a sync; the record keeps the host start of its begin
  and gains ``device_ms``.

next_frame() closes the open frame: its record in ``_frames`` holds the
frame number, each stage's milliseconds summed over the frame and the
frame's counters. records(t0, t1) returns the span records that start
inside [t0, t1] ns; summary() sums every span by name. With
SVT_TRACE=path.jsonl the file's first line holds the host facts recorded
when tracing starts (cores, the affinity mask's size, torch's threads,
the encoder's tile grid), then per frame one line as before and one line
per span closed since, each marked by a "span" key; a summary line ends
it.

The native buckets count only when the C library reads SVT_NATIVE_PROF
as on, which it does once, at its first walk. Starting tracing sets it to
1 where it is unset; enable() after the library's first walk cannot
switch the buckets on, and their counters then stay absent (as where
SVT_NATIVE_PROF=0 is set).

Usage:
    from svt_av1_psy_tpu_torch.utils.trace import stage, next_frame
    with stage("device_search"):
        ...
    next_frame()        # closes the frame's record
"""
from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import sys
import threading
import time

_spec = os.environ.get("SVT_TRACE", "")
ENABLED = bool(_spec)
_path = _spec if _spec not in ("", "0", "1", "true") else None
_store: list = []           # span and counter records, in closing order
_frames: list = []          # per-frame records derived by next_frame()
_pending: list = []         # device spans whose end event has not run
_host: dict = {}
_ids = itertools.count(1)
_tls = threading.local()
_lock = threading.Lock()
_scan = 0                   # _store[:_scan] is folded into _frames
_written = 0                # _store[:_written] is in the JSONL file
_fh = None
_NULL = contextlib.nullcontext()


def _start() -> None:
    """What starting tracing does once: record the host facts, and ask
    the native library for its phase buckets."""
    os.environ.setdefault("SVT_NATIVE_PROF", "1")
    if "cpu_count" in _host:
        return
    import torch
    _host["cpu_count"] = os.cpu_count()
    _host["affinity"] = len(os.sched_getaffinity(0)) \
        if hasattr(os, "sched_getaffinity") else None
    _host["torch_threads"] = torch.get_num_threads()


def enable() -> None:
    """Start tracing."""
    global ENABLED
    _start()
    ENABLED = True


def disable() -> None:
    """Stop tracing; the records so far stay readable."""
    global ENABLED
    ENABLED = False


def reset() -> None:
    """Drop every record; frame numbers start again at 0."""
    global _scan, _written
    with _lock:
        _store.clear()
        _frames.clear()
        _pending.clear()
        _scan = _written = 0
    _stack().clear()


def set_tile_grid(cols: int, rows: int) -> None:
    """The encoder's tile grid, kept with the host facts."""
    _host["tiles"] = [int(cols), int(rows)]


def host() -> dict:
    """The host facts recorded when tracing started."""
    return dict(_host)


# --- spans -----------------------------------------------------------------

def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _open(name: str, kind: str, token=None, push: bool = True) -> dict:
    st = _stack()
    if token is not None:
        parent, frame = token
    elif st:
        parent, frame = st[-1]["id"], st[-1]["frame"]
    else:
        parent, frame = None, len(_frames)
    rec = {"span": name, "kind": kind, "id": next(_ids), "parent": parent,
           "thread": threading.get_native_id(), "frame": frame,
           "t0": time.perf_counter_ns()}
    if push:
        st.append(rec)
    return rec


def _close(rec: dict) -> None:
    rec["t1"] = time.perf_counter_ns()
    st = _stack()
    for i in range(len(st) - 1, -1, -1):
        if st[i] is rec:
            del st[i:]
            break
    _store.append(rec)


@contextlib.contextmanager
def stage(name: str):
    """Time one pipeline stage within the current frame."""
    if not ENABLED:
        yield
        return
    rec = _open(name, "stage")
    try:
        yield
    finally:
        _close(rec)


@contextlib.contextmanager
def _span(name: str, kind: str, token):
    rec = _open(name, kind, token)
    try:
        yield rec
    finally:
        _close(rec)


def span(name: str, token=None):
    """A span that no stage wrapper sees; on a worker thread, token is
    what handoff() gave the thread that started the work."""
    if not ENABLED:
        return _NULL
    return _span(name, "span", token)


def handoff():
    """A token for work this thread hands to another: the innermost open
    span's id and the frame, read here and now (None when off)."""
    if not ENABLED:
        return None
    st = _stack()
    if st:
        return st[-1]["id"], st[-1]["frame"]
    return None, len(_frames)


# --- tile walks and the native phase buckets --------------------------------

def walk_begin():
    """Open the tracing of a tile-parallel walk (inside its stage): the
    token its tiles take, and the native buckets as they stand (None when
    the library does not count them). None when off."""
    if not ENABLED:
        return None
    from svt_av1_psy_tpu_torch import native
    prof = native.prof_get() if native.get_lib().tpuc_prof_enabled() \
        else None
    return {"token": handoff(), "prof": prof}


@contextlib.contextmanager
def _tile(walk, index: int):
    rec = _open("walk_tile", "tile", walk["token"])
    rec["tile"] = int(index)
    c0 = time.thread_time_ns()
    try:
        yield rec
    finally:
        rec["cpu_ns"] = time.thread_time_ns() - c0
        _close(rec)


def tile_span(walk, index: int):
    """The span of one tile of the walk, on the thread that runs it."""
    if walk is None:
        return _NULL
    return _tile(walk, index)


def walk_end(walk) -> None:
    """Close the walk: the buckets' growth over it as frame counters."""
    if walk is None or walk["prof"] is None:
        return
    from svt_av1_psy_tpu_torch import native
    now = native.prof_get()
    for k, v in now.items():
        count("walk." + k, v - walk["prof"][k])


def count(name: str, value: float) -> None:
    """Add value into the open frame's record under name."""
    if not ENABLED:
        return
    st = _stack()
    _store.append({"counter": name, "value": value,
                   "frame": st[-1]["frame"] if st else len(_frames),
                   "thread": threading.get_native_id(),
                   "t": time.perf_counter_ns()})


# --- device programs --------------------------------------------------------

def device_begin(name: str, device):
    """A CUDA event on the current stream of device before a program's
    first launch (None when off or not on a CUDA device)."""
    if not ENABLED:
        return None
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    rec = _open(name, "device", push=False)     # never a parent
    rec["_dev"] = dev
    rec["_ev0"] = torch.cuda.Event(enable_timing=True)
    rec["_ev0"].record(torch.cuda.current_stream(dev))
    return rec


def device_end(rec) -> None:
    """A CUDA event after the program's last launch; the span resolves
    once the device has passed it."""
    if rec is None:
        return
    import torch
    rec["_ev1"] = torch.cuda.Event(enable_timing=True)
    rec["_ev1"].record(torch.cuda.current_stream(rec["_dev"]))
    rec["t1"] = time.perf_counter_ns()
    with _lock:
        _pending.append(rec)


def _resolve() -> None:
    """Move the device spans whose end event has run into the store."""
    if not _pending:
        return
    with _lock:
        left = []
        for rec in _pending:
            if rec["_ev1"].query():
                rec["device_ms"] = rec["_ev0"].elapsed_time(rec["_ev1"])
                for k in ("_dev", "_ev0", "_ev1"):
                    del rec[k]
                _store.append(rec)
            else:
                left.append(rec)
        _pending[:] = left


def records(t0: int | None = None, t1: int | None = None) -> list:
    """The span records (device spans resolved so far included) that
    start inside [t0, t1], in perf_counter_ns; None leaves a side open."""
    _resolve()
    return [r for r in list(_store) if "span" in r and
            (t0 is None or r["t0"] >= t0) and (t1 is None or r["t0"] <= t1)]


def _ms(rec: dict) -> float:
    if rec["kind"] == "device":
        return rec["device_ms"]
    return (rec["t1"] - rec["t0"]) / 1e6


# --- frames, the summary and the file ---------------------------------------

def next_frame() -> None:
    """Close the current frame's record: its stages' milliseconds and its
    counters."""
    global _fh, _scan, _written
    if not ENABLED:
        return
    _resolve()
    f = len(_frames)
    new = _store[_scan:]
    _scan += len(new)
    rec = {"frame": f}
    sums: dict = {}
    for r in new:
        if r["frame"] != f:
            continue
        if "counter" in r:
            sums[r["counter"]] = sums.get(r["counter"], 0) + r["value"]
        elif r["kind"] == "stage":
            sums[r["span"]] = sums.get(r["span"], 0) + _ms(r)
    if not sums:
        return
    rec.update({k: round(v, 3) for k, v in sums.items()})
    _frames.append(rec)
    if _path:
        if _fh is None:
            _fh = open(_path, "w")
            _fh.write(json.dumps({"host": host()}) + "\n")
        _fh.write(json.dumps(rec) + "\n")
        _written = _write_spans(_written)
        _fh.flush()


def _write_spans(start: int) -> int:
    done = _store[start:]
    for r in done:
        if "span" in r:
            _fh.write(json.dumps(r) + "\n")
    return start + len(done)


def summary() -> dict:
    """Every span's milliseconds summed by name (device spans: device
    time)."""
    _resolve()
    tot: dict = {}
    calls: dict = {}
    for r in list(_store):
        if "span" in r:
            tot[r["span"]] = tot.get(r["span"], 0.0) + _ms(r)
            calls[r["span"]] = calls.get(r["span"], 0) + 1
    return {k: {"total_ms": round(tot[k], 2), "calls": calls[k],
                "mean_ms": round(tot[k] / calls[k], 3)}
            for k in sorted(tot)}


@atexit.register
def _dump():                                      # pragma: no cover
    if not ENABLED or not _store:
        return
    s = summary()
    print("SVT_TRACE summary (ms):", file=sys.stderr)
    for k, v in s.items():
        print(f"  {k:<18} total {v['total_ms']:>10.2f}  "
              f"x{v['calls']:<5} mean {v['mean_ms']:.3f}",
              file=sys.stderr)
    if _fh:
        _write_spans(_written)
        _fh.write(json.dumps({"summary": s}) + "\n")
        _fh.close()


if ENABLED:
    _start()
