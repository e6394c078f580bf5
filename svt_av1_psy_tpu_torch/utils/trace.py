"""Pipeline tracing / profiling (the reference's pipeline monitor +
--enable-stat-report timing analog; SURVEY.md §5 aux subsystem).

Per-stage wall-clock spans collected per frame with ~zero overhead when
disabled. Enable with SVT_TRACE=1 (summary to stderr at exit) or
SVT_TRACE=path.jsonl (one JSON line per frame + summary).

The port's copy of svt_av1_psy_tpu/utils/trace.py without its jax
profiler hook (maybe_start_device_trace, SVT_TRACE_JAX), which nothing
calls; device time on a GPU comes from torch.profiler where it is
measured.

Usage:
    from svt_av1_psy_tpu_torch.utils.trace import stage, next_frame
    with stage("device_search"):
        ...
    next_frame()        # closes the frame's record
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

_spec = os.environ.get("SVT_TRACE", "")
ENABLED = bool(_spec)
_path = _spec if _spec not in ("", "0", "1", "true") else None
_cur: dict = defaultdict(float)
_frames: list = []
_totals: dict = defaultdict(float)
_counts: dict = defaultdict(int)
_fh = None


@contextmanager
def stage(name: str):
    """Time one pipeline stage within the current frame."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _cur[name] += dt
        _totals[name] += dt
        _counts[name] += 1


def next_frame() -> None:
    """Close the current frame's span record."""
    global _fh
    if not ENABLED or not _cur:
        return
    rec = {"frame": len(_frames),
           **{k: round(v * 1e3, 3) for k, v in _cur.items()}}
    _frames.append(rec)
    if _path:
        if _fh is None:
            _fh = open(_path, "w")
        _fh.write(json.dumps(rec) + "\n")
        _fh.flush()
    _cur.clear()


def summary() -> dict:
    """Aggregate stage timings collected so far."""
    return {k: {"total_ms": round(_totals[k] * 1e3, 2),
                "calls": _counts[k],
                "mean_ms": round(_totals[k] * 1e3 / max(_counts[k], 1), 3)}
            for k in sorted(_totals)}


@atexit.register
def _dump():                                      # pragma: no cover
    if not ENABLED or not _totals:
        return
    print("SVT_TRACE summary (ms):", file=sys.stderr)
    for k, v in summary().items():
        print(f"  {k:<18} total {v['total_ms']:>10.2f}  "
              f"x{v['calls']:<5} mean {v['mean_ms']:.3f}",
              file=sys.stderr)
    if _fh:
        _fh.write(json.dumps({"summary": summary()}) + "\n")
        _fh.close()
