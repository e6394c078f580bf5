"""The benchmark's core: finds a cell's configuration, traffic, driver,
checks and metric readers by the names in BENCHMARK.json, runs the cell,
and assembles the result line. Nothing here names a cell, a configuration
or a metric: each of those is a file of its own (see README.md).

A run, in order: the caches are pinned inside the checkout, the
configuration's environment is set, the checks wrap the program's
functions whose results they judge, the cell's driver (drivers/) builds
the encoder and warms it up (set-up), the window opens (setup_s ends;
with --trace 1 the profiler starts), the driver feeds frames until
--seconds have passed, the window closes (the device is synchronised,
the memory peak read), the encoder is freed, the checks compare the
window's samples with the plain reference, and the metric readers read
the window.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import importlib.util
import inspect
import json
import os
import sys
import time
import zlib

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))

# top-level module names that no run may load: JAX and the JAX package
# (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "svt_av1_psy_tpu")

# names of the profiler ranges the harness opens (stage.* wraps the
# program's SVT_TRACE stages, bench.* the harness's own spans)
RANGE_PREFIXES = ("stage.", "bench.")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_module(kind: str, name: str, bench: str = BENCH):
    """benchmark/<kind>/<name>.py as a module (each loaded once)."""
    modname = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if modname in sys.modules:
        return sys.modules[modname]
    path = os.path.join(bench, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def reference():
    """The plain reference (benchmark/reference/programs.py)."""
    return load_module("reference", "programs")


class CellSpec:
    """One cell of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, manifest: dict, cell: dict, config: dict,
                 traffic: dict, bench: str = BENCH):
        self.manifest = manifest
        self.cell = cell
        self.name = cell["name"]
        self.chips = int(cell["chips"])
        self.config = config
        self.traffic = traffic
        self.bench = bench

    @classmethod
    def load(cls, root: str, workload: str, bench: str = BENCH):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            manifest = json.load(f)
        cells = {c["name"]: c for c in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload named {workload!r} in "
                           "BENCHMARK.json")
        cell = cells[workload]
        configs = {c["name"]: c for c in manifest["configs"]}
        with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
            config = json.load(f)
        with open(os.path.join(bench, "traffic",
                               cell["traffic"] + ".json")) as f:
            traffic = json.load(f)
        return cls(manifest, cell, config, traffic, bench)

    def metrics(self, trace: int) -> list:
        """The metric entries this cell reports in a run of this kind."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[key]
                if "workloads" not in m or self.name in m["workloads"]]


def pin_caches(root: str, spec: CellSpec) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    the configuration's environment set, and no library allowed to load
    JAX on its own."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k, v in spec.config.get("env", {}).items():
        os.environ[k] = str(v)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Ctx:
    """What a driver, a check and a metric reader share in one run."""

    def __init__(self, spec: CellSpec, seed: int, seconds: float,
                 trace: int, device: str, process_start: float):
        import torch
        self.spec = spec
        self.config = spec.config
        self.traffic = spec.traffic
        self.seed = seed
        self.seconds = float(seconds)
        self.trace = int(trace)
        self.device = torch.device(device)
        # the card's name (peaks.json's key); None off the card, where no
        # reader reports a device metric
        self.device_kind = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else None
        self.process_start = process_start
        self.torch = torch
        self.in_window = False
        self.window_done = False
        self.t_open = self.deadline = None
        self.wall_open = None
        self.frames = 0
        self.bytes = 0
        self.t_last = None
        self.spans: dict = {}
        self.samples: dict = {}
        # what a check keeps between install and readings, and the
        # numbers a check hands to the metric readers
        self.state: dict = {}
        self.values: dict = {}
        self._take_rngs: dict = {}
        self._patches: list = []
        self.records: list = []
        self.device_trace = None
        self.memory_peak = 0
        self._prof = None
        self._win_range = None
        self._trace_mod = None
        self._rec0 = 0

    # -- patching the program (restored at the end of the run) ------------
    def patch(self, obj, attr: str, new) -> None:
        self._patches.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    def restore(self) -> None:
        while self._patches:
            obj, attr, old = self._patches.pop()
            setattr(obj, attr, old)

    # -- harness spans around calls into the program -------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """Time one call into the program; kept when it starts inside the
        window, and a profiler range in a traced run."""
        if not self.in_window:
            yield
            return
        t0 = time.perf_counter()
        try:
            if self._prof is not None:
                with self.torch.profiler.record_function("bench." + name):
                    yield
            else:
                yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def wrap_span(self, module, attr: str) -> None:
        """Put a harness span, named attr, around every call of
        module.attr."""
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            with self.span(attr):
                return fn(*args, **kwargs)

        self.patch(module, attr, wrapped)

    # -- sampling of the window's results, from the seed -------------------
    def take(self, check: str, every: int) -> bool:
        """Whether to keep this call's inputs and results for the check:
        the window's first call, then each with probability 1/every,
        drawn from the seed."""
        if not self.in_window:
            return False
        rng = self._take_rngs.get(check)
        if rng is None:
            rng = self._take_rngs[check] = np.random.default_rng(
                [self.seed & 0xFFFFFFFFFFFF, zlib.crc32(check.encode())])
        first = not self.samples.get(check)
        return first or rng.random() < 1.0 / max(1, every)

    def keep(self, check: str, sample) -> None:
        self.samples.setdefault(check, []).append(sample)

    # -- the window -------------------------------------------------------
    def open_window(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        self.wall_open = time.time()
        if self._trace_mod is not None:
            self._rec0 = len(self._trace_mod._frames)
        if self.trace:
            prof = self.torch.profiler
            acts = [prof.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(prof.ProfilerActivity.CUDA)
            self._prof = prof.profile(activities=acts)
            self._prof.start()
            self._win_range = prof.record_function("bench.window")
            self._win_range.__enter__()
        self.t_open = time.perf_counter()
        self.deadline = self.t_open + self.seconds
        self.in_window = True

    def window_over(self) -> bool:
        return self.deadline is not None and \
            time.perf_counter() >= self.deadline

    def complete(self, frames: int, nbytes: int) -> None:
        """frames whole frames, nbytes of payload, came back now; counted
        when inside the window. The first completion after the deadline
        closes the window."""
        now = time.perf_counter()
        if not self.in_window:
            return
        if now <= self.deadline:
            self.frames += frames
            self.bytes += nbytes
            self.t_last = now
        else:
            self.close_window()

    def tick(self) -> None:
        """Close the window when its time is up (between completions)."""
        if self.in_window and self.window_over():
            self.close_window()

    def close_window(self) -> None:
        if not self.in_window:
            return
        self.in_window = False
        self.window_done = True
        t_end = time.perf_counter()
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
            self.memory_peak = int(self.torch.cuda.max_memory_allocated(
                self.device))
        if self._trace_mod is not None:
            self.records = list(self._trace_mod._frames[self._rec0:])
        if self._prof is not None:
            self._win_range.__exit__(None, None, None)
            self._prof.stop()
            self.device_trace = DeviceTrace.from_profiler(
                self._prof, t_end - self.t_open)
            self._prof = None

    def stage_mean_ms(self, stage: str):
        """The mean of one SVT_TRACE stage's ms over the window's
        per-frame records that hold it (None when none does)."""
        vals = [r[stage] for r in self.records if stage in r]
        if not vals:
            return None
        return sum(vals) / len(vals)

    @property
    def setup_s(self):
        if self.wall_open is None:
            return None
        return self.wall_open - self.process_start


class DeviceTrace:
    """What the traced window's profiler saw: device intervals (kernels,
    copies, sets) with the host time of their launch, and the host ranges
    the harness opened, all in the trace's own clock (ns)."""

    def __init__(self, device_ops, ranges, window, window_s):
        self.device_ops = device_ops      # [(name, start, dur, launch)]
        self.ranges = ranges              # {name: sorted [(start, end)]}
        self.window = window              # (start, end) of bench.window
        self.window_s = window_s

    @staticmethod
    def _ns(ev, what: str) -> int:
        f = getattr(ev, what + "_ns", None)
        if f is not None:
            return int(f())
        return int(getattr(ev, what + "_us")() * 1000)

    @classmethod
    def from_profiler(cls, prof, window_s: float):
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()

        def corr(ev):
            f = getattr(ev, "correlation_id", None)
            return f() if f is not None else None

        launch_at = {}
        dev = []
        ranges: dict = {}
        for ev in events:
            name = ev.name()
            start = cls._ns(ev, "start")
            dur = cls._ns(ev, "duration")
            if ev.device_type() == DeviceType.CPU:
                if name.startswith(RANGE_PREFIXES):
                    ranges.setdefault(name, []).append((start, start + dur))
                elif "Launch" in name or name.startswith("cudaMemcpy") or \
                        name.startswith("cudaMemset"):
                    launch_at[corr(ev)] = start
            elif not name.startswith(RANGE_PREFIXES):
                dev.append([name, start, dur, corr(ev)])
        for d in dev:
            d[3] = launch_at.get(d[3])
        for v in ranges.values():
            v.sort()
        win = ranges.get("bench.window", [(None, None)])[0]
        return cls([tuple(d) for d in dev], ranges, win, window_s)

    def busy_ns(self) -> int:
        """The union of the device intervals inside the window."""
        lo, hi = self.window
        total = 0
        end = None
        for _, s, d, _ in sorted(self.device_ops, key=lambda o: o[1]):
            s, e = max(s, lo), min(s + d, hi)
            if e <= s:
                continue
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def gaps(self) -> list:
        """The idle intervals of the device inside the window."""
        lo, hi = self.window
        out = []
        cur = lo
        for _, s, d, _ in sorted(self.device_ops, key=lambda o: o[1]):
            if s > cur:
                out.append((cur, min(s, hi)))
            cur = max(cur, s + d)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
        return [(a, b) for a, b in out if b > a]

    def host_range_at(self, t: int) -> str:
        """The innermost harness range that holds host time t."""
        best, width = "host outside any span", None
        for name, spans in self.ranges.items():
            if name == "bench.window":
                continue
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            # ranges of one name do not nest: the one starting last
            # before t is the only candidate
            if i >= 0 and spans[i][0] <= t < spans[i][1]:
                w = spans[i][1] - spans[i][0]
                if width is None or w < width:
                    best, width = name, w
        return best

    def launched_in(self, name: str) -> list:
        """Device ops whose launch lies inside a range called name."""
        spans = self.ranges.get(name, [])
        out = []
        for op in self.device_ops:
            t = op[3]
            if t is None:
                continue
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t < spans[i][1]:
                out.append(op)
        return out

    def breakdown(self) -> dict:
        by_name: dict = {}
        for name, _, d, _ in self.device_ops:
            by_name[name] = by_name.get(name, 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        by_host: dict = {}
        for a, b in self.gaps():
            k = self.host_range_at((a + b) // 2)
            by_host[k] = by_host.get(k, 0) + (b - a)
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in gaps]}


def bind(fn, args, kwargs) -> dict:
    """The arguments of one call of fn by parameter name, defaults filled."""
    ba = inspect.signature(fn).bind(*args, **kwargs)
    ba.apply_defaults()
    return dict(ba.arguments)


def run_cell(spec: CellSpec, *, seed: int, seconds: float, trace: int,
             device: str, process_start: float, control: bool = False):
    """Run one cell and return its result (a dict; see emit). control:
    also read each check's control (checks/, PERF.md), which the
    benchmark's own runs never do, and judge it by the same rule
    (control_correct)."""
    if trace:
        os.environ["SVT_TRACE"] = "1"
    else:
        os.environ.pop("SVT_TRACE", None)
    ctx = Ctx(spec, seed, seconds, trace, device, process_start)
    import svt_av1_psy_tpu_torch.utils.trace as trace_mod
    if trace and trace_mod.ENABLED:
        ctx._trace_mod = trace_mod
        _wrap_stages(ctx, trace_mod)
    checks = {name: load_module("checks", name, spec.bench)
              for name in spec.config.get("checks", {})}
    try:
        for name, mod in checks.items():
            mod.install(ctx, spec.config["checks"][name])
        source = load_module("sources", spec.traffic["generator"],
                             spec.bench).Source(
            spec.traffic.get("params", {}), spec.config, seed, ctx.device)
        ctx.source = source
        driver = load_module("drivers", spec.config["driver"], spec.bench)
        driver.drive(ctx)
        ctx.close_window()
    finally:
        ctx.restore()
    gc.collect()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()
    if ctx._trace_mod is not None:
        import atexit
        atexit.unregister(trace_mod._dump)
    compared = {}
    t_check = time.perf_counter()
    for name, mod in checks.items():
        got = mod.readings(ctx, spec.config["checks"][name], control=False)
        limits = spec.config["checks"][name]["limits"]
        for k, v in got.items():
            compared[k] = {"value": v, "limit": limits[k]}
        if control:
            for k, v in mod.readings(ctx, spec.config["checks"][name],
                                     control=True).items():
                compared["control." + k] = {"value": v, "limit": limits[k]}
    print(f"benchmark: {ctx.frames} frames in the window, checks took "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = _verdict({k: c for k, c in compared.items()
                        if not k.startswith("control.")})
    metrics = {}
    for m in spec.metrics(trace):
        v = load_module("metrics", m["name"], spec.bench).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": ctx.frames,
        "failed": 0,
        "metrics": metrics,
        "device": _device_info(ctx),
    }
    if ctx.device_trace is not None:
        result["device"]["busy_s"] = ctx.device_trace.busy_ns() / 1e9
        result["device"]["window_s"] = ctx.device_trace.window_s
        result["breakdown"] = ctx.device_trace.breakdown()
    if control:
        # the same rule on the control's numbers: it has to come out false
        result["control_correct"] = _verdict(
            {k: c for k, c in compared.items() if k.startswith("control.")})
    result["compared"] = compared
    return result


def _verdict(compared: dict) -> bool:
    """Correct when there is a number and each is within its limit."""
    return bool(compared) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values())


def _wrap_stages(ctx: Ctx, trace_mod) -> None:
    """Each SVT_TRACE stage of the program also opens a profiler range
    (stage.<name>), so the trace can say what the host did in the
    device's idle gaps and which stage launched which kernels."""
    orig = trace_mod.stage
    record_function = ctx.torch.profiler.record_function

    @contextlib.contextmanager
    def stage(name: str):
        with record_function("stage." + name), orig(name):
            yield

    ctx.patch(trace_mod, "stage", stage)


def _device_info(ctx: Ctx) -> dict:
    torch = ctx.torch
    if ctx.device_kind is not None:
        return {"platform": "gpu",
                "kind": ctx.device_kind,
                "count": 1,
                "memory_peak_bytes": ctx.memory_peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def emit(result: dict) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output."""
    for k, c in result["compared"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
