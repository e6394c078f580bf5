"""Whole runs of small cells on the CPU (run_cell without the look for a
card): a cell, a configuration, a traffic mix and a metric added as new
files are found with no edit of the harness; the control reads above
every limit it is meant to break, and the run's own rule judges it not
correct; and a run whose timed path is broken underneath comes out not
correct, once for each fault the cell can have.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import harness

BENCH = os.path.dirname(harness.__file__)
ROOT = os.path.dirname(BENCH)

NEW_METRIC = '''"""frames_counted (frames): the frames the window counted."""


def read(ctx):
    return float(ctx.frames) if ctx.frames else None
'''


def _tiny_checkout(tmp_path, kind: str):
    """A copy of the benchmark plus one new configuration, traffic mix,
    metric and cell, each a new file (BENCHMARK.json gains their
    entries)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    base = {"ra": "vod_ra_p6_1080p", "ld": "live_ld_p10_1080p"}[kind]
    cfg = json.loads((root / "benchmark" / "configs" /
                      f"{base}.json").read_text())
    cfg.update(name=f"tiny_{kind}", width=192, height=128)
    if kind == "ra":
        cfg["encoder"]["hierarchical_levels"] = 2
    else:
        cfg["argv"] = ["cpu" if a == "cuda" else a for a in cfg["argv"]]
    for c in cfg["checks"].values():
        c["every"] = 1
    (root / "benchmark" / "configs" / f"tiny_{kind}.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((root / "benchmark" / "traffic" /
                          "clip_noise.json").read_text())
    traffic["params"]["noise"] = 0.03
    (root / "benchmark" / "traffic" / "tiny_noise.json").write_text(
        json.dumps(traffic))
    (root / "benchmark" / "metrics" / "frames_counted.py").write_text(
        NEW_METRIC)
    cell = f"tiny_{kind}.tiny_noise"
    m["configs"].append({"name": f"tiny_{kind}", "source": "test",
                         "file": f"benchmark/configs/tiny_{kind}.json",
                         "reduced": ["width", "height"], "why": "test"})
    m["workloads"].append({"name": cell, "config": f"tiny_{kind}",
                           "traffic": "tiny_noise", "chips": 1,
                           "why": "test"})
    m["end_to_end"].append({"name": "frames_counted", "unit": "frames",
                            "better": "higher", "bound": 0.5,
                            "source": "host_clock", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root, cell


def _run(root, cell, control=False, seconds=8.0):
    spec = harness.CellSpec.load(str(root), cell,
                                 bench=str(root / "benchmark"))
    harness.pin_caches(str(root), spec)
    # test workers share the CPU: torch's own thread pool, sized for the
    # whole machine in each of them, would stall every tiny encode
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run_cell(spec, seed=2 ** 31 + 101, seconds=seconds,
                                trace=0, device="cpu",
                                process_start=time.time(), control=control)
    finally:
        torch.set_num_threads(threads)
        os.environ.pop("SVT_HME_PALLAS", None)


@pytest.mark.parametrize("kind", ["ra", "ld"])
def test_new_files_make_a_cell_and_the_control_fails(tmp_path, kind):
    root, cell = _tiny_checkout(tmp_path, kind)
    r = _run(root, cell, control=True)
    assert r["correct"], r["compared"]
    assert r["control_correct"] is False, r["compared"]
    assert r["metrics"]["frames_counted"]["value"] > 0
    assert set(r["metrics"]) == {"encode_fps", "kbytes_per_frame",
                                 "psnr_y_db", "setup_s", "frames_counted"}
    assert 20 < r["metrics"]["psnr_y_db"]["value"] < 60
    over = [k for k, c in r["compared"].items()
            if k.startswith("control.") and c["value"] > c["limit"]]
    # the control breaks every check of the cell
    checks = {"ra": ("control.gop_search_mismatch",
                     "control.gop_decide_mismatch",
                     "control.tf_max_abs", "control.lr_tap_max_abs",
                     "control.stream_recon_mismatch"),
              "ld": ("control.k1_mismatch", "control.decide_mismatch",
                     "control.tpl_mismatch",
                     "control.stream_recon_mismatch")}[kind]
    assert set(checks) <= set(over), r["compared"]


def _fault(kind, name):
    """A patch that breaks the timed path: (owner, attribute, the broken
    function)."""
    import svt_av1_psy_tpu_torch.models.fast_intra as fi
    import svt_av1_psy_tpu_torch.models.lr_search as lr
    import svt_av1_psy_tpu_torch.native as native
    import svt_av1_psy_tpu_torch.models.ra as ra
    import svt_av1_psy_tpu_torch.models.tpl as tpl

    def gop_mv_altered(orig):
        def f(*a, **k):
            out = orig(*a, **k).clone()
            out[0] ^= 4                  # the first edge's first MV
            return out
        return f

    def gop_half_the_edges(orig):
        def f(frames, edges, *a, **k):
            e = np.array(edges)
            e[len(e) // 2:] = e[0]       # half the edges not searched
            return orig(frames, e, *a, **k)
        return f

    def tf_plane_altered(orig):
        def f(*a, **k):
            out = orig(*a, **k).clone()
            out[-1] = (int(out[-1]) + 3) % 256   # a filtered pixel
            return out
        return f

    def lr_tap_altered(orig):
        def build(self):
            prog = orig(self)

            def g(*planes):
                out = prog(*planes).clone()
                out[0] += 2                      # the first Wiener tap
                return out
            return g
        return build

    def k1_mv_altered(orig):
        def f(src, ref, search_range=12):
            mv, sad = orig(src, ref, search_range)
            mv = mv.clone()
            mv[0, 0, 0] += 2
            return mv, sad
        return f

    def decide_altered(orig):
        def f(*a, **k):
            out = orig(*a, **k).clone()
            out[-1] ^= 1
            return out
        return f

    def tpl_altered(orig):
        def f(*a, **k):
            out = orig(*a, **k)
            if out is not None:
                out = out.copy()
                out[0, 0] += 1
            return out
        return f

    def token_altered(orig):
        calls = [0]

        def done(self):
            out = orig(self)
            calls[0] += 1
            if calls[0] > 8 and len(out) > 2:    # past the warm-up
                b = bytearray(out)
                b[len(b) // 2] ^= 0x08           # a coded bit flipped
                out = bytes(b)
            return out
        return done

    def walk_recon_altered(orig):
        def encode_inter(self, *a, **k):
            out = orig(self, *a, **k)
            self._shared[0][:4, :4] ^= 8         # the walk's recon
            return out
        return encode_inter

    table = {"gop_mv_altered": (ra, "gop_search_tf", gop_mv_altered),
             "gop_half_the_edges": (ra, "gop_search_tf",
                                    gop_half_the_edges),
             "tf_plane_altered": (ra, "gop_search_tf", tf_plane_altered),
             "lr_tap_altered": (lr.DeviceLrSearch, "_build",
                                lr_tap_altered),
             "k1_mv_altered": (fi, "hme_search_kernel", k1_mv_altered),
             "decide_altered": (fi, "intra_decide_packed", decide_altered),
             "tpl_altered": (tpl, "tpl_sb_offsets", tpl_altered),
             "token_altered": (native.NativeRangeEncoder, "done",
                               token_altered),
             "walk_recon_altered": (native.CommitEngine, "encode_inter",
                                    walk_recon_altered)}
    obj, attr, make = table[name]
    return obj, attr, make(getattr(obj, attr))


@pytest.mark.parametrize("kind,fault,number", [
    ("ra", "gop_mv_altered", "gop_search_mismatch"),
    ("ra", "gop_half_the_edges", "gop_search_mismatch"),
    ("ra", "tf_plane_altered", "tf_max_abs"),
    ("ra", "lr_tap_altered", "lr_tap_max_abs"),
    ("ld", "k1_mv_altered", "k1_mismatch"),
    ("ld", "decide_altered", "decide_mismatch"),
    ("ld", "tpl_altered", "tpl_mismatch"),
    ("ra", "token_altered", "stream_recon_mismatch"),
    ("ra", "walk_recon_altered", "stream_recon_mismatch"),
    ("ld", "token_altered", "stream_recon_mismatch"),
    ("ld", "walk_recon_altered", "stream_recon_mismatch")])
def test_a_broken_timed_path_is_not_correct(tmp_path, kind, fault, number):
    root, cell = _tiny_checkout(tmp_path, kind)
    obj, attr, broken = _fault(kind, fault)
    old = getattr(obj, attr)
    setattr(obj, attr, broken)
    try:
        r = _run(root, cell)
    finally:
        setattr(obj, attr, old)
    assert not r["correct"], r["compared"]
    # failed by the number that judges the broken layer, not for want of
    # a sample
    c = r["compared"][number]
    assert c["value"] is not None and c["value"] > c["limit"], r["compared"]
