"""All-intra through the command, as the benchmark's ai_p12_1080p cell runs
it (--keyint 1 --preset 12 --crf 35, TF and TPL off), at 192x128 on the
CPU with the decide prefetch on (SVT_PREFETCH_CPU=1): each frame's decide
against the benchmark's plain reference, the prefetch taken by every frame
after the first, the trace's new counter and span, and the stream decoded
by libaom against the command's recon. Then the library's send_picture in
all-intra, whose packets leave the deferred in-loop filter running.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch import native
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig
from svt_av1_psy_tpu_torch.models import intra_encoder

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
W, H, N = 192, 128, 6
ARGV = ["--keyint", "1", "--preset", "12", "--crf", "35", "--enable-tf", "0",
        "--enable-tpl", "0", "--device", "cpu", "--progress", "0"]

# runs in a fresh process, so that the native phase buckets are on from
# the library's first walk: the command on argv[1] -> argv[2], every
# decide launch's plane and result and every frame's recon into argv[3]
_RUN = """
import sys
import numpy as np, torch
torch.set_num_threads(2)
import svt_av1_psy_tpu_torch.api as api
import svt_av1_psy_tpu_torch.models.fast_intra as fi
from svt_av1_psy_tpu_torch.app import cli
calls, frames = [], []
launch = fi.intra_decide_packed

def recorded(plane, split_bias, bd=8, min_block=8):
    out = launch(plane, split_bias, bd, min_block)
    calls.append((plane.cpu().numpy(), split_bias, bd, min_block,
                  out.cpu().numpy()))
    return out

fi.intra_decide_packed = recorded
encode = api.Encoder.encode

def kept(self, *a, **k):
    f = encode(self, *a, **k)
    frames.append(f)
    return f

api.Encoder.encode = kept
rc = cli.main(ARGV + ["-i", sys.argv[1], "-b", sys.argv[2]])
assert rc == 0, rc
out = {"n_calls": len(calls), "n_frames": len(frames)}
for i, (plane, bias, bd, mb, got) in enumerate(calls):
    out[f"plane{i}"] = plane
    out[f"args{i}"] = np.array([bias, bd, mb])
    out[f"decide{i}"] = got
for i, f in enumerate(frames):
    out[f"recon{i}"] = np.concatenate([f.recon_y.ravel(), f.recon_u.ravel(),
                                       f.recon_v.ravel()])
np.savez(sys.argv[3], **out)
"""


def _load(kind, name):
    spec = importlib.util.spec_from_file_location(
        f"allintra_{kind}_{name}", BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _planes(seed=2 ** 31 + 13):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (H, W), np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), np.uint8))
            for _ in range(N)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One run of the command at the cell's flags: its trace file, its
    IVF, and what the recorder kept."""
    d = tmp_path_factory.mktemp("allintra")
    src = d / "in.y4m"
    with open(src, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C420jpeg\n".encode())
        for y, u, v in _planes():
            f.write(b"FRAME\n" + y.tobytes() + u.tobytes() + v.tobytes())
    env = dict(os.environ, SVT_TRACE=str(d / "trace.jsonl"),
               SVT_PREFETCH_CPU="1", PYTHONPATH=str(ROOT))
    for k in ("SVT_NATIVE_PROF", "SVT_HME_PALLAS", "SVT_TILE_SEQ"):
        env.pop(k, None)
    code = f"ARGV = {ARGV!r}\n" + _RUN
    p = subprocess.run([sys.executable, "-c", code, str(src),
                        str(d / "out.ivf"), str(d / "kept.npz")], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(ln)
             for ln in (d / "trace.jsonl").read_text().splitlines()]
    return {"frames": [ln for ln in lines
                       if "frame" in ln and "span" not in ln
                       and "host" not in ln],
            "spans": [ln for ln in lines if "span" in ln],
            "ivf": (d / "out.ivf").read_bytes(),
            "kept": dict(np.load(d / "kept.npz"))}


def test_each_decide_equals_the_plain_reference(run):
    P = _load("reference", "programs")
    kept = run["kept"]
    # one decide per frame: a taken prefetch is never launched again
    assert int(kept["n_calls"]) == int(kept["n_frames"]) == N
    for i in range(N):
        bias, bd, mb = (int(a) for a in kept[f"args{i}"])
        plane = torch.from_numpy(kept[f"plane{i}"]).to(torch.int32)
        want = P.intra_decide_packed(plane, bias, bd, mb).numpy()
        np.testing.assert_array_equal(kept[f"decide{i}"], want)


def test_every_frame_after_the_first_takes_its_prefetch(run):
    frames = run["frames"]
    assert [f["frame"] for f in frames] == list(range(N))
    assert all("intra_commit_walk" in f for f in frames)
    assert [f["decide.prefetched"] for f in frames] == [0] + [1] * (N - 1)


def test_trace_has_the_key_join_and_the_walk_counters(run):
    frames, spans = run["frames"], run["spans"]
    for f in frames:
        assert all("walk." + k in f for k in native._PROF_NAMES), f
    assert sum(f["walk.trial_total"] for f in frames) > 0
    assert sum(f["walk.commit_ec"] for f in frames) > 0
    joins = [s for s in spans if s["span"] == "filter_join"]
    assert sorted(s["frame"] for s in joins) == list(range(N))
    assert {"walk_tile", "intra_commit_walk", "leaf_filter"} <= \
        {s["span"] for s in spans}
    # a device span exists only on a CUDA device
    assert not any(s["span"] == "decide_program" for s in spans)


def test_stream_decodes_to_the_recon(run):
    aom = _load("reference", "aom")
    if aom.find_library() is None:
        pytest.skip("libaom does not load on this machine")
    from svt_av1_psy_tpu_torch.bitstream.ivf import read_ivf
    _, units = read_ivf(run["ivf"])
    decoded = list(aom.decode([payload for _, payload in units]))
    assert len(decoded) == N
    for i, (y, u, v) in enumerate(decoded):
        got = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
        np.testing.assert_array_equal(got, run["kept"][f"recon{i}"])


def test_send_picture_leaves_the_deferred_filter_running(monkeypatch):
    """All-intra packets from send_picture hold a lazy recon: no deferred
    filter is resolved while the frames go in, and the recon, once read,
    is what encode() gives for the same frames."""
    monkeypatch.setenv("SVT_PREFETCH_CPU", "1")
    cfg = EncoderConfig(enc_mode=12, qp=35, intra_period_length=0)
    frames = _planes(seed=2 ** 31 + 29)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    fin = intra_encoder.EncodedFrame._fin
    resolved = [0]

    def counted(self):
        resolved[0] += 1
        return fin(self)

    try:
        want_enc = Encoder(cfg, W, H, device="cpu")
        try:
            want = [want_enc.encode(*f) for f in frames]
            want = [(o.payload, o.recon_y, o.recon_u, o.recon_v)
                    for o in want]
        finally:
            want_enc.close()
        enc = Encoder(cfg, W, H, device="cpu")
        try:
            monkeypatch.setattr(intra_encoder.EncodedFrame, "_fin", counted)
            pkts = [p for f in frames for p in enc.send_picture(*f)]
            assert resolved[0] == 0
            # the deferral ran: some packets still hold their filter
            assert any(p.recon._f._resolve is not None for p in pkts)
        finally:
            enc.close()
    finally:
        torch.set_num_threads(threads)
    assert [p.display_idx for p in pkts] == list(range(N))
    for p, (payload, *planes) in zip(pkts, want):
        assert p.payload == payload
        assert len(p.recon) == 3
        for got, w in zip(p.recon, planes):
            np.testing.assert_array_equal(got, w)
