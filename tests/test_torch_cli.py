"""The port's CLI and the device users that only it reaches, against the
JAX package on the same inputs.

- hme_mv_sad, the CLI's host temporal filter, tpl_sb_offsets and the
  edge search of tpl_gop_q give the reference's results exactly, on
  shifted-plus-noise, scrolling and flat content, on the default route at
  SVT_HME_GLOBK 4 and 0 and on the SVT_HME_PALLAS=1 route (the reference
  runs its Pallas kernel in interpret mode there; the port, on the CPU,
  the kernel's plain version).
- The port's CLI writes the reference CLI's IVF bytes at 176x144 on a clip
  of tools/make_test_clip.py: low delay with TF and TPL on both routes,
  and the default random access at preset 8 with TF off. With TF on, the
  random-access stream decodes in dav1d to the port's own decoder's
  frames.
- --nch spawns the port, and --device cuda without a GPU fails loudly.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import svt_av1_psy_tpu.models.fast_intra as ref_fi
from svt_av1_psy_tpu.app import cli as ref_cli
from svt_av1_psy_tpu.decoder.dav1d import decode_ivf as dav1d_decode
from svt_av1_psy_tpu.io.y4m import Y4mWriter
from svt_av1_psy_tpu.models import temporal_filter as ref_tf
from svt_av1_psy_tpu.models import tpl as ref_tpl
from svt_av1_psy_tpu_torch.app import cli as port_cli
from svt_av1_psy_tpu_torch.decoder.driver import decode_ivf as own_decode
from svt_av1_psy_tpu_torch.models import fast_intra as port_fi
from svt_av1_psy_tpu_torch.models import temporal_filter as port_tf
from svt_av1_psy_tpu_torch.models import tpl as port_tpl

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from make_test_clip import make_frame  # noqa: E402

H, W = 144, 176
KINDS = ["shifted", "scroll", "flat"]
ROUTES = {"globk4": {"SVT_HME_GLOBK": "4"},
          "globk0": {"SVT_HME_GLOBK": "0"},
          "pallas": {"SVT_HME_PALLAS": "1"}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per worker process (the suite runs several at
    once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=list(ROUTES))
def route(request, monkeypatch):
    """The motion-search route for both packages; the reference reads it
    once, at its first search, so its cache is cleared before and after."""
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL", "SVT_HME_GLOBK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in ROUTES[request.param].items():
        monkeypatch.setenv(name, value)
    ref_fi._jitted_hme.cache_clear()
    yield request.param
    ref_fi._jitted_hme.cache_clear()


def _move(kind, y, t, rng):
    """Frame t of a clip: the luma moved t steps, plus fresh noise."""
    if kind == "flat":
        return y.copy()
    if kind == "shifted":
        out = np.roll(y, (3 * t, -5 * t), (0, 1))
    else:
        # scroll/wrap: the top half pans right, the bottom half moves up
        # and left, so blocks take the global candidates
        out = y.copy()
        out[:H // 2] = np.roll(y[:H // 2], 20 * t, 1)
        out[H // 2:] = np.roll(y[H // 2:], (-10 * t, 6 * t), (0, 1))
    noise = rng.integers(-6, 7, out.shape) if t else 0
    return np.clip(out.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def _clip(kind, n, seed=3):
    """n (y, u, v) frames of one motion kind; chroma follows the luma."""
    rng = np.random.default_rng(seed)
    y0 = np.full((H, W), 77, np.uint8) if kind == "flat" else \
        rng.integers(0, 256, (H, W)).astype(np.uint8)
    frames = []
    for t in range(n):
        y = _move(kind, y0, t, rng)
        frames.append((y, y[::2, ::2].copy(), (255 - y[::2, ::2]).copy()))
    return frames


@pytest.mark.parametrize("kind", KINDS)
def test_hme_mv_sad_matches_jax(route, kind):
    (src, _, _), (ref, _, _) = _clip(kind, 2)
    got = port_fi.hme_mv_sad(src, ref, "cpu")
    want = ref_fi.hme_mv_sad(src, ref)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, np.asarray(w))
    assert got[0].shape == (H // 16, W // 16, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_temporal_filter_matches_jax(route, kind):
    """The CLI's key-frame window: two frames before the centre and two
    after; the float64 accumulation is the reference's, so the planes are
    equal."""
    win = _clip(kind, 5)
    got = port_tf.temporal_filter(win, 2, strength=3, device="cpu")
    want = ref_tf.temporal_filter(win, 2, strength=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind", KINDS)
def test_tpl_sb_offsets_matches_jax(route, kind):
    """The CLI's low-delay TPL: the current luma against up to 3
    lookahead lumas, nearest first."""
    ys = [f[0] for f in _clip(kind, 4)]
    got = port_tpl.tpl_sb_offsets(ys[0], ys[1:], device="cpu")
    want = ref_tpl.tpl_sb_offsets(ys[0], ys[1:])
    if kind == "flat":
        assert got is None and want is None or np.array_equal(got, want)
        return
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_tpl_gop_q_searches_on_the_device(route):
    """tpl_gop_q without precomputed edges runs its own searches through
    hme_mv_sad on the given device; without one it refuses."""
    ys = {d: f[0] for d, f in enumerate(_clip("shifted", 5))}
    plan = [(4, 0, 0, 0), (2, 0, 4, 1), (1, 0, 2, 2), (3, 2, 4, 2)]
    got = port_tpl.tpl_gop_q(ys, plan, 160, key_d=0, device="cpu")
    assert got == ref_tpl.tpl_gop_q(ys, plan, 160, key_d=0)
    with pytest.raises(ValueError, match="device"):
        port_tpl.tpl_gop_q(ys, plan, 160, key_d=0)


# --- the CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """9 frames of 176x144 from tools/make_test_clip.py (noise 0.02)."""
    path = tmp_path_factory.mktemp("cli") / "clip.y4m"
    rng = np.random.default_rng(7)
    with Y4mWriter(str(path), W, H, 30, 1, 8) as wr:
        for t in range(9):
            wr.write_frame(*make_frame(W, H, t, 8, 0.02, rng))
    return path


def _encode_both(clip, tmp_path, args):
    """The IVF bytes of the port's CLI (on the CPU) and of the
    reference's, with the same arguments."""
    out = {}
    for name, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                             ("ref", ref_cli, ["--no-device-search"])):
        path = tmp_path / f"{name}.ivf"
        assert cli.main(["-i", str(clip), "-b", str(path), "--progress",
                         "0"] + args + extra) == 0
        out[name] = path.read_bytes()
    return out["port"], out["ref"]


@pytest.mark.parametrize("pallas", [False, True], ids=["default", "pallas"])
def test_cli_low_delay_matches_jax(clip, tmp_path, monkeypatch, pallas):
    """--keyint 0: the host TF at the key frame and tpl_sb_offsets on every
    frame with up to 3 lookahead frames, through hme_mv_sad."""
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL", "SVT_HME_GLOBK"):
        monkeypatch.delenv(name, raising=False)
    if pallas:
        monkeypatch.setenv("SVT_HME_PALLAS", "1")
    ref_fi._jitted_hme.cache_clear()
    calls = []
    orig = port_fi.hme_mv_sad

    def spy(src, ref, device):
        calls.append(str(device))
        return orig(src, ref, device)

    monkeypatch.setattr(port_fi, "hme_mv_sad", spy)
    try:
        got, want = _encode_both(clip, tmp_path, [
            "--keyint", "0", "--preset", "10", "--crf", "30", "-n", "6"])
    finally:
        ref_fi._jitted_hme.cache_clear()
    assert got == want
    # TF: the key against its 2 lookahead frames; TPL: one search per
    # lookahead frame, 3 for frames 0-2, then 2, 1 and 0 (-n 6 ends the
    # lookahead at frame 5)
    assert calls == ["cpu"] * (2 + 3 + 3 + 3 + 2 + 1)


@pytest.mark.parametrize("tf", [0, 1], ids=["tf0", "tf1"])
def test_cli_random_access(clip, tmp_path, monkeypatch, tf):
    """The default flags at preset 8: random access with TPL, through
    _run_ra and the port's RaDriver. TF off: the reference's bytes; TF on
    (its planes may round apart from XLA's, tests/test_torch_gop.py): the
    stream decodes in dav1d to the port's own decoder's frames."""
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL", "SVT_HME_GLOBK"):
        monkeypatch.delenv(name, raising=False)
    args = ["--preset", "8", "--crf", "30", "--enable-tf", str(tf)]
    if tf:
        path = tmp_path / "port.ivf"
        assert port_cli.main(["-i", str(clip), "-b", str(path), "--progress",
                              "0", "--device", "cpu"] + args) == 0
        data = path.read_bytes()
    else:
        data, want = _encode_both(clip, tmp_path, args)
        assert data == want
    dav, own = dav1d_decode(data), own_decode(data)
    assert len(dav) == len(own) == 9
    for d, o in zip(dav, own):
        for a, b in zip((d.y, d.u, d.v), (o.y, o.u, o.v)):
            assert np.array_equal(a, b)


def test_cli_nch_spawns_the_port(clip, tmp_path, monkeypatch):
    """--nch 2 runs one child process per channel, each `python -m
    svt_av1_psy_tpu_torch`; both give the in-process encode's bytes."""
    spawned = []
    popen = subprocess.Popen

    def spy(cmd, *args, **kwargs):
        spawned.append(cmd)
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        return popen(cmd, *args, env=env, **kwargs)

    monkeypatch.setattr(subprocess, "Popen", spy)
    outs = [tmp_path / "a.ivf", tmp_path / "b.ivf"]
    flags = ["--preset", "12", "--crf", "35", "--keyint", "0", "-n", "2",
             "--progress", "0", "--device", "cpu"]
    assert port_cli.main(["--nch", "2", "-i", f"{clip},{clip}", "-b",
                          ",".join(map(str, outs))] + flags) == 0
    assert [c[1:3] for c in spawned] == [["-m", "svt_av1_psy_tpu_torch"]] * 2
    monkeypatch.setattr(subprocess, "Popen", popen)
    one = tmp_path / "one.ivf"
    assert port_cli.main(["-i", str(clip), "-b", str(one)] + flags) == 0
    assert outs[0].read_bytes() == outs[1].read_bytes() == one.read_bytes()


def test_cli_cuda_without_gpu_fails(clip, tmp_path, monkeypatch, capsys):
    """The default --device is cuda: without a GPU the CLI exits non-zero
    with a message and writes nothing; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.ivf"
    for extra in ([], ["--device", "cuda"], ["--device", "cuda:1"]):
        assert port_cli.main(["-i", str(clip), "-b", str(out)] + extra) == 2
        assert "--device cuda" in capsys.readouterr().err
    assert not out.exists()
