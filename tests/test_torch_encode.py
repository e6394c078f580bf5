"""The port's slice end to end: low-delay P frames at preset 10.

The port's Encoder (device search in PyTorch, on the CPU here) must give
the JAX package's payload bytes frame for frame on the SVT_HME_PALLAS=1
route and on the default (hme_search2) route, decode dav1d-exactly to its
own recon, never import jax or the JAX package (a subprocess with both
blocked runs every route and the CLI), refuse a GPU it does not have, and route
every single-device config as the reference does.
"""

import ast
import inspect
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import svt_av1_psy_tpu.models.fast_intra as ref_fi
from svt_av1_psy_tpu import api as ref_api
from svt_av1_psy_tpu.decoder.dav1d import decode_obus
from svt_av1_psy_tpu.models import intra_encoder as ref_ie
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
from svt_av1_psy_tpu_torch.models import fast_intra as port_fi
from svt_av1_psy_tpu_torch.models import intra_encoder as port_ie
from svt_av1_psy_tpu_torch.models import ra as port_ra
from test_torch_standalone import (ref_cfg, reference_source, without_trace,
                                   without_trace_lines)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from make_test_clip import make_frame  # noqa: E402

LD_CFG = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                       pred_structure=PredStructure.LOW_DELAY_B)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(w, h, n=4, seed=7, bd=8):
    rng = np.random.default_rng(seed)
    return [make_frame(w, h, t, bd, 0.02, rng) for t in range(n)]


def _encode(enc, frames):
    try:
        return [enc.encode(*f) for f in frames]
    finally:
        enc.close()


@pytest.fixture
def pallas_route(monkeypatch):
    """SVT_HME_PALLAS=1 for both packages; the JAX route is cached at its
    first call, so clear it before and after."""
    monkeypatch.setenv("SVT_HME_PALLAS", "1")
    ref_fi._jitted_hme.cache_clear()
    yield
    ref_fi._jitted_hme.cache_clear()


@pytest.fixture
def default_route(monkeypatch):
    """No route switch: both packages run hme_search2 (K_GLOB 4)."""
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL", "SVT_HME_GLOBK"):
        monkeypatch.delenv(name, raising=False)
    ref_fi._jitted_hme.cache_clear()
    yield
    ref_fi._jitted_hme.cache_clear()


@pytest.mark.parametrize("dims", [(176, 144), (352, 288)])
def test_port_encode_matches_jax(pallas_route, dims):
    w, h = dims
    frames = _frames(w, h)
    want = _encode(ref_api.Encoder(ref_cfg(LD_CFG), w, h), frames)
    got = _encode(Encoder(LD_CFG, w, h, device="cpu"), frames)
    assert [o.payload for o in got] == [o.payload for o in want]
    decoded = decode_obus(b"".join(o.payload for o in got))
    assert len(decoded) == len(got)
    for d, o in zip(decoded, got):
        assert np.array_equal(d.y, o.recon_y)
        assert np.array_equal(d.u, o.recon_u)
        assert np.array_equal(d.v, o.recon_v)


def test_port_encode_matches_jax_10bit(pallas_route):
    """The K1 route at 10 bit: the P-frame search sees uint16 source
    planes and narrows the uint16 recon to them."""
    w, h = 176, 144
    frames = _frames(w, h, n=3, bd=10)
    assert frames[0][0].dtype == np.uint16
    want = _encode(ref_api.Encoder(ref_cfg(LD_CFG), w, h, bit_depth=10),
                   frames)
    got = _encode(Encoder(LD_CFG, w, h, bit_depth=10, device="cpu"), frames)
    assert [o.payload for o in got] == [o.payload for o in want]
    decoded = decode_obus(b"".join(o.payload for o in got))
    assert len(decoded) == len(got)
    for d, o in zip(decoded, got):
        assert np.array_equal(d.y, o.recon_y)


AI_CFG = EncoderConfig(enc_mode=12, qp=35, intra_period_length=0)


@pytest.mark.parametrize("bd", [8, 10])
def test_allintra_encode_matches_jax(default_route, bd):
    """All-intra at preset 12: every frame a key, its filters searched on
    frames 0 and 8 and deferred to the filter thread on the others. The
    payloads and the recon are the JAX package's, byte for byte."""
    w, h = 176, 144
    frames = _frames(w, h, n=10, bd=bd)
    want = _encode(ref_api.Encoder(ref_cfg(AI_CFG), w, h, bit_depth=bd),
                   frames)
    got = _encode(Encoder(AI_CFG, w, h, bit_depth=bd, device="cpu"), frames)
    assert [o.payload for o in got] == [o.payload for o in want]
    for g, o in zip(got, want):
        for plane in ("recon_y", "recon_u", "recon_v"):
            assert np.array_equal(getattr(g, plane), getattr(o, plane))


@pytest.mark.parametrize("structure", ["ld", "ra"])
def test_one_tile_column_two_tile_rows_decode_to_the_recon(default_route,
                                                           structure):
    """--tile-columns 0 --tile-rows 1: a single tile column of two tile
    rows. Every frame's tile group carries both tiles (a lone tile only
    when the frame has one), so libaom decodes the stream to the recon,
    frame for frame."""
    from svt_av1_psy_tpu_torch.decoder.aom import decode_obus as aom_decode
    w, h, n = 176, 144, 5
    frames = _frames(w, h, n=n)
    if structure == "ld":
        enc = Encoder(LD_CFG.replace(tile_columns=0, tile_rows=1), w, h,
                      device="cpu")
        assert (enc._enc.n_tiles, enc._enc.n_tile_rows) == (1, 2)
        outs = _encode(enc, frames)
        shown = [(o.payload, (o.recon_y, o.recon_u, o.recon_v))
                 for o in outs]
    else:
        cfg = EncoderConfig(enc_mode=10, qp=30, hierarchical_levels=2,
                            intra_period_length=-1, tile_columns=0,
                            tile_rows=1)
        enc = Encoder(cfg, w, h, device="cpu")
        assert (enc._enc.n_tiles, enc._enc.n_tile_rows) == (1, 2)
        try:
            pkts = [p for f in frames for p in enc.send_picture(*f)]
            pkts += enc.flush()
        finally:
            enc.close()
        shown = [(p.payload, tuple(p.recon)) for p in pkts
                 if p.display_idx >= 0]
        assert [p.display_idx for p in pkts if p.display_idx >= 0] == \
            list(range(n))
        outs = pkts
    decoded = aom_decode([o.payload for o in outs])
    assert len(decoded) == len(shown) == n
    for d, (_, recon) in zip(decoded, shown):
        for plane, rec in zip((d.y, d.u, d.v), recon):
            assert np.array_equal(plane, np.asarray(rec))


@pytest.mark.parametrize("bd", [8, 10])
def test_k1_route_hands_planes_in_their_pixel_width(pallas_route,
                                                    monkeypatch, bd):
    """Both K1-route callers (the P-frame device block and hme_mv_sad)
    give the wrapper uint8 planes at 8 bit and int16 planes above: no
    int32 widening, and the uint16 recon narrowed to the source's type."""
    seen = []
    real = port_fi.hme_search_kernel
    monkeypatch.setattr(
        port_fi, "hme_search_kernel",
        lambda s, r: seen.append((s.dtype, r.dtype)) or real(s, r))
    frames = _frames(176, 144, n=2, bd=bd)
    _encode(Encoder(LD_CFG, 176, 144, bit_depth=bd, device="cpu"), frames)
    port_fi.hme_mv_sad(frames[0][0], frames[1][0], "cpu")
    want = torch.uint8 if bd == 8 else torch.int16
    assert seen == [(want, want)] * 2


def test_default_route_keeps_int32_planes(default_route):
    plane = np.zeros((16, 16), np.uint8)
    assert port_fi._hme_plane(plane, torch.device("cpu")).dtype == torch.int32


# an import blocker for a fresh interpreter: an import of jax, jaxlib or
# any module of the JAX package raises and is recorded in `attempts`
JAX_BLOCKER = r"""
import importlib.abc
import sys

attempts = []


class BlockJax(importlib.abc.MetaPathFinder):
    # jax, and every module of the JAX package (that exact first
    # component: the port's own modules pass)
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "svt_av1_psy_tpu"):
            attempts.append(name)
            raise ImportError(f"blocked in this process: {name}")
        return None


sys.meta_path.insert(0, BlockJax())
"""

_NO_JAX_ENCODE = JAX_BLOCKER + r"""
import numpy as np
from svt_av1_psy_tpu_torch.utils.test_clip import make_frame
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure

import threading
rng = np.random.default_rng(7)
frames = [make_frame(176, 144, t, 8, 0.02, rng) for t in range(5)]
# low delay on the default route (hme_search2)
cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                    pred_structure=PredStructure.LOW_DELAY_B)
enc = Encoder(cfg, 176, 144, device="cpu")
sizes = [len(enc.encode(*f).payload) for f in frames[:2]]
enc.close()
assert all(sizes), sizes
# random access with TF and TPL on: builds no warm-up thread
cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                    hierarchical_levels=2, enable_tf=1, tf_strength=3)
enc = Encoder(cfg, 176, 144, device="cpu")
assert threading.active_count() == 1, threading.enumerate()
pkts = [p for f in frames for p in enc.send_picture(*f)] + enc.flush()
enc.close()
assert sorted(p.display_idx for p in pkts if p.display_idx >= 0) == \
    list(range(len(frames)))
# the preset-6 north-star route: random access with TF, TPL and LR
cfg = EncoderConfig(enc_mode=6, qp=30, intra_period_length=-1,
                    hierarchical_levels=2, enable_tf=1, tf_strength=1)
enc = Encoder(cfg, 176, 144, device="cpu")
pkts = [p for f in frames for p in enc.send_picture(*f)] + enc.flush()
assert enc._enc.enable_lr and enc._enc._lr_dev is not None
enc.close()
assert sorted(p.display_idx for p in pkts if p.display_idx >= 0) == \
    list(range(len(frames)))
# a screen-content key (--scm 2 flags text) through the full-RD encoder
from svt_av1_psy_tpu_torch.models.fast_intra import FastIntraEncoder
sc_keys = []
orig = FastIntraEncoder._encode_key_sc
FastIntraEncoder._encode_key_sc = \
    lambda self, *a: sc_keys.append(1) or orig(self, *a)
text = np.full((144, 176), 235, np.uint8)
text[:18] = 64
text[40:90:6, 8:170:5] = 16
uv = np.full((72, 88), 128, np.uint8)
cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                    pred_structure=PredStructure.LOW_DELAY_B)
enc = Encoder(cfg, 176, 144, device="cpu")
assert enc.encode(text, uv, uv).payload
enc.close()
assert sc_keys == [1], sc_keys
# preset 3: the full-RD IntraEncoder
cfg = EncoderConfig(enc_mode=3, qp=30, intra_period_length=-1,
                    pred_structure=PredStructure.LOW_DELAY_B)
small = make_frame(192, 128, 0, 8, 0.02, np.random.default_rng(7))
enc = Encoder(cfg, 192, 128, device="cpu")
assert enc.encode(*small).payload
enc.close()
# the CLI: low delay with the key-frame TF and the TPL lookahead
import os
import tempfile
from svt_av1_psy_tpu_torch.app.cli import main
from svt_av1_psy_tpu_torch.bitstream.ivf import read_ivf
from svt_av1_psy_tpu_torch.io.y4m import Y4mWriter
with tempfile.TemporaryDirectory() as tmp:
    clip, out = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "out.ivf")
    with Y4mWriter(clip, 176, 144, 30, 1, 8) as wr:
        for f in frames[:4]:
            wr.write_frame(*f)
    assert main(["-i", clip, "-b", out, "--keyint", "0", "--preset", "10",
                 "--crf", "30", "--device", "cpu", "--progress", "0"]) == 0
    assert len(read_ivf(out)[1]) == 4
assert not attempts, attempts
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "svt_av1_psy_tpu")]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_encode_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL", "SVT_HME_GLOBK"):
        env.pop(name, None)
    r = subprocess.run([sys.executable, "-c", _NO_JAX_ENCODE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Encoder(LD_CFG, 176, 144, device="cuda")


@pytest.mark.parametrize("change, route", [
    ({"pred_structure": PredStructure.RANDOM_ACCESS,
      "hierarchical_levels": 5}, "ra"),
    ({"enable_restoration_filtering": 1}, "lr"),
    ({"enc_mode": 6}, "lr"),          # LR on by default at preset <= 7
    ({"enc_mode": 3}, "full_rd"),
    ({"screen_content_mode": 1}, "full_rd"),
], ids=["random_access", "lr", "preset6", "preset3", "scm1"])
def test_unported_routes_raise(change, route):
    """The routing, as the reference's: random access builds the port's
    RaDriver; LR turns on the fast encoder's search on the port's device;
    presets <= 3 and --scm 1 build the port's IntraEncoder. No route
    raises any more."""
    cfg = LD_CFG.replace(**change)
    ref = ref_api.Encoder(ref_cfg(cfg.replace(hierarchical_levels=0)), 176,
                         144)
    enc = Encoder(cfg, 176, 144, device="cpu")
    try:
        assert enc._enc.device == torch.device("cpu")
        if route == "ra":
            assert type(enc._ra) is port_ra.RaDriver
            assert enc._ra.enc is enc._enc and enc._ra.M == 32
            assert enc.cfg.hierarchical_levels == 5
        else:
            assert enc._ra is None
        # the port's classes are copies of the reference's, not subclasses
        assert all(c.__module__.split(".")[0] != "svt_av1_psy_tpu"
                   for c in type(enc._enc).__mro__)
        if route == "full_rd":
            assert type(enc._enc) is port_ie.IntraEncoder
            assert type(ref._enc) is ref_ie.IntraEncoder
        else:
            assert type(enc._enc) is port_fi.FastIntraEncoder
            assert enc._enc.enable_lr == ref._enc.enable_lr == \
                (route == "lr")
    finally:
        enc.close()
        ref.close()


def test_hme_search2_route_raises(default_route):
    """With no route switch the P frames run hme_search2, as in the JAX
    package: the same payload bytes."""
    frames = _frames(176, 144)
    want = _encode(ref_api.Encoder(ref_cfg(LD_CFG), 176, 144), frames)
    got = _encode(Encoder(LD_CFG, 176, 144, device="cpu"), frames)
    assert [o.payload for o in got] == [o.payload for o in want]


def test_unported_methods_raise():
    """No method raises any more. The screen-content key and the LR
    search run, with the reference's results on a 64x64 frame."""
    enc = port_fi.FastIntraEncoder(64, 64, qindex=120, device="cpu")
    ref = ref_fi.FastIntraEncoder(64, 64, qindex=120)
    y = np.zeros((64, 64), np.uint8)
    y[8:12, 4:60:3] = 200
    uv = np.full((32, 32), 128, np.uint8)
    assert enc._encode_key_sc(y, uv, uv).payload == \
        ref._encode_key_sc(y, uv, uv).payload
    enc._lr_search((enc._rec_y, enc._rec_u, enc._rec_v), (y, uv, uv), 120)
    ref._lr_apply_and_search(y, uv, uv, 120, None, None)
    assert enc._lr_pending[0] == "dev"
    got, want = enc._take_lr_pending(), ref._take_lr_pending()
    assert (got is None) == (want is None)
    if got is not None:
        assert got.lr_type == want.lr_type and got.units == want.units


def _lines(source):
    """A method's source lines without blank ones, the reference's jax
    imports and the port's tracing (without_trace_lines)."""
    return without_trace_lines(
        [ln for ln in source.split("\n")
         if ln.strip() and ln.strip() not in ("import jax",
                                              "import jax.numpy as jnp")])


def _outside_device_block(lines):
    """_encode_p's lines outside the low-delay branch of its device-search
    block."""
    i = next(i for i, ln in enumerate(lines)
             if 'with _tstage("device_search"):' in ln)
    i0 = next(j for j in range(i, len(lines)) if lines[j].strip() == "else:")
    i1 = next(i for i, ln in enumerate(lines)
              if "# global motion: ROTZOOM" in ln)
    return lines[:i0] + lines[i1:]


# the statements of each walk that the port's tile runner, tile-group
# assembly and filter stage (models/frame_tail.py) replace: cut from both
# sides between two lines they share, named by how they start
TAIL_CUTS = {
    "_encode_key": [("return ec.done()", "# frame-end context save"),
                    ("self.seq.film_grain_params_present",
                     "if self.hierarchical_levels > 0 or")],
    "_encode_p": [("return ec.done(), grid_exp", "# a deferred leaf filter"),
                  ('with _tstage("inter_commit_walk")', "tile_bytes = "),
                  ("7, is_intra=False)", "self._fc_saved = tile_fcs[0]")]}


def _without_tail(lines, name):
    for after, before in TAIL_CUTS[name]:
        i0 = next(i for i, ln in enumerate(lines)
                  if ln.strip().startswith(after))
        i1 = next(i for i in range(i0 + 1, len(lines))
                  if lines[i].strip().startswith(before))
        lines = lines[:i0 + 1] + lines[i1:]
    return lines


def test_encode_p_copy_has_not_drifted():
    ref = _without_tail(_outside_device_block(_lines(
        inspect.getsource(ref_fi.FastIntraEncoder._encode_p))), "_encode_p")
    port = _without_tail(_outside_device_block(_lines(
        reference_source(port_fi.FastIntraEncoder._encode_p))), "_encode_p")
    assert len(ref) > 400
    assert port == ref


@pytest.mark.parametrize("name", ["_encode_key", "_take_decide"])
def test_traced_copy_has_not_drifted(name):
    """The copied methods that the port only traces are the reference's
    statement for statement once the tracing is taken out, and traced;
    _encode_key's statements that the port's tile runner, tile-group
    assembly and filter stage replace (TAIL_CUTS) are left out."""
    ref = inspect.getsource(getattr(ref_fi.FastIntraEncoder, name))
    port = reference_source(getattr(port_fi.FastIntraEncoder, name))
    if name in TAIL_CUTS:
        assert _without_tail(_lines(port), name) == \
            _without_tail(_lines(ref), name)
    else:
        assert without_trace(port) == without_trace(ref)
    assert without_trace(port) != ast.dump(ast.parse(textwrap.dedent(port)))


@pytest.mark.cuda
def test_cuda_encode_matches_cpu(pallas_route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from svt_av1_psy_tpu_torch.kernels.hme import hme_search_kernel
    frames = _frames(176, 144, n=3)
    want = _encode(Encoder(LD_CFG, 176, 144, device="cpu"), frames)
    hme_search_kernel.launches = 0
    got = _encode(Encoder(LD_CFG, 176, 144, device="cuda"), frames)
    assert hme_search_kernel.launches == len(frames) - 1
    assert [o.payload for o in got] == [o.payload for o in want]
