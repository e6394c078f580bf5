"""The port's slice end to end: low-delay P frames at preset 10.

The port's Encoder (device search in PyTorch, on the CPU here) must give
the JAX package's payload bytes frame for frame on the SVT_HME_PALLAS=1
route and on the default (hme_search2) route, decode dav1d-exactly to its
own recon, never import jax, refuse a GPU it does not have, and route
every single-device config as the reference does (only the multi-device
decide raises NotImplementedError).
"""

import inspect
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import svt_av1_psy_tpu.models.fast_intra as ref_fi
from svt_av1_psy_tpu import api as ref_api
from svt_av1_psy_tpu.decoder.dav1d import decode_obus
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
from svt_av1_psy_tpu_torch.models import fast_intra as port_fi
from svt_av1_psy_tpu_torch.models import intra_encoder as port_ie
from svt_av1_psy_tpu_torch.models import ra as port_ra

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


def _frames(w, h, n=4, seed=7):
    rng = np.random.default_rng(seed)
    return [make_frame(w, h, t, 8, 0.02, rng) for t in range(n)]


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
    want = _encode(ref_api.Encoder(LD_CFG, w, h), frames)
    got = _encode(Encoder(LD_CFG, w, h, device="cpu"), frames)
    assert [o.payload for o in got] == [o.payload for o in want]
    decoded = decode_obus(b"".join(o.payload for o in got))
    assert len(decoded) == len(got)
    for d, o in zip(decoded, got):
        assert np.array_equal(d.y, o.recon_y)
        assert np.array_equal(d.u, o.recon_u)
        assert np.array_equal(d.v, o.recon_v)


_NO_JAX_ENCODE = r"""
import importlib.abc
import sys

attempts = []


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            attempts.append(name)
            raise ImportError(f"jax is blocked in this process: {name}")
        return None


sys.meta_path.insert(0, BlockJax())
sys.path.insert(0, "tools")
import numpy as np
from make_test_clip import make_frame
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
assert not attempts, attempts
assert "jax" not in sys.modules
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
    ref = ref_api.Encoder(cfg.replace(hierarchical_levels=0), 176, 144)
    enc = Encoder(cfg, 176, 144, device="cpu")
    try:
        assert enc._enc.device == torch.device("cpu")
        if route == "ra":
            assert type(enc._ra) is port_ra.RaDriver
            assert enc._ra.enc is enc._enc and enc._ra.M == 32
            assert enc.cfg.hierarchical_levels == 5
        else:
            assert enc._ra is None
        if route == "full_rd":
            assert type(enc._enc) is port_ie.IntraEncoder
            assert type(ref._enc) is port_ie.IntraEncoder.__base__
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
    want = _encode(ref_api.Encoder(LD_CFG, 176, 144), frames)
    got = _encode(Encoder(LD_CFG, 176, 144, device="cpu"), frames)
    assert [o.payload for o in got] == [o.payload for o in want]


def test_unported_methods_raise():
    """Only the multi-device decide still raises. The screen-content key
    and the LR search run, with the reference's results on a 64x64
    frame."""
    enc = port_fi.FastIntraEncoder(64, 64, qindex=120, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc.make_sharded_decide(None)
    ref = ref_fi.FastIntraEncoder(64, 64, qindex=120)
    y = np.zeros((64, 64), np.uint8)
    y[8:12, 4:60:3] = 200
    uv = np.full((32, 32), 128, np.uint8)
    assert enc._encode_key_sc(y, uv, uv).payload == \
        ref._encode_key_sc(y, uv, uv).payload
    for e in (enc, ref):
        e._lr_apply_and_search(y, uv, uv, 120, None, None)
    assert enc._lr_pending[0] == "dev"
    got, want = enc._take_lr_pending(), ref._take_lr_pending()
    assert (got is None) == (want is None)
    if got is not None:
        assert got.lr_type == want.lr_type and got.units == want.units


def _outside_device_block(method):
    """Source lines of _encode_p outside the low-delay branch of its
    device-search block, blank lines and the reference's jax imports
    dropped."""
    lines = [ln for ln in inspect.getsource(method).split("\n")
             if ln.strip() and ln.strip() not in ("import jax",
                                                  "import jax.numpy as jnp")]
    i = next(i for i, ln in enumerate(lines)
             if 'with _tstage("device_search"):' in ln)
    i0 = next(j for j in range(i, len(lines)) if lines[j].strip() == "else:")
    i1 = next(i for i, ln in enumerate(lines)
              if "# global motion: ROTZOOM" in ln)
    return lines[:i0] + lines[i1:]


def test_encode_p_copy_has_not_drifted():
    ref = _outside_device_block(ref_fi.FastIntraEncoder._encode_p)
    port = _outside_device_block(port_fi.FastIntraEncoder._encode_p)
    assert len(ref) > 400
    assert port == ref


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
