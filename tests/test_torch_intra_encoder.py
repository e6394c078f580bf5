"""The full-RD intra route through the port: block_mode_costs, the
IntraEncoder decision, screen-content key frames, presets <= 3 and
--scm 1, each against the JAX package on the same inputs.

block_mode_costs is integer math: its costs and first-minimum modes must
equal the JAX function's byte for byte, ties included (a flat plane ties
all 7 modes). Whole encodes must give the JAX package's payload bytes and
decode dav1d-exactly. The copied _encode_key_sc and the copied split tree
of _decide are guarded against drift.

JAX is imported inside the helpers, so that the CUDA tests of this file
also run where JAX is not installed (``--noconftest -m cuda``).
"""

import ast
import inspect
import pathlib
import sys
import textwrap

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu import api as ref_api
from svt_av1_psy_tpu.decoder.dav1d import decode_obus
from svt_av1_psy_tpu.models import fast_intra as ref_fi
from svt_av1_psy_tpu.models import intra_encoder as ref_ie
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
from svt_av1_psy_tpu_torch.models import fast_intra as port_fi
from svt_av1_psy_tpu_torch.models import intra_encoder as port_ie
from svt_av1_psy_tpu_torch.ops import torch_backend as tb

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from make_test_clip import make_frame  # noqa: E402

CPU = torch.device("cpu")
W, H = 176, 144
LD_CFG = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                       pred_structure=PredStructure.LOW_DELAY_B)
RA_CFG = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                       hierarchical_levels=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane(content, h, w, bd, seed=11):
    hi = (1 << bd) - 1
    rng = np.random.default_rng(seed)
    if content == "flat":
        p = np.full((h, w), 100 << (bd - 8))
    elif content == "noise":
        p = rng.integers(0, hi + 1, (h, w))
    else:       # edges: a checker of hard steps plus a diagonal ramp
        yy, xx = np.mgrid[0:h, 0:w]
        p = np.where((xx // 13 + yy // 7) % 2 == 0, hi // 5, hi - 3)
        p = np.where(xx > yy + 20, (xx * 7) % (hi + 1), p)
    return p.astype(np.uint8 if bd == 8 else np.uint16)


def _text_frame(w, h, t):
    """Text-like screen content: a dark title bar and short dark strokes
    on a light page, the bottom quarter scrolling with t. The reference's
    --scm 2 detector flags it."""
    y = np.full((h, w), 235, np.uint8)
    y[: h // 8, :] = 64
    r = np.random.default_rng(5)
    for _ in range(40):
        gx = int(r.integers(4, w - 12))
        gy = int(r.integers(h // 8 + 4, h - 8))
        y[gy:gy + 2, gx:gx + int(r.integers(2, 9))] = 16
    sh = h // 4
    y[h - sh:, :] = np.roll(y[h - sh:, :], -(2 * t) % sh, axis=0)
    u = np.full((h // 2, w // 2), 128, np.uint8)
    v = np.full((h // 2, w // 2), 128, np.uint8)
    return y, u, v


def _natural(n, w, h, seed=7):
    rng = np.random.default_rng(seed)
    return [make_frame(w, h, t, 8, 0.02, rng) for t in range(n)]


def _encode(enc, frames, ra):
    """Payloads in decode order, each with its display index and recon."""
    try:
        if ra:
            pkts = [p for f in frames for p in enc.send_picture(*f)]
            pkts += enc.flush()
            return [(p.payload, p.display_idx, p.recon) for p in pkts]
        outs = [enc.encode(*f) for f in frames]
        return [(o.payload, i, (o.recon_y, o.recon_u, o.recon_v))
                for i, o in enumerate(outs)]
    finally:
        enc.close()


def _check_stream(out, n):
    shown = [(i, rec) for _, i, rec in out if i >= 0]
    assert [i for i, _ in shown] == list(range(n))
    decoded = decode_obus(b"".join(p for p, _, _ in out))
    assert len(decoded) == n
    for d, (_, rec) in zip(decoded, shown):
        for plane, r in zip((d.y, d.u, d.v), rec):
            assert np.array_equal(plane, r)


# --- block_mode_costs and _decide ---------------------------------------

@pytest.mark.parametrize("size", [64, 32, 16, 8])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("content", ["flat", "noise", "edges"])
def test_block_mode_costs_matches_jax(content, bd, size):
    """Costs (nr, nc, 7) and the first cheapest mode equal JAX's exactly;
    on the flat plane every interior block ties all 7 modes, so the first
    minimum (mode 0) must win there."""
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops.jax_backend import block_mode_costs
    p = _plane(content, 128, 192, bd)
    want_c, want_b = jax.jit(block_mode_costs, static_argnums=(1, 2))(
        jnp.asarray(p.astype(np.int32)), size, bd)
    got_c, got_b = tb.block_mode_costs(tb.plane_tensor(p, CPU), size, bd)
    assert got_c.dtype == torch.int32 and got_b.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    if content == "flat":
        inner = got_c.numpy()[1:, 1:]
        assert (inner == inner[..., :1]).all()          # all 7 modes tie
        assert (got_b.numpy()[1:, 1:] == 0).all()


@pytest.mark.parametrize("min_block", [8, 16])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("content", ["flat", "noise", "edges"])
def test_decide_matches_jax(content, bd, min_block):
    """IntraEncoder._decide: the per-size best modes and the split maps
    equal the reference's."""
    p = _plane(content, 128, 192, bd)
    kw = dict(qindex=120, bd=bd, min_block=min_block)
    want_b, want_s = ref_ie.IntraEncoder(192, 128, **kw)._decide(p)
    got_b, got_s = port_ie.IntraEncoder(192, 128, device="cpu",
                                        **kw)._decide(p)
    assert sorted(got_b) == sorted(want_b) and sorted(got_s) == sorted(want_s)
    for s in want_b:
        assert got_b[s].dtype == want_b[s].dtype
        assert np.array_equal(got_b[s], want_b[s])
    for s in want_s:
        assert np.array_equal(got_s[s], want_s[s])


# --- whole encodes --------------------------------------------------------

@pytest.fixture
def sc_keys(monkeypatch):
    """Counts the key frames that the port routes through _encode_key_sc."""
    calls = []
    orig = port_fi.FastIntraEncoder._encode_key_sc

    def spy(self, *args, **kwargs):
        calls.append(self.frame_index)
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(port_fi.FastIntraEncoder, "_encode_key_sc", spy)
    return calls


@pytest.mark.parametrize("ra, n", [(False, 3), (True, 5)], ids=["LD", "RA"])
def test_screen_content_key_matches_jax(sc_keys, ra, n):
    """The default config (--scm 2) at preset 10: the detector flags the
    text key, which goes through the port's IntraEncoder; the stream
    equals the JAX package's byte for byte."""
    frames = [_text_frame(W, H, t) for t in range(n)]
    cfg = RA_CFG if ra else LD_CFG
    want = _encode(ref_api.Encoder(cfg, W, H), frames, ra)
    got = _encode(Encoder(cfg, W, H, device="cpu"), frames, ra)
    assert sc_keys == [0]
    assert [o[:2] for o in got] == [o[:2] for o in want]
    _check_stream(got, n)


@pytest.mark.parametrize("change, text", [
    ({"enc_mode": 3}, False),
    ({"screen_content_mode": 1}, True),
], ids=["preset3", "scm1"])
def test_full_rd_route_matches_jax(change, text):
    """Presets <= 3 and --scm 1 build the port's IntraEncoder (key, then
    full-RD P frames); payload bytes equal the JAX package's. 192x128:
    the reference's IntraEncoder streams do not decode at 176x144 (a
    fault of the shared host code, ROADMAP queue 3)."""
    w, h = 192, 128
    frames = [_text_frame(w, h, t) for t in range(2)] if text \
        else _natural(2, w, h)
    cfg = LD_CFG.replace(**change)
    want = _encode(ref_api.Encoder(cfg, w, h), frames, False)
    enc = Encoder(cfg, w, h, device="cpu")
    assert type(enc._enc) is port_ie.IntraEncoder
    assert enc._enc.device == CPU
    got = _encode(enc, frames, False)
    assert [o[0] for o in got] == [o[0] for o in want]
    _check_stream(got, len(frames))


def test_preset3_pyramid_gets_no_ra_driver():
    """hierarchical_levels does not make a full-RD preset random access:
    the reference builds no RaDriver there, and neither does the port."""
    cfg = EncoderConfig(enc_mode=3, qp=30, intra_period_length=-1,
                        hierarchical_levels=5)
    ref = ref_api.Encoder(cfg, W, H)
    enc = Encoder(cfg, W, H, device="cpu")
    try:
        assert ref._ra is None and enc._ra is None
        assert type(enc._enc) is port_ie.IntraEncoder
        assert enc.cfg.hierarchical_levels == 5
    finally:
        enc.close()
        ref.close()


# --- drift guards ---------------------------------------------------------

def _body(fn, drop):
    """ast dumps of the statements of fn, its docstring dropped, with
    every `device=` keyword removed from its calls and every statement
    for which drop(stmt) holds left out."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            node.keywords = [k for k in node.keywords if k.arg != "device"]
    return [ast.dump(s) for s in body if not drop(s)]


def test_encode_key_sc_copy_has_not_drifted():
    """The port's _encode_key_sc is the reference's but for the import of
    IntraEncoder and the device it builds it on."""
    def imports_intra_encoder(s):
        return isinstance(s, ast.ImportFrom) and \
            s.module == "svt_av1_psy_tpu.models.intra_encoder"

    ref = _body(ref_fi.FastIntraEncoder._encode_key_sc,
                imports_intra_encoder)
    port = _body(port_fi.FastIntraEncoder._encode_key_sc, lambda s: False)
    assert len(ref) > 30 and port == ref


def test_decide_split_tree_copy_has_not_drifted():
    """The host split tree of _decide (from the rate bias on) is the
    reference's, line for line."""
    def tail(fn):
        lines = [ln.strip() for ln in inspect.getsource(fn).split("\n")
                 if ln.strip()]
        return lines[next(i for i, ln in enumerate(lines)
                          if ln.startswith("bias = ")):]

    ref = tail(ref_ie.IntraEncoder._decide)
    assert len(ref) > 10
    assert tail(port_ie.IntraEncoder._decide) == ref


# --- on the card ----------------------------------------------------------

@pytest.mark.cuda
def test_block_mode_costs_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    for content in ("flat", "noise", "edges"):
        p = _plane(content, 1088, 1920, 8)
        for s in (64, 32, 16, 8):
            want = tb.block_mode_costs(tb.plane_tensor(p, CPU), s)
            got = tb.block_mode_costs(tb.plane_tensor(p, cuda), s)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [LD_CFG, LD_CFG.replace(enc_mode=3)],
                         ids=["sc_key", "preset3"])
def test_full_rd_cuda_matches_cpu(cfg):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = [_text_frame(192, 128, t) for t in range(2)]
    want = _encode(Encoder(cfg, 192, 128, device="cpu"), frames, False)
    got = _encode(Encoder(cfg, 192, 128, device="cuda"), frames, False)
    assert [o[0] for o in got] == [o[0] for o in want]
