"""Random access through the port: whole encodes against the JAX package.

The port's Encoder runs the reference's pyramid with its device search
(the GoP program, the key and anchor temporal filters) in PyTorch, on the
CPU here. With TF off it must give the JAX package's payload bytes packet
for packet, at two pyramid depths, across a keyint boundary and with a
partial tail GoP; with TF on, the filtered planes may round differently
(tests/test_torch_gop.py bounds that), so the stream is held to dav1d
against its own recon. The methods the port copies from the reference
RaDriver are guarded against drift line by line.
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
from svt_av1_psy_tpu.models import ra as ref_ra
from svt_av1_psy_tpu_torch import api as port_api
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig
from svt_av1_psy_tpu_torch.models import ra as port_ra

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from make_test_clip import make_frame  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One torch thread per worker process (the suite runs several at
    once), and the default motion-search route for both packages."""
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL", "SVT_HME_GLOBK"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(levels, keyint=-1, tf=0):
    return EncoderConfig(enc_mode=10, qp=30, hierarchical_levels=levels,
                         intra_period_length=keyint,
                         enable_tf=1 if tf else 0, tf_strength=max(tf, 1))


def _frames(w, h, n, seed=7, bd=8):
    rng = np.random.default_rng(seed)
    return [make_frame(w, h, t, bd, 0.02, rng) for t in range(n)]


def _encode(enc, frames):
    try:
        pkts = [p for f in frames for p in enc.send_picture(*f)]
        return pkts + enc.flush()
    finally:
        enc.close()


def _check_stream(pkts, n):
    """Shown TUs in display order, each dav1d-exact to its recon."""
    shown = [p for p in pkts if p.display_idx >= 0]
    assert [p.display_idx for p in shown] == list(range(n))
    decoded = decode_obus(b"".join(p.payload for p in pkts))
    assert len(decoded) == n
    for d, p in zip(decoded, shown):
        for plane, rec in zip((d.y, d.u, d.v), p.recon):
            assert np.array_equal(plane, rec)


@pytest.mark.parametrize("dims, levels, n, keyint", [
    ((176, 144), 2, 9, -1),
    ((352, 288), 3, 17, -1),
    ((176, 144), 2, 14, 5),          # keys at 0, 6, 12: partial GoPs
    ((176, 144), 3, 12, -1),         # one 8-GoP and a 3-frame tail
], ids=["L2", "L3-cif", "keyint", "tail"])
def test_ra_encode_matches_jax(dims, levels, n, keyint):
    w, h = dims
    frames = _frames(w, h, n)
    cfg = _cfg(levels, keyint)
    want = _encode(ref_api.Encoder(cfg, w, h), frames)
    got = _encode(Encoder(cfg, w, h, device="cpu"), frames)
    assert [p.payload for p in got] == [p.payload for p in want]
    assert [p.display_idx for p in got] == [p.display_idx for p in want]
    _check_stream(got, n)


@pytest.mark.parametrize("bd", [8, 10])
def test_ra_encode_with_tf_is_dav1d_exact(bd):
    w, h, n = 176, 144, 9
    frames = _frames(w, h, n, seed=3, bd=bd)
    enc = Encoder(_cfg(2, tf=3), w, h, bit_depth=bd, device="cpu")
    assert enc._ra.tf_strength == 3 and enc._ra.tpl_strength == 1.0
    _check_stream(_encode(enc, frames), n)


def test_gop_meshes_raise():
    enc = Encoder(_cfg(2), 176, 144, device="cpu")
    enc._ra.gop_meshes = [object()]
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            for f in _frames(176, 144, 5):
                enc.send_picture(*f)
    finally:
        enc.close()


# --- drift guards ------------------------------------------------------

def _lines_between(method, regions):
    """Non-blank source lines of `method` with the lines strictly between
    each (start, end) pair of anchor lines removed. Both anchors must be
    lines that the reference and the port share."""
    lines = [ln for ln in inspect.getsource(method).split("\n")
             if ln.strip()]
    for start, end in regions:
        i0 = next(i for i, ln in enumerate(lines) if start in ln)
        i1 = next(i for i in range(i0 + 1, len(lines)) if end in lines[i])
        lines = lines[:i0 + 1] + lines[i1:]
    return lines


# the device parts of _dispatch_gop: the docstring, the jax imports, the
# planes' upload, the two program calls, the multi-device branch with the
# fetch thread, and the fetch-thread keys of the task
_DISPATCH_REGIONS = [
    ("def _dispatch_gop", "buf, self._buf = self._buf, []"),
    ("return None", "from svt_av1_psy_tpu.models.intra_encoder"),
    ('with _tstage("gop_dispatch"):', "if tf_on:"),
    ("w2_v[T - 1] = _pad_to", "tf_n = 2"),
    ("tf_mid = mid_d if tf_mid else None",
     "# dispatch-time base for the NEXT GoP's edges"),
    ('return {"frames": frames', '"n": len(buf)'),
]
_WALK_REGIONS = [
    ('emission)."""', "from svt_av1_psy_tpu.utils.trace import stage"),
]


@pytest.mark.parametrize("name, regions, min_lines", [
    ("_dispatch_gop", _DISPATCH_REGIONS, 100),
    ("_walk_gop", _WALK_REGIONS, 130),
])
def test_ra_copies_have_not_drifted(name, regions, min_lines):
    ref = _lines_between(getattr(ref_ra.RaDriver, name), regions)
    port = _lines_between(getattr(port_ra.RaDriver, name), regions)
    assert len(ref) > min_lines
    assert port == ref


def test_ra_routing_copy_has_not_drifted():
    """Encoder._route_random_access holds the statements of the RA branch
    of the reference routing (its RaDriver import aside)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(ref_api.Encoder)))
    branch = next(node for node in ast.walk(tree)
                  if isinstance(node, ast.If) and
                  "RANDOM_ACCESS" in ast.unparse(node.test) and
                  "RaDriver" in ast.unparse(node.body[0]))
    ref = [ast.dump(s) for s in branch.body
           if not isinstance(s, ast.ImportFrom)]
    port_fn = ast.parse(textwrap.dedent(inspect.getsource(
        port_api.Encoder._route_random_access))).body[0]
    port = [ast.dump(s) for s in port_fn.body[1:]]        # no docstring
    assert len(ref) == 3 and port == ref


def test_port_ra_starts_no_warmup():
    enc = Encoder(_cfg(5, tf=1), 176, 144, device="cpu")
    try:
        assert type(enc._ra) is port_ra.RaDriver
        assert getattr(enc._ra, "_warm_thread", None) is None
    finally:
        enc.close()
