"""Loop restoration through the port: the Wiener search program against
the JAX package's, and whole preset-6 encodes (LR on by default).

The program is float32 and sums in another order than XLA (the Gram
products, the integral image), so a solved tap near x.5 may round the
other way: taps are held to max |diff| <= 1, the reference's own bound
between its two paths (svt_av1_psy_tpu/models/lr_search.py), and the
count of differing taps is printed. Per-unit SSEs are held to relative
1e-6 on every plane whose taps match, and the decisions of the
reference's finish must be equal. Whole encodes at 176x144 and 352x288
give the JAX package's payload bytes (no tap differs on these clips) and
decode dav1d-exactly. The reference's _lr_apply_and_search and the LR step
of the port's filter stage agree on the same planes.

JAX is imported inside the helpers, so that the CUDA tests of this file
also run where JAX is not installed (``--noconftest -m cuda``).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu import api as ref_api
from svt_av1_psy_tpu.decoder.dav1d import decode_obus
from svt_av1_psy_tpu.models import fast_intra as ref_fi
from svt_av1_psy_tpu.models import lr_search as ref_lr
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
from svt_av1_psy_tpu_torch.models import fast_intra as port_fi
from svt_av1_psy_tpu_torch.models import lr_search as port_lr
from test_torch_standalone import ref_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from make_test_clip import make_frame  # noqa: E402

SSE_RTOL = 1e-6
RDMULT = 60.0


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


def _dims(w, h):
    c = ((w + 1) // 2, (h + 1) // 2)
    return [(w, h), c, c]


def _planes(content, w, h, bd, seed=3):
    """(source, recon) planes of one frame: uint8/uint16 sources and
    uint16 recons, padded past the exact dims as the encoder's buffers
    are. The recon is the source, smoothed a little and with coding-like
    noise, so that the Wiener solve has something to find; its squared
    error sums stay below 2^24, where float32 integral images are exact
    in any order."""
    rng = np.random.default_rng(seed)
    hi = (1 << bd) - 1
    src, rec = [], []
    for pw, ph in _dims(w, h):
        if content == "flat":
            s = np.full((ph, pw), 90.0 * (hi / 255))
        elif content == "noise":
            s = make_frame(pw, ph, 0, bd, 0.05, rng)[0].astype(np.float64)
        else:       # edges: hard steps plus a ramp
            yy, xx = np.mgrid[0:ph, 0:pw]
            s = np.where((xx // 11 + yy // 9) % 2 == 0, hi * 0.2, hi * 0.8)
            s = np.where(xx > yy + 10, (xx * 5) % (hi + 1), s)
        smooth = (np.roll(s, 1, 0) + np.roll(s, -1, 0) + np.roll(s, 1, 1) +
                  np.roll(s, -1, 1)) / 4
        r = 0.9 * s + 0.1 * smooth + rng.normal(0, 1.5 * (hi / 255), s.shape)
        pad = ((0, 16), (0, 16))
        src.append(np.pad(np.clip(np.round(s), 0, hi), pad, mode="edge")
                   .astype(np.uint8 if bd == 8 else np.uint16))
        rec.append(np.pad(np.clip(np.round(r), 0, hi), pad, mode="edge")
                   .astype(np.uint16))
    return src, rec


def _jax_packed(dims, bd, src, rec):
    """The JAX package's jitted search program on the same planes."""
    import jax.numpy as jnp
    ref = ref_lr.DeviceLrSearch(dims, bd)
    args = [jnp.asarray(np.ascontiguousarray(p[:ph, :pw]))
            for planes in (rec, src) for p, (pw, ph) in zip(planes, dims)]
    return ref, np.asarray(ref._fn(*args))


def _split(buf, grids):
    """Per plane: (taps vt + ht (6,), sse_none, sse_wiener)."""
    out, off = [], 0
    for urows, ucols, _, _ in grids:
        n = urows * ucols
        out.append((buf[off:off + 6], buf[off + 6:off + 6 + n],
                    buf[off + 6 + n:off + 6 + 2 * n]))
        off += 6 + 2 * n
    assert off == buf.size
    return out


def _same_decision(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (a.lr_type == b.lr_type and a.units == b.units and
            a.ucols == b.ucols and a.urows == b.urows and
            all((x is None and y is None) or np.array_equal(x, y)
                for x, y in zip(a.flat, b.flat)))


@pytest.mark.parametrize("content", ["flat", "noise", "edges"])
@pytest.mark.parametrize("dims", [(176, 144), (352, 288)])
@pytest.mark.parametrize("bd", [8, 10])
def test_lr_program_matches_jax(bd, dims, content):
    w, h = dims
    src, rec = _planes(content, w, h, bd)
    ref, want = _jax_packed(_dims(w, h), bd, src, rec)
    port = port_lr.DeviceLrSearch(_dims(w, h), bd, device="cpu")
    tok = port.dispatch(src, rec)
    got = np.asarray(tok)
    assert got.dtype == np.float32 and got.shape == want.shape
    n_diff = 0
    for (tg, ng, wg), (tw, nw, ww) in zip(_split(got, port.grids),
                                          _split(want, port.grids)):
        assert np.abs(tg - tw).max() <= 1
        n_diff += int((tg != tw).sum())
        np.testing.assert_allclose(ng, nw, rtol=SSE_RTOL)
        if np.array_equal(tg, tw):
            np.testing.assert_allclose(wg, ww, rtol=SSE_RTOL)
    print(f"taps differing from JAX: {n_diff} of 18")
    assert _same_decision(port.finish(tok, RDMULT), ref.finish(want, RDMULT))


def test_lr_upload_copies_the_recon():
    """dispatch is followed at once by the in-place LR apply on the same
    recon buffer: the uploaded plane must own its bytes."""
    rec = np.arange(64 * 80, dtype=np.uint16).reshape(64, 80) % 1024
    t = port_lr._upload(rec[:48, :64], torch.device("cpu"))
    before = t.clone()
    rec[:] = 0
    assert torch.equal(t, before) and t.dtype == torch.int16


def _frames(w, h, n, seed=7):
    rng = np.random.default_rng(seed)
    return [make_frame(w, h, t, 8, 0.02, rng) for t in range(n)]


def _encode(enc, frames, ra):
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


PRESET6 = {
    "LD": EncoderConfig(enc_mode=6, qp=30, intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_B),
    "RA-tf0": EncoderConfig(enc_mode=6, qp=30, intra_period_length=-1,
                            hierarchical_levels=2, enable_tf=0),
    "RA-tf1": EncoderConfig(enc_mode=6, qp=30, intra_period_length=-1,
                            hierarchical_levels=2, enable_tf=1,
                            tf_strength=3),
}


@pytest.fixture
def lr_decisions(monkeypatch):
    """The LR decisions the port's encoder takes, in order."""
    out = []
    orig = port_lr.DeviceLrSearch.finish

    def spy(self, token, rdmult):
        out.append(orig(self, token, rdmult))
        return out[-1]

    monkeypatch.setattr(port_lr.DeviceLrSearch, "finish", spy)
    return out


@pytest.mark.parametrize("dims, n", [((176, 144), 6), ((352, 288), 9)],
                         ids=["qcif", "cif"])
@pytest.mark.parametrize("name", list(PRESET6))
def test_preset6_encode_matches_jax(lr_decisions, name, dims, n):
    """Preset 6 turns LR on: the port's stream equals the JAX package's
    byte for byte, signals Wiener LR on some frames, and decodes
    dav1d-exactly to its own recon."""
    w, h = dims
    cfg, ra = PRESET6[name], name.startswith("RA")
    frames = _frames(w, h, n)
    want = _encode(ref_api.Encoder(ref_cfg(cfg), w, h), frames, ra)
    enc = Encoder(cfg, w, h, device="cpu")
    assert enc._enc.enable_lr
    got = _encode(enc, frames, ra)
    assert [o[:2] for o in got] == [o[:2] for o in want]
    assert any(d is not None for d in lr_decisions)
    shown = [(i, rec) for _, i, rec in got if i >= 0]
    assert [i for i, _ in shown] == list(range(n))
    decoded = decode_obus(b"".join(p for p, _, _ in got))
    assert len(decoded) == n
    for d, (_, rec) in zip(decoded, shown):
        for plane, r in zip((d.y, d.u, d.v), rec):
            assert np.array_equal(plane, r)


def test_lr_apply_and_search_copy_has_not_drifted():
    """The reference's _lr_apply_and_search is the LR step of the port's
    filter stage (models/frame_tail.py _filter_planes: the search for the
    next frame dispatched on the post-CDEF planes, then this frame's
    parameters applied from the pre-CDEF copy). On the same recon and
    sources both take the same decision, apply it to the same planes, and
    leave the same decision pending."""
    w, h, q = 176, 144, 120
    src, rec = _planes("noise", w, h, 8)
    port = port_fi.FastIntraEncoder(w, h, qindex=q, device="cpu")
    ref = ref_fi.FastIntraEncoder(w, h, qindex=q)
    port.enable_lr, port.enable_dlf, port.enable_cdef = True, False, False
    for e in (port, ref):
        for buf, p in zip((e._rec_y, e._rec_u, e._rec_v), rec):
            buf[:p.shape[0], :p.shape[1]] = p

    def lr_step(lr_dec_port, lr_dec_ref):
        port._filter_planes(
            (port._rec_y, port._rec_u, port._rec_v),
            (port._lf_y, port._lf_uv, port._lf_uv), port._skip_map, src, q,
            None, None, lr_dec_port, port._cdef_route, inline=True)
        pre = (ref._rec_y.copy(), ref._rec_u.copy(), ref._rec_v.copy())
        ref._lr_apply_and_search(*src, q, lr_dec_ref, pre)
        return port._take_lr_pending(), ref._take_lr_pending()

    got, want = lr_step(None, None)
    assert got is not None and _same_decision(got, want)
    got, want = lr_step(got, want)
    assert _same_decision(got, want)
    for a, b in zip((port._rec_y, port._rec_u, port._rec_v),
                    (ref._rec_y, ref._rec_u, ref._rec_v)):
        assert np.array_equal(a, b)
    assert not np.array_equal(port._rec_y[:h, :w], rec[0][:h, :w])


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(352, 288), (1920, 1080)])
def test_lr_program_cuda_matches_cpu(dims):
    """cuda vs cpu: taps within 1, decisions equal where taps match."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, h = dims
    src, rec = _planes("noise", w, h, 8)
    cpu = port_lr.DeviceLrSearch(_dims(w, h), 8, device="cpu")
    cuda = port_lr.DeviceLrSearch(_dims(w, h), 8, device="cuda")
    a, b = cpu.dispatch(src, rec), cuda.dispatch(src, rec)
    for (ta, _, _), (tb_, _, _) in zip(_split(np.asarray(a), cpu.grids),
                                       _split(np.asarray(b), cpu.grids)):
        assert np.abs(ta - tb_).max() <= 1
    taps = [t for t, _, _ in _split(np.asarray(a), cpu.grids)]
    if all(np.array_equal(t, u) for t, (u, _, _) in
           zip(taps, _split(np.asarray(b), cpu.grids))):
        assert _same_decision(cpu.finish(a, RDMULT), cuda.finish(b, RDMULT))
