"""The frozen reference (benchmark/reference/programs.py) against the
port's own programs on the CPU at small sizes: equal entry for entry
(the float programs too, in float32: the same operations in the same
order on the same device), and the float programs in float64, as the
checks run them, within the bounds the configurations state."""

import numpy as np
import pytest
import torch

import harness

P = harness.reference()


def _planes(seed, n, h=144, w=176):
    from svt_av1_psy_tpu_torch.utils.test_clip import make_frame
    rng = np.random.default_rng(seed)
    return [make_frame(w, h, t, 8, 0.02, rng) for t in range(n)]


def _pad(a, h, w):
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])),
                  mode="edge")


@pytest.fixture(scope="module")
def frames():
    return _planes(5, 6)


def test_spec_tables_equal_the_ports():
    from svt_av1_psy_tpu_torch.constants import tables
    from svt_av1_psy_tpu_torch.ops import intra
    assert np.array_equal(P._DR_DERIV, tables()["dr_intra_derivative"])
    for k, v in intra._SM_WEIGHTS.items():
        assert np.array_equal(P._SM_WEIGHTS[k], v)


def test_decide_and_single_level_search(frames):
    from svt_av1_psy_tpu_torch.ops import torch_backend as tb
    a = torch.from_numpy(_pad(frames[3][0], 192, 192)).to(torch.int32)
    b = torch.from_numpy(_pad(frames[2][0], 192, 192)).to(torch.int32)
    assert torch.equal(P.intra_decide_packed(a, 400),
                       tb.intra_decide_packed(a, 400))
    for r in (0, 4, 12):
        for x, y in zip(P.hme_search(a, b, r), tb.hme_search(a, b, r)):
            assert torch.equal(x, y)


def test_gop_program(frames):
    from svt_av1_psy_tpu_torch.ops import torch_backend as tb
    F_ = 5
    stack = torch.stack([torch.from_numpy(_pad(f[0], 192, 192))
                         for f in frames[:F_]]).to(torch.int32)
    edges = np.array([[1, 0], [2, 0], [2, 1], [3, 2], [4, 1], [0, 0]],
                     np.int32)
    T = 5
    win_idx = np.array([2, 3, 4, 0, 1], np.int32)
    mask = torch.tensor([1, 1, 0, 1, 1], dtype=torch.float32)
    cu = torch.stack([torch.from_numpy(_pad(f[1], 96, 96))
                      for f in frames[:T]]).to(torch.int32)
    cv = torch.stack([torch.from_numpy(_pad(f[2], 96, 96))
                      for f in frames[:T]]).to(torch.int32)
    buf = tb.gop_search_tf(stack, edges, 300, cu, cv, win_idx, mask, 1.0,
                           8, 8, cu, cv, win_idx[::-1].copy(), mask)
    mv, sad, s32, s64, dec, filt = tb.gop_search_tf_unpack(
        buf.numpy(), F_, len(edges), (192, 192), 8, n_filtered=2)
    fy, fu, fv = P.tf_filter_device(stack[torch.as_tensor(win_idx).long()],
                                    cu, cv, mask, 1.0, 8)
    for x, y in zip((fy, fu, fv), filt[0]):
        assert np.array_equal(x.numpy(), y)
    # float64: within 1 on at most 0.1% of the pixels
    off, n = 0, 0
    for x, y in zip(P.tf_filter_device(
            stack[torch.as_tensor(win_idx).long()], cu, cv, mask, 1.0, 8,
            torch.float64), filt[0]):
        d = np.abs(x.numpy().astype(np.int64) - y.astype(np.int64))
        assert d.max() <= 1
        off, n = off + int((d > 0).sum()), n + d.size
    assert off <= 0.001 * n
    frames_f = stack.clone()
    frames_f[1] = torch.from_numpy(filt[0][0].astype(np.int32))
    frames_f[2] = torch.from_numpy(filt[1][0].astype(np.int32))
    ref = P.gop_search(frames_f, edges, 300, 8, 8)
    for x, y in zip(ref[:4], (mv, sad, s32, s64)):
        assert np.array_equal(x.numpy().astype(np.int64),
                              np.asarray(y, np.int64))
    assert np.array_equal(ref[4].numpy(), dec)


def test_lr_search(frames):
    from svt_av1_psy_tpu_torch.models.lr_search import DeviceLrSearch
    h, w = 144, 176
    dims = [(w, h), (w // 2, h // 2), (w // 2, h // 2)]
    src, rec = frames[4], frames[3]
    lr = DeviceLrSearch(dims, 8, device="cpu")
    planes6 = [torch.from_numpy(np.ascontiguousarray(p))
               for p in (*rec, *src)]
    got = lr._fn(*planes6)
    assert torch.equal(P.lr_search(planes6, dims, 8), got)
    # float64: the taps within 1
    ref = P.lr_search(planes6, dims, 8, f32=torch.float64)
    assert ref.dtype == torch.float64
    taps = [slice(o, o + 6) for o in _tap_offsets(dims)]
    for t in taps:
        assert (ref[t] - got[t].double()).abs().max() <= 1


def _tap_offsets(dims, unit_size=(64, 32, 32)):
    out, off = [], 0
    for plane, (pw, ph) in enumerate(dims):
        r, c, _, _ = P.lr_unit_grid(pw, ph, unit_size[plane],
                                    8 >> (1 if plane else 0))
        out.append(off)
        off += 6 + 2 * r * c
    return out


def test_tpl_offsets(frames, monkeypatch):
    from svt_av1_psy_tpu_torch.models import tpl
    monkeypatch.setenv("SVT_HME_PALLAS", "1")
    cur, fut = frames[0][0], [f[0] for f in frames[1:4]]
    want = tpl.tpl_sb_offsets(cur, fut, device="cpu")
    assert np.array_equal(P.tpl_sb_offsets(cur, fut, torch.device("cpu")),
                          want)
