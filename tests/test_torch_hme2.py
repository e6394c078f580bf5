"""Two-level motion search parity: the port's hme_search2 and hme_sad_tree
against the JAX package's, byte for byte.

Inputs come from numpy seeds: shifted-plus-noise pairs (the pattern of
test_fast_path.test_pallas_hme_matches), scroll/wrap content whose
bands move against each other so that blocks take a global candidate,
noise pairs whose votes tie, and flat pairs where every offset ties (the
first offset in scan order must win). SVT_HME_GLOBK is pinned to 4 and 0.
The CUDA tests need a card and skip without one.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import svt_av1_psy_tpu.models.fast_intra as ref_fi
from svt_av1_psy_tpu import api as ref_api
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
from svt_av1_psy_tpu_torch.ops import torch_backend as tb
from test_torch_standalone import ref_cfg

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
from make_test_clip import make_frame  # noqa: E402

KINDS = ["shifted", "scroll", "random", "flat"]
DIMS = [(144, 176), (288, 352)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["4", "0"], ids=["globk4", "globk0"])
def globk(request, monkeypatch):
    """SVT_HME_GLOBK for both packages; the JAX LD route caches its trace,
    so clear it before and after."""
    monkeypatch.setenv("SVT_HME_GLOBK", request.param)
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL"):
        monkeypatch.delenv(name, raising=False)
    ref_fi._jitted_hme.cache_clear()
    yield int(request.param)
    ref_fi._jitted_hme.cache_clear()


def pair(kind, h, w, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "flat":
        src = np.full((h, w), 77, np.uint8)
        return src, src.copy()
    src = rng.integers(0, 255, (h, w)).astype(np.uint8)
    if kind == "random":
        return src, rng.integers(0, 255, (h, w)).astype(np.uint8)
    if kind == "shifted":
        ref = np.roll(src, (6, -10), (0, 1))
    else:
        # scroll/wrap: the top half pans right with wrap-around, the
        # bottom half moves up and left, so the frame has several
        # dominant motions and blocks take global candidates
        ref = src.copy()
        ref[:h // 2] = np.roll(src[:h // 2], 40, 1)
        ref[h // 2:] = np.roll(src[h // 2:], (-20, 12), (0, 1))
    ref = np.clip(ref.astype(np.int16) + rng.integers(-6, 7, ref.shape),
                  0, 255).astype(np.uint8)
    return src, ref


def _jax_hme2(src, ref):
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops.jax_backend import hme_search2
    return tuple(np.asarray(x) for x in
                 jax.device_get(hme_search2(jnp.asarray(src),
                                            jnp.asarray(ref))))


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{d[1]}x{d[0]}")
@pytest.mark.parametrize("kind", KINDS)
def test_hme_search2_matches_jax(globk, kind, dims):
    src, ref = pair(kind, *dims)
    mv, sad = tb.hme_search2(torch.from_numpy(src), torch.from_numpy(ref))
    jmv, jsad = _jax_hme2(src, ref)
    assert mv.dtype == torch.int16 and sad.dtype == torch.int32
    assert jmv.dtype == np.int16
    assert np.array_equal(mv.numpy(), jmv)
    assert np.array_equal(sad.numpy(), jsad)
    if kind == "flat":
        # every level-0 and level-1 offset ties: the first wins
        assert (mv.numpy() == 2 * (2 * -16 - 7)).all()


def test_global_candidates_change_scroll_result(monkeypatch):
    """The scroll pair is a case where the global refine decides blocks:
    K_GLOB 4 and 0 give different fields (both held to JAX above)."""
    s, r = (torch.from_numpy(x) for x in pair("scroll", 288, 352))
    monkeypatch.setenv("SVT_HME_GLOBK", "4")
    mv4, sad4 = tb.hme_search2(s, r)
    monkeypatch.setenv("SVT_HME_GLOBK", "0")
    mv0, sad0 = tb.hme_search2(s, r)
    assert not torch.equal(mv4, mv0)
    assert (sad4 <= sad0).all() and (sad4 < sad0).any()


def test_hme_search2_batch_equals_single():
    pairs = [pair(k, 192, 256, seed=i) for i, k in enumerate(KINDS)]
    src = torch.from_numpy(np.stack([p[0] for p in pairs]))
    ref = torch.from_numpy(np.stack([p[1] for p in pairs]))
    mv, sad = tb.hme_search2(src, ref)
    s32, s64 = tb.hme_sad_tree(src, ref, mv)
    for i in range(len(pairs)):
        one = tb.hme_search2(src[i], ref[i])
        assert torch.equal(mv[i], one[0]) and torch.equal(sad[i], one[1])
        tree = tb.hme_sad_tree(src[i], ref[i], one[0])
        assert torch.equal(s32[i], tree[0]) and torch.equal(s64[i], tree[1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dims", [(192, 256), (320, 384)],
                         ids=lambda d: f"{d[1]}x{d[0]}")
def test_hme_sad_tree_matches_jax(kind, dims):
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops.jax_backend import hme_sad_tree
    src, ref = pair(kind, *dims)
    mv, _ = tb.hme_search2(torch.from_numpy(src), torch.from_numpy(ref))
    s32, s64 = tb.hme_sad_tree(torch.from_numpy(src), torch.from_numpy(ref),
                               mv)
    j32, j64 = jax.device_get(hme_sad_tree(jnp.asarray(src),
                                           jnp.asarray(ref),
                                           jnp.asarray(mv.numpy())))
    assert s32.dtype == torch.int32 and s64.dtype == torch.int32
    assert np.array_equal(s32.numpy(), np.asarray(j32))
    assert np.array_equal(s64.numpy(), np.asarray(j64))


def _tied_tree_input(h=256, w=256, seed=4):
    """src = ref = a pattern with a period of 16 full-res pixels, and a
    per-16x16 MV field of multiples of 16: every child MV whose window
    stays off the edge padding scores SAD 0, so children tie and the tie
    rule picks the MV that the next level evaluates."""
    rng = np.random.default_rng(seed)
    tile = rng.integers(0, 255, (16, 16)).astype(np.uint8)
    src = np.tile(tile, (h // 16, w // 16))
    mv = (16 * rng.integers(-3, 4, (h // 16, w // 16, 2))).astype(np.int16)
    return src, src.copy(), mv


def test_hme_sad_tree_ties_match_jax():
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops.jax_backend import hme_sad_tree
    src, ref, mv = _tied_tree_input()
    got = tb.hme_sad_tree(torch.from_numpy(src), torch.from_numpy(ref),
                          torch.from_numpy(mv))
    want = jax.device_get(hme_sad_tree(jnp.asarray(src), jnp.asarray(ref),
                                       jnp.asarray(mv)))
    for g, j in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(j))


def test_default_route_encode_matches_jax(globk):
    """Low delay at 352x288 on the default route at K_GLOB 4 and 0: the
    JAX package's payload bytes."""
    w, h = 352, 288
    rng = np.random.default_rng(11)
    frames = [make_frame(w, h, t, 8, 0.02, rng) for t in range(3)]
    cfg = EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_B)
    out = []
    for enc in (ref_api.Encoder(ref_cfg(cfg), w, h),
                Encoder(cfg, w, h, device="cpu")):
        try:
            out.append([enc.encode(*f).payload for f in frames])
        finally:
            enc.close()
    assert out[0] == out[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_matches_cpu(cuda_device, kind):
    src, ref = pair(kind, 1088, 1920)
    s, r = torch.from_numpy(src), torch.from_numpy(ref)
    mv, sad = tb.hme_search2(s, r)
    s32, s64 = tb.hme_sad_tree(s, r, mv)
    sc, rc = s.to(cuda_device), r.to(cuda_device)
    cmv, csad = tb.hme_search2(sc, rc)
    c32, c64 = tb.hme_sad_tree(sc, rc, cmv)
    for a, b in ((mv, cmv), (sad, csad), (s32, c32), (s64, c64)):
        assert torch.equal(a, b.cpu())
