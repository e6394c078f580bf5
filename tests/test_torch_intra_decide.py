"""Intra decision parity: the port's PyTorch programs against the JAX
package's, byte for byte (all integer math), on the same numpy planes.

JAX is imported inside the helpers, so that the CUDA test of this file
also runs where JAX is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_intra_decide.py``).
"""

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch.ops import torch_backend as tb

CPU = torch.device("cpu")
BIAS = 700


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


def _jb():
    from svt_av1_psy_tpu.ops import jax_backend
    return jax_backend


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


CASES = [(c, d, bd) for c in ("flat", "noise", "edges")
         for d in ((128, 192), (64, 64)) for bd in (8, 10)]


@pytest.mark.parametrize("content,dims,bd", CASES)
def test_edges_and_predictors_match_jax(content, dims, bd):
    import jax
    import jax.numpy as jnp
    jb = _jb()
    # jit: one XLA compile per shape instead of one per eager op
    gather = jax.jit(jb._gather_sb_edges, static_argnums=(1, 2, 3))
    modes = jax.jit(jb.predict_modes_batch, static_argnums=(5, 6, 7))
    directional = jax.jit(jb.predict_directional_batch,
                          static_argnums=(3, 4))
    p = _plane(content, *dims, bd)
    tp = tb.plane_tensor(p, CPU)
    for s in (64, 32, 16, 8):
        want = [_np(x) for x in gather(jnp.asarray(p.astype(np.int32)), s,
                                       bd, True)]
        got = tb._gather_sb_edges(tp, s, bd, ext=True)
        _assert_same(got, want)
        a, l, c0, da, dl, a2, l2 = want
        _assert_same([tb.predict_modes_batch(
            *(torch.from_numpy(x.copy()) for x in (a, l, c0, da, dl)),
            s, s, bd)], [modes(a, l, c0, da, dl, s, s, bd)])
        _assert_same([tb.predict_directional_batch(
            *(torch.from_numpy(x.copy()) for x in (a2, l2, c0)), s, bd)],
            [directional(a2, l2, c0, s, bd)])


@pytest.mark.parametrize("min_block", [8, 16])
@pytest.mark.parametrize("content,dims,bd", CASES)
def test_intra_decide_packed_matches_jax(content, dims, bd, min_block):
    import jax.numpy as jnp

    from svt_av1_psy_tpu.models.fast_intra import _jitted_decide
    p = _plane(content, *dims, bd)
    # the JAX package's own jitted intra_decide_packed
    want = np.asarray(_jitted_decide()(jnp.asarray(p), jnp.int32(BIAS), bd,
                                       min_block))
    got = tb.intra_decide_packed(tb.plane_tensor(p, CPU), BIAS, bd,
                                 min_block)
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    assert np.array_equal(got.numpy(), want)
    parts = tb.intra_decide_unpack(got.numpy(), dims)
    _assert_same(parts, _jb().intra_decide_unpack(want, dims))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(128, 192), (1088, 1920)])
def test_intra_decide_packed_cuda_matches_cpu(dims):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for content in ("noise", "edges"):
        p = _plane(content, *dims, 8)
        want = tb.intra_decide_packed(tb.plane_tensor(p, CPU), BIAS)
        got = tb.intra_decide_packed(
            tb.plane_tensor(p, torch.device("cuda")), BIAS)
        assert torch.equal(got.cpu(), want)
