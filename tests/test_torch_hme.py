"""K1 parity: the port's full-pel SAD-scan ME against the JAX package.

The plain PyTorch hme_search must equal jax_backend.hme_search and the
Pallas kernel hme_search_pallas (interpret mode) byte for byte; the CUDA
kernel must equal the plain version (those tests need a card and skip
without one). JAX is imported inside the tests that compare with it, so
that the CUDA tests of this file also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_hme.py``.
"""

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch.kernels.hme import hme_search_kernel
from svt_av1_psy_tpu_torch.ops import torch_backend as tb

R = 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(kind, h=144, w=176, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "flat":
        # every offset ties: the first one, (-R, -R), must win
        src = np.full((h, w), 77, np.uint8)
        return src, src.copy()
    src = rng.integers(0, 255, (h, w)).astype(np.uint8)
    if kind == "random":
        return src, rng.integers(0, 255, (h, w)).astype(np.uint8)
    # shifted + noisy reference so argmins are nontrivial
    # (the input pattern of test_fast_path.test_pallas_hme_matches)
    ref = np.roll(src, (6, -10), (0, 1))
    ref = np.clip(ref.astype(np.int16) + rng.integers(-6, 7, ref.shape),
                  0, 255).astype(np.uint8)
    return src, ref


def _jax_outputs(src, ref):
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops.jax_backend import hme_search, hme_search_pallas
    s, r = jnp.asarray(src), jnp.asarray(ref)
    out = {"hme_search": hme_search(s, r),
           "hme_search_pallas": hme_search_pallas(s, r, interpret=True)}
    return {k: tuple(np.asarray(x) for x in jax.device_get(v))
            for k, v in out.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", ["shifted", "flat"])
def test_hme_search_matches_jax(kind):
    src, ref = _pair(kind)
    mv, sad = tb.hme_search(torch.from_numpy(src), torch.from_numpy(ref))
    assert mv.dtype == torch.int16 and sad.dtype == torch.int32
    for name, (jmv, jsad) in _jax_outputs(src, ref).items():
        assert jmv.dtype == np.int16, name
        assert np.array_equal(mv.numpy(), jmv), name
        assert np.array_equal(sad.numpy(), jsad), name
    if kind == "flat":
        assert (mv.numpy() == -2 * R).all() and (sad.numpy() == 0).all()


def test_pack_unpack_match_jax():
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops import jax_backend as jb
    rng = np.random.default_rng(5)
    mv = rng.integers(-48, 49, (4, 6, 2)).astype(np.int16)
    sad = rng.integers(0, 1 << 16, (4, 6)).astype(np.int32)
    buf = tb.pack_mv_sad(torch.from_numpy(mv), torch.from_numpy(sad))
    jbuf = np.asarray(jb.pack_mv_sad(jnp.asarray(mv), jnp.asarray(sad)))
    assert buf.dtype == torch.int32
    assert np.array_equal(buf.numpy(), jbuf)
    for a, b in zip(tb.hme2_unpack(jbuf, 4, 6), jb.hme2_unpack(jbuf, 4, 6)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(tb.hme2_unpack(jbuf, 4, 6)[0], mv)


def test_kernel_wrapper_runs_plain_on_cpu():
    src, ref = _pair("shifted")
    s, r = torch.from_numpy(src), torch.from_numpy(ref)
    before = hme_search_kernel.launches
    got = hme_search_kernel(s, r)
    want = tb.hme_search(s, r)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert hme_search_kernel.launches == before


def test_kernel_wrapper_refuses_other_devices():
    meta = torch.empty((32, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        hme_search_kernel(meta, meta)
    with pytest.raises(ValueError):
        hme_search_kernel(meta, torch.zeros((32, 32), dtype=torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["shifted", "flat", "random"])
@pytest.mark.parametrize("dims", [(144, 176), (1088, 1920)])
def test_kernel_matches_plain(cuda_device, kind, dims):
    src, ref = _pair(kind, *dims)
    s = torch.from_numpy(src).to(cuda_device)
    r = torch.from_numpy(ref).to(cuda_device)
    before = hme_search_kernel.launches
    mv, sad = hme_search_kernel(s, r)
    torch.cuda.synchronize()
    assert hme_search_kernel.launches == before + 1
    pmv, psad = tb.hme_search(s, r)
    assert mv.dtype == torch.int16 and sad.dtype == torch.int32
    assert torch.equal(mv, pmv) and torch.equal(sad, psad)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    s = torch.zeros((40, 48), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        hme_search_kernel(s, s)                       # H not a multiple of 16
    s = torch.zeros((48, 48), dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):
        hme_search_kernel(s, s)
    s = torch.zeros((48, 48), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        hme_search_kernel(s, s.cpu())
