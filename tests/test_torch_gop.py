"""The GoP program and the temporal filter: the port against the JAX
package on the same planes, made from numpy seeds.

gop_search's packed buffer must be equal byte for byte, padding edges
included. The temporal filter is float32 (variance, exp, divide, rint):
XLA on the CPU contracts a multiply and an add into one fused
multiply-add, its exp differs from PyTorch's in the last bit for some
inputs, and its float32 sums run in another order, so a pixel whose
weighted mean lies within rounding of x.5 can round the other way. The
filtered planes must therefore be within TF_MAX_DIFF of the reference on
at most TF_MAX_SHARE of their pixels; gop_search_tf's integer part must
equal the JAX gop_search run on the stack that holds the port's filtered
planes. The CUDA tests need a card and skip without one.
"""

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch.ops import torch_backend as tb
from svt_av1_psy_tpu_torch.utils.device import HostCopy

TF_MAX_DIFF = 1
TF_MAX_SHARE = 1e-3

H, W = 192, 256
# (src, ref) stack indices, as RaDriver._dispatch_gop builds them; the
# (0, 0) rows are its padding edges
EDGES = np.array([[1, 0], [2, 0], [2, 1], [3, 2], [4, 3], [3, 1], [4, 1],
                  [2, 4], [1, 1], [0, 0], [0, 0]], np.int32)
BIAS = 700


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clip(n, h, w, bd, seed=9):
    """n frames of smoothed noise panning by (1, 3) px a frame, plus
    sensor noise; chroma is noise around mid-grey."""
    rng = np.random.default_rng(seed)
    hi = (1 << bd) - 1
    base = rng.integers(0, hi, (h, w)).astype(np.float64)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    dt = np.uint8 if bd == 8 else np.uint16
    ys, us, vs = [], [], []
    for i in range(n):
        ys.append(np.clip(np.roll(base, (i, 3 * i), (0, 1)) +
                          rng.normal(0, 3 << (bd - 8), (h, w)), 0, hi))
        for planes in (us, vs):
            planes.append(np.clip(rng.normal(1 << (bd - 1), 4 << (bd - 8),
                                             (h // 2, w // 2)), 0, hi))
    return tuple(np.stack(p).astype(dt) for p in (ys, us, vs))


def _t(a):
    return tb.plane_tensor(a, torch.device("cpu"))


def tf_gap(want, got):
    """(pixels that differ, largest difference) of two planes."""
    d = np.abs(np.asarray(want).astype(np.int64) - np.asarray(got))
    return int((d > 0).sum()), int(d.max())


def assert_tf_close(want, got):
    n, mx = tf_gap(want, got)
    assert mx <= TF_MAX_DIFF and n <= TF_MAX_SHARE * np.asarray(want).size, \
        (n, mx)


@pytest.mark.parametrize("bd", [8, 10])
def test_gop_search_matches_jax(bd):
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops import jax_backend as jb
    y, _, _ = clip(5, H, W, bd)
    want = np.asarray(jax.jit(jb.gop_search, static_argnums=(3, 4))(
        jnp.asarray(y), jnp.asarray(EDGES), jnp.asarray(np.int32(BIAS)),
        bd, 8))
    got = tb.gop_search(_t(y), EDGES, BIAS, bd, 8)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    parts = tb.gop_search_unpack(got.numpy(), 5, len(EDGES), (H, W))
    for a, b in zip(parts, jb.gop_search_unpack(want, 5, len(EDGES),
                                                (H, W))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("strength", [1.0, 3.0])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("dims", [(192, 192), (320, 384)],
                         ids=lambda d: f"{d[1]}x{d[0]}")
def test_tf_filter_device_within_bound(bd, strength, dims):
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops.jax_backend import tf_filter_device
    y, u, v = clip(5, *dims, bd, seed=5)
    mask = np.array([1, 1, 0, 1, 1], np.float32)      # slot 2 is padding
    want = jax.device_get(jax.jit(tf_filter_device, static_argnums=(5,))(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(np.float32(strength)), bd))
    got = tb.tf_filter_device(_t(y), _t(u), _t(v), torch.from_numpy(mask),
                              strength, bd)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert_tf_close(w, g.numpy())


def test_tf_align_matches_jax():
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops.jax_backend import _tf_align
    y, u, _ = clip(2, H, W, 8)
    rng = np.random.default_rng(1)
    # reaches past the padding so the MV clamp is exercised
    mv = rng.integers(-120, 121, (H // 16, W // 16, 2)).astype(np.int32)
    for sub, planes in ((0, y), (1, u)):
        c, n = planes.astype(np.int32)
        out, err = tb._tf_align(torch.from_numpy(c), torch.from_numpy(n),
                                torch.from_numpy(mv), sub)
        jout, jerr = jax.device_get(_tf_align(jnp.asarray(c), jnp.asarray(n),
                                              jnp.asarray(mv), sub))
        assert np.array_equal(out.numpy(), np.asarray(jout))
        assert err.dtype == torch.float32
        assert np.array_equal(err.numpy(), np.asarray(jerr))


@pytest.mark.parametrize("bd", [8, 10])
def test_gop_search_tf_matches_jax(bd):
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops import jax_backend as jb
    y, u, v = clip(5, H, W, bd)
    # ARF (stack 1) filtered against 2, 3, 4 (slot 0 masked out); the mid
    # anchor (stack 2) against 0, 1, 3 (slot 3 masked out)
    win = np.array([0, 2, 3, 4, 1]), np.array([0, 1, 1, 1, 1], np.float32)
    win2 = np.array([0, 1, 3, 0, 2]), np.array([1, 1, 1, 0, 1], np.float32)
    args = [y, EDGES, np.int32(BIAS), u[win[0]], v[win[0]],
            win[0].astype(np.int32), win[1], np.float32(1.0), bd, 8,
            u[win2[0]], v[win2[0]], win2[0].astype(np.int32), win2[1]]
    want = np.asarray(jax.jit(jb.gop_search_tf, static_argnums=(8, 9))(
        *[a if isinstance(a, int) else jnp.asarray(a) for a in args]))
    got = tb.gop_search_tf(
        _t(y), EDGES, BIAS, _t(args[3]), _t(args[4]), args[5],
        torch.from_numpy(args[6]), 1.0, bd, 8, _t(args[10]), _t(args[11]),
        args[12], torch.from_numpy(args[13])).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    parts = tb.gop_search_tf_unpack(got, 5, len(EDGES), (H, W), bd, 2)
    jparts = jb.gop_search_tf_unpack(want, 5, len(EDGES), (H, W), bd, 2)
    for (fy, fu, fv), jplanes in zip(parts[5], jparts[5]):
        assert fy.dtype == (np.uint8 if bd == 8 else np.uint16)
        for a, b in zip((fy, fu, fv), jplanes):
            assert_tf_close(b, a)
    # the integer part is gop_search over the stack holding the filtered
    # anchors (the port's own, so that TF rounding cannot leak in)
    stack = y.copy()
    stack[1], stack[2] = parts[5][0][0], parts[5][1][0]
    ref = np.asarray(jax.jit(jb.gop_search, static_argnums=(3, 4))(
        jnp.asarray(stack), jnp.asarray(EDGES),
        jnp.asarray(np.int32(BIAS)), bd, 8))
    assert np.array_equal(got[:ref.size], ref)


def test_host_copy_on_cpu():
    t = torch.arange(6, dtype=torch.int32)
    c = HostCopy(t)
    assert np.array_equal(c.numpy(), np.arange(6))
    assert np.asarray(c).dtype == np.int32
    assert np.asarray(c, dtype=np.int64).dtype == np.int64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_gop_search_matches_cpu(cuda_device):
    y, u, v = clip(5, H, W, 8)
    cpu = tb.gop_search(_t(y), EDGES, BIAS, 8, 8)
    dev = tb.gop_search(tb.plane_tensor(y, cuda_device), EDGES, BIAS, 8, 8)
    copy = HostCopy(dev)
    assert np.array_equal(copy.numpy(), cpu.numpy())
    mask = torch.ones(5)
    want = tb.tf_filter_device(_t(y), _t(u), _t(v), mask, 1.0, 8)
    got = tb.tf_filter_device(*(tb.plane_tensor(p, cuda_device)
                                for p in (y, u, v)), mask, 1.0, 8)
    for w, g in zip(want, got):
        assert_tf_close(w.numpy(), g.cpu().numpy())
