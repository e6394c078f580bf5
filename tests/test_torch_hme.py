"""K1 parity: the port's full-pel SAD-scan ME against the JAX package.

The plain PyTorch hme_search must equal jax_backend.hme_search and the
Pallas kernel hme_search_pallas (interpret mode) byte for byte, at 8 and
10 bit and at more than one search range; the CUDA kernel must equal the
plain version (those tests need a card and skip without one). What the
kernel relies on is held here on the CPU: the half-resolution clamp that
replaces the edge pad, the launch geometry the wrapper computes, and a
numpy model of the kernel's walk (one shared window per tile, a rotating
set of eight row sums, the ordered key) against the plain version. JAX is
imported inside the tests that compare with it, so that the CUDA tests of
this file also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_hme.py``.
"""

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch.kernels.hme import (MAX_SMEM_BYTES, MAX_THREADS,
                                               hme_search_kernel,
                                               launch_geometry)
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


def _pair(kind, h=144, w=176, seed=3, bd=8):
    """(src, ref) planes: uint8 at bit depth 8, uint16 above."""
    rng = np.random.default_rng(seed)
    top = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    if kind == "flat":
        # every offset ties: the first one, (-R, -R), must win
        src = np.full((h, w), 77 << (bd - 8), dt)
        return src, src.copy()
    src = rng.integers(0, top, (h, w)).astype(dt)
    if kind == "random":
        return src, rng.integers(0, top, (h, w)).astype(dt)
    # shifted + noisy reference so argmins are nontrivial
    # (the input pattern of test_fast_path.test_pallas_hme_matches)
    ref = np.roll(src, (6, -10), (0, 1))
    noise = rng.integers(-6, 7, ref.shape) << (bd - 8)
    ref = np.clip(ref.astype(np.int32) + noise, 0, top).astype(dt)
    return src, ref


def _tensor(arr, device="cpu"):
    """A numpy plane as the port uploads it: uint8, or int16 for uint16."""
    return tb.pixel_tensor(arr, torch.device(device))


def _jax_outputs(src, ref, r=R):
    import jax
    import jax.numpy as jnp

    from svt_av1_psy_tpu.ops.jax_backend import hme_search, hme_search_pallas
    s, f = jnp.asarray(src), jnp.asarray(ref)
    out = {"hme_search": hme_search(s, f, r),
           "hme_search_pallas": hme_search_pallas(s, f, r, interpret=True)}
    return {k: tuple(np.asarray(x) for x in jax.device_get(v))
            for k, v in out.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("kind, bd, r", [
    ("shifted", 8, 12), ("flat", 8, 12), ("shifted", 10, 12),
    ("shifted", 8, 4), ("random", 10, 4)])
def test_hme_search_matches_jax(kind, bd, r):
    src, ref = _pair(kind, bd=bd)
    mv, sad = tb.hme_search(_tensor(src), _tensor(ref), r)
    assert mv.dtype == torch.int16 and sad.dtype == torch.int32
    for name, (jmv, jsad) in _jax_outputs(src, ref, r).items():
        assert jmv.dtype == np.int16, name
        assert np.array_equal(mv.numpy(), jmv), name
        assert np.array_equal(sad.numpy(), jsad), name
    if kind == "flat":
        assert (mv.numpy() == -2 * r).all() and (sad.numpy() == 0).all()


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


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("r", [4, 12])
def test_kernel_wrapper_runs_plain_on_cpu(dtype, r):
    src, ref = _pair("shifted", 48, 64, bd=8 if dtype == torch.uint8 else 10)
    s, f = _tensor(src).to(dtype), _tensor(ref).to(dtype)
    before = hme_search_kernel.launches
    got = hme_search_kernel(s, f, r)
    want = tb.hme_search(s, f, r)
    assert got[0].dtype == torch.int16 and got[1].dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert hme_search_kernel.launches == before


def _half_res(plane):
    p = plane.astype(np.int64)
    return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] +
            2) >> 2


@pytest.mark.parametrize("r", [0, 4, 12, 15])
@pytest.mark.parametrize("bd, dims", [(8, (48, 64)), (10, (48, 64)),
                                      (8, (144, 176))])
def test_edge_pad_is_a_half_res_clamp(bd, dims, r):
    """The kernel takes no padded plane: it reads the padded pixel (y, x)
    as the 2x2 mean at the clamped HALF-res coordinate. That is what
    hme_planes builds, for every (y, x); clamping the full-res rows and
    columns one by one is another plane."""
    src, ref = _pair("random", *dims, bd=bd)
    sh, rp = tb.hme_planes(_tensor(src), _tensor(ref), r)
    hh, wh = dims[0] // 2, dims[1] // 2
    assert sh.shape == (hh, wh) and rp.shape == (hh + 2 * r, wh + 2 * r)
    assert np.array_equal(sh.numpy(), _half_res(src))
    yc = np.clip(np.arange(-r, hh + r), 0, hh - 1)
    xc = np.clip(np.arange(-r, wh + r), 0, wh - 1)
    assert np.array_equal(rp.numpy(), _half_res(ref)[yc[:, None], xc[None]])
    if r:
        # full-res clamping averages a border row with itself
        fy = np.clip(np.arange(-2 * r, dims[0] + 2 * r), 0, dims[0] - 1)
        fx = np.clip(np.arange(-2 * r, dims[1] + 2 * r), 0, dims[1] - 1)
        assert not np.array_equal(rp.numpy(),
                                  _half_res(ref[fy[:, None], fx[None]]))


GEOMETRY_SIZES = [(16, 16), (16, 272), (80, 16), (48, 64), (144, 176),
                  (1088, 1920)]


@pytest.mark.parametrize("pixel_bytes", [1, 2])
@pytest.mark.parametrize("r", [0, 4, 12, 15])
@pytest.mark.parametrize("dims", GEOMETRY_SIZES)
def test_launch_geometry(dims, r, pixel_bytes):
    h, w = dims
    n16r, n16c = h // 16, w // 16
    geo = launch_geometry(h, w, r, pixel_bytes)
    rows, cols = geo.tile
    gx, gy = geo.grid
    win_h, win_w = geo.window
    seen = np.zeros((n16r, n16c), np.int64)
    for ty in range(gy):
        for tx in range(gx):
            oy, ox = geo.window_origin(ty, tx)
            by = np.arange(ty * rows, min((ty + 1) * rows, n16r))
            bx = np.arange(tx * cols, min((tx + 1) * cols, n16c))
            assert by.size and bx.size          # no CTA without a block
            seen[by[:, None], bx[None]] += 1
            # every offset of every block of the tile lies in its window,
            # and the window never reaches past the padded plane's range
            assert oy <= 8 * by[0] - r and 8 * by[-1] + 8 + r <= oy + win_h
            assert ox <= 8 * bx[0] - r and 8 * bx[-1] + 8 + r <= ox + win_w
            assert oy >= -r and ox >= -r
    assert (seen == 1).all()
    side = 2 * r + 1
    items = rows * cols * side
    threads = geo.threads
    assert threads % 32 == 0 and 32 <= threads <= MAX_THREADS
    # whole rounds of the threads cover the items with under a warp to
    # spare per round
    n_rounds = -(-items // threads)
    assert n_rounds * (threads - 32) < items
    per_word = 4 // pixel_bytes
    need = win_h * (-(-win_w // per_word) + 1) + \
        64 * rows * cols // per_word + rows * cols
    assert 4 * need <= geo.smem_bytes <= MAX_SMEM_BYTES < 232448


def _kernel_model(src, ref, r):
    """The CUDA kernel's walk in numpy, on the wrapper's geometry: per
    tile one window of clamped half-res means; per (block, dx) a walk down
    the 8 + 2r window rows with a rotating set of eight row sums; per
    block the minimum of sad << 10 | k. Returns (mv16, sad16)."""
    h, w = src.shape
    hh, wh = h // 2, w // 2
    n16r, n16c = h // 16, w // 16
    geo = launch_geometry(h, w, r, src.itemsize)
    rows, cols = geo.tile
    win_h, win_w = geo.window
    side = 2 * r + 1
    sh, rh = _half_res(src), _half_res(ref)
    mv = np.zeros((n16r, n16c, 2), np.int16)
    sad = np.zeros((n16r, n16c), np.int32)
    for ty in range(geo.grid[1]):
        for tx in range(geo.grid[0]):
            oy, ox = geo.window_origin(ty, tx)
            yc = np.clip(oy + np.arange(win_h), 0, hh - 1)
            xc = np.clip(ox + np.arange(win_w), 0, wh - 1)
            win = rh[yc[:, None], xc[None]]
            for lb in range(rows * cols):
                by, bx = ty * rows + lb // cols, tx * cols + lb % cols
                if by >= n16r or bx >= n16c:
                    continue
                blk = sh[8 * by:8 * by + 8, 8 * bx:8 * bx + 8]
                dxi = np.arange(side)
                col = (lb % cols) * 8 + dxi[:, None] + np.arange(8)[None]
                acc = np.zeros((8, side), np.int64)
                best = np.full(side, np.iinfo(np.int32).max, np.int64)
                for y in range(8 + 2 * r):
                    wrow = win[(lb // cols) * 8 + y][col]       # (side, 8)
                    acc += np.abs(blk[:, None, :] - wrow[None]).sum(-1)
                    dyi = y - 7
                    if dyi >= 0:
                        best = np.minimum(best, (acc[7] << 10) |
                                          (dyi * side + dxi))
                    acc[1:] = acc[:-1].copy()
                    acc[0] = 0
                key = int(best.min())
                assert key < 1 << 31
                k = key & 1023
                sad[by, bx] = key >> 10
                mv[by, bx] = (2 * (k // side - r), 2 * (k % side - r))
    return mv, sad


@pytest.mark.parametrize("r", [0, 4, 12, 15])
@pytest.mark.parametrize("kind, bd, dims", [
    ("shifted", 8, (48, 64)), ("random", 10, (48, 64)),
    ("flat", 8, (48, 64)), ("shifted", 8, (144, 176)),
    ("random", 12, (16, 272))])
def test_kernel_model_matches_plain(kind, bd, dims, r):
    src, ref = _pair(kind, *dims, bd=bd)
    mv, sad = _kernel_model(src, ref, r)
    pmv, psad = tb.hme_search(_tensor(src), _tensor(ref), r)
    assert np.array_equal(mv, pmv.numpy())
    assert np.array_equal(sad, psad.numpy())


def test_kernel_wrapper_refuses_other_devices():
    meta = torch.empty((32, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        hme_search_kernel(meta, meta)
    with pytest.raises(ValueError):
        hme_search_kernel(meta, torch.zeros((32, 32), dtype=torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["shifted", "flat", "random"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("dims, r", [
    ((144, 176), 0), ((144, 176), 4), ((144, 176), 12), ((144, 176), 15),
    ((16, 272), 15), ((1088, 1920), 12)])
def test_kernel_matches_plain(cuda_device, kind, dims, bd, r):
    src, ref = _pair(kind, *dims, bd=bd)
    s, f = _tensor(src, cuda_device), _tensor(ref, cuda_device)
    before = hme_search_kernel.launches
    mv, sad = hme_search_kernel(s, f, r)
    torch.cuda.synchronize()
    assert hme_search_kernel.launches == before + 1
    pmv, psad = tb.hme_search(s, f, r)
    assert mv.dtype == torch.int16 and sad.dtype == torch.int32
    assert torch.equal(mv, pmv) and torch.equal(sad, psad)


@pytest.mark.cuda
def test_kernel_takes_int32_planes(cuda_device):
    """int32 planes (and mixed pairs) are narrowed to int16 first."""
    src, ref = _pair("shifted", bd=10)
    s, f = _tensor(src, cuda_device), _tensor(ref, cuda_device)
    want = tb.hme_search(s, f)
    for a, b in ((s.int(), f.int()), (s.int(), f)):
        mv, sad = hme_search_kernel(a, b)
        assert torch.equal(mv, want[0]) and torch.equal(sad, want[1])


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
    with pytest.raises(ValueError):
        hme_search_kernel(s, s, 16)                   # 33^2 offsets > 1024
    with pytest.raises(ValueError):
        hme_search_kernel(s.t(), s.t())               # not contiguous
    odd = torch.zeros(48 * 48 + 1, dtype=torch.uint8,
                      device=cuda_device)[1:].view(48, 48)
    with pytest.raises(ValueError):
        hme_search_kernel(odd, odd)                   # not 8-byte aligned
