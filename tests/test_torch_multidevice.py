"""Multi-device through the port, on lists of CPU devices.

The reference shards its decide and its GoP program over a jax mesh and
lets XLA insert the halo exchanges; the port takes a list of devices,
splits the frame into column shards of whole superblocks and copies each
with the halo columns its reads reach. On ``["cpu"] * n`` the results
must be the unsharded ones byte for byte: the decide maps for n in {2, 4,
8} on flat, noise and edge planes and uneven splits; the width-sharded
GoP program (hme_search2 with the frame-wide global vote, hme_sad_tree,
the decide) with SVT_HME_GLOBK pinned to 4 and to 0, on planes whose
shards vote for different bins and whose motion reaches the frame's
edges; random access with mini-GoPs on device groups of one and of
several entries; and the twins of __graft_entry__.py's entry and
dryrun_multichip against the reference's unsharded encoders.
"""

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig
from svt_av1_psy_tpu_torch.graft_entry import dryrun_multichip, entry
from svt_av1_psy_tpu_torch.models.fast_intra import FastIntraEncoder
from svt_av1_psy_tpu_torch.ops import torch_backend as tb
from svt_av1_psy_tpu_torch.utils.device import (DeviceGroup, HostCopy,
                                                HostStitch)
from svt_av1_psy_tpu_torch.utils.test_clip import make_frame


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One torch thread per worker process, and the default motion-search
    route (K_GLOB 4) unless a test pins it."""
    for name in ("SVT_HME_PALLAS", "SVT_HME_1LEVEL", "SVT_HME_GLOBK"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane(kind, h, w, bd=8, seed=3):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bd == 8 else np.uint16
    if kind == "flat":
        return np.full((h, w), 77 << (bd - 8), dt)
    if kind == "noise":
        return rng.integers(0, 1 << bd, (h, w)).astype(dt)
    # edges: bars, a diagonal and steps that cross the shard borders
    yy, xx = np.mgrid[:h, :w]
    p = ((xx // 24 + yy // 40) % 2) * 150 + (xx > yy * 3) * 60 + \
        rng.integers(0, 20, (h, w))
    return (p.astype(np.int64) << (bd - 8)).astype(dt)


# --- column shards ----------------------------------------------------------

@pytest.mark.parametrize("width, n, own", [
    (30 * 64, 4, [8, 8, 7, 7]),
    (5 * 64, 2, [3, 2]),
    (9 * 64, 8, [2, 1, 1, 1, 1, 1, 1, 1]),
    (2 * 64, 4, [1, 1]),
])
def test_column_shards(width, n, own):
    """Whole superblocks, as even as they go, no empty shard; the copy of
    each is its columns and SHARD_HALO more on each side, cut at the
    frame's edges."""
    shards = tb.column_shards(width, n)
    assert [(s.x1 - s.x0) // 64 for s in shards] == own
    assert shards[0].x0 == 0 and shards[-1].x1 == width
    for a, b in zip(shards, shards[1:]):
        assert a.x1 == b.x0
    for s in shards:
        assert s.lo == max(s.x0 - tb.SHARD_HALO, 0)
        assert s.hi == min(s.x1 + tb.SHARD_HALO, width)
        assert s.width == width and s.lo % 64 == 0 and s.hi % 64 == 0


def test_device_group_on_cpu():
    g = DeviceGroup(["cpu", torch.device("cpu")])
    assert len(g) == 2 and g.streams == [None, None]
    t = torch.arange(4)
    with g.stream(1):
        assert g.hand(t, 0, 1) is t
    with pytest.raises(ValueError):
        DeviceGroup([])
    stitch = HostStitch([HostCopy(torch.arange(2)), HostCopy(torch.arange(3))],
                        np.concatenate)
    assert np.array_equal(np.asarray(stitch), [0, 1, 0, 1, 2])


# --- the sharded decide -----------------------------------------------------

@pytest.mark.parametrize("kind", ["flat", "noise", "edges"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_decide_matches_decide(n, kind):
    """make_sharded_decide over ["cpu"] * n gives _decide's maps, on a
    frame of 9 superblock columns (uneven shards for every n)."""
    enc = FastIntraEncoder(576, 128, qindex=100, device="cpu")
    yp = _plane(kind, 128, 576)
    want = enc._decide(yp)
    got = enc.make_sharded_decide(["cpu"] * n)(yp)
    assert enc._decide is not FastIntraEncoder._decide
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("bd, min_block", [(8, 8), (10, 8), (8, 16)])
def test_sharded_decide_uneven_split(bd, min_block):
    """5 superblocks over 2 entries (3 + 2), at 8 and 10 bit and a larger
    minimum block: the packed buffer equals intra_decide_packed's."""
    y = _plane("edges", 192, 320, bd)
    want = tb.intra_decide_packed(tb.plane_tensor(y, torch.device("cpu")),
                                  600, bd, min_block).numpy()
    got = np.asarray(tb.intra_decide_sharded(y, 600, bd, min_block,
                                             DeviceGroup(["cpu"] * 2)))
    assert np.array_equal(got, want)


def test_sharded_decide_skips_prefetch(monkeypatch):
    """With the sharded decide in place, prefetch_decide dispatches no
    unsharded program (as in the reference)."""
    monkeypatch.setenv("SVT_PREFETCH_CPU", "1")
    enc = FastIntraEncoder(128, 64, qindex=100, device="cpu")
    enc.prefetch_decide(_plane("noise", 64, 128))
    assert len(enc._pref) == 1
    enc.make_sharded_decide(["cpu"] * 2)
    enc.prefetch_decide(_plane("noise", 64, 128))
    assert len(enc._pref) == 1


# --- the width-sharded GoP program ------------------------------------------

def _moving_stack(kind, F=4, H=128, W=512, seed=5):
    """F planes of a scene that moves from plane to plane. "stripes":
    vertical bands of the frame move each by its own motion, so that the
    shards vote for different bins; "edge": all of it moves towards the
    frame's left and bottom edges, so that the searches reach the edge
    pad."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H + 96, W + 96)).astype(np.uint8)
    big = ((big.astype(np.int32) + np.roll(big, 1, 0) + np.roll(big, 1, 1)
            + np.roll(big, (1, 1), (0, 1))) // 4).astype(np.uint8)
    planes = np.empty((F, H, W), np.uint8)
    for f in range(F):
        if kind == "edge":
            planes[f] = big[48 - 5 * f:48 - 5 * f + H,
                            48 + 9 * f:48 + 9 * f + W]
            continue
        # stripe widths 160, 96, 64, 192: motions (dy, dx) per stripe
        x = 0
        for width, (dy, dx) in zip((160, 96, 64, 192),
                                   ((4, 8), (-6, 2), (2, -10), (-3, -6))):
            planes[f, :, x:x + width] = big[48 + dy * f:48 + dy * f + H,
                                            48 + dx * f + x:
                                            48 + dx * f + x + width]
            x += width
    return planes


EDGES = np.array([[1, 0], [2, 0], [3, 0], [2, 1], [3, 2], [0, 3], [1, 1],
                  [0, 0], [3, 1]], np.int32)


def test_shards_vote_for_different_bins():
    """The stripes stack is a case the frame-wide vote must decide: the
    two shards' own most-voted level-0 bins differ, and neither shard's
    top 4 is the frame's."""
    planes = _moving_stack("stripes")
    cpu = torch.device("cpu")
    src, ref = (tb.plane_tensor(planes[i][None], cpu) for i in (1, 0))
    seed = tb._hme_level0(tb._hme_pyramid(src, ref), 16)
    frame = tb._hme_global(tb._hme_votes(seed, 16), 4, 16)
    tops = []
    for s in tb.column_shards(512, 2):
        own = seed[:, :, s.x0 // 16:s.x1 // 16]
        tops.append(tb._hme_global(tb._hme_votes(own, 16), 4, 16))
        assert not torch.equal(tops[-1], frame)
    assert not torch.equal(tops[0][:, 0], tops[1][:, 0])


@pytest.mark.parametrize("kind", ["stripes", "edge"])
@pytest.mark.parametrize("globk", ["4", "0"])
@pytest.mark.parametrize("n", [2, 3])
def test_sharded_gop_search_matches(n, globk, kind, monkeypatch):
    """gop_search_sharded over ["cpu"] * n (mv, sad, the SAD tree and the
    decide of every frame) equals gop_search, with the global candidates
    pinned on (4) and off (0); 9 edges, so the last chunk is short."""
    monkeypatch.setenv("SVT_HME_GLOBK", globk)
    planes = _moving_stack(kind)
    want = tb.gop_search(tb.plane_tensor(planes, torch.device("cpu")),
                         EDGES, 700).numpy()
    got = np.asarray(tb.gop_search_sharded(planes, EDGES, 700, 8, 8,
                                           DeviceGroup(["cpu"] * n)))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sharded_gop_search_10bit():
    planes = (_moving_stack("edge").astype(np.uint16) << 2) + 3
    want = tb.gop_search(tb.plane_tensor(planes, torch.device("cpu")),
                         EDGES[:4], 900, 10).numpy()
    got = np.asarray(tb.gop_search_sharded(planes, EDGES[:4], 900, 10, 8,
                                           DeviceGroup(["cpu"] * 2)))
    assert np.array_equal(got, want)


# --- random access on device groups ------------------------------------------

def _ra(dims, groups, tf=0, n=9, levels=2):
    w, h = dims
    rng = np.random.default_rng(7)
    frames = [make_frame(w, h, t, 8, 0.02, rng) for t in range(n)]
    cfg = EncoderConfig(enc_mode=10, qp=30, hierarchical_levels=levels,
                        intra_period_length=-1, enable_tf=tf,
                        tf_strength=1)
    enc = Encoder(cfg, w, h, device="cpu")
    if groups is not None:
        enc._ra.gop_meshes = groups
    try:
        pkts = [p for f in frames for p in enc.send_picture(*f)] + \
            enc.flush()
    finally:
        enc.close()
    return [(p.payload, p.display_idx) for p in pkts], \
        getattr(enc._ra, "_gop_seq", 0)


@pytest.mark.parametrize("dims, groups", [
    ((176, 144), [["cpu"]]),
    ((176, 144), [["cpu"], ["cpu"]]),
    ((176, 144), [["cpu", "cpu"]]),
    ((352, 288), [["cpu", "cpu"], ["cpu", "cpu", "cpu"]]),
], ids=["one_group", "two_groups", "group_of_2", "groups_of_2_and_3"])
def test_grouped_ra_matches_ungrouped(dims, groups):
    """Mini-GoPs round robin over device groups (groups of one run
    gop_search on their stream, larger ones the width-sharded program):
    the ungrouped run's bytes, and every GoP went to a group."""
    want, _ = _ra(dims, None)
    got, seq = _ra(dims, groups)
    assert got == want
    assert seq >= 2


def test_grouped_ra_ignores_groups_with_tf():
    """With TF on, the GoP program is gop_search_tf on the encoder's
    device and the groups are not used, as in the reference."""
    want, _ = _ra((176, 144), None, tf=1)
    got, seq = _ra((176, 144), [["cpu", "cpu"]], tf=1)
    assert got == want and seq == 0


# --- the driver entry points -------------------------------------------------

def test_entry_runs_on_cpu():
    """entry()'s step on "cpu" gives the reference entry()'s maps."""
    import __graft_entry__ as ref_entry
    step, args = entry("cpu")
    assert args[0].dtype == torch.uint8 and tuple(args[0].shape) == (448, 832)
    got = step(*args)
    ref_step, ref_args = ref_entry.entry()
    want = ref_step(*ref_args)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _ref_dryrun_streams(n):
    """The reference's encoders at dryrun_multichip's configs, unsharded."""
    import svt_av1_psy_tpu.models.fast_intra as ref_fi
    import svt_av1_psy_tpu.models.ra as ref_ra
    W, H = 64 * n, 128
    rng = np.random.default_rng(1)
    y = rng.integers(0, 255, (H, W), dtype=np.uint8)
    u = rng.integers(0, 255, (H // 2, W // 2), dtype=np.uint8)
    v = rng.integers(0, 255, (H // 2, W // 2), dtype=np.uint8)
    enc = ref_fi.FastIntraEncoder(W, H, qindex=100, n_tiles=n)
    intra = enc.encode_frame(y, u, v).payload
    enc.close()
    gsz = n // (2 if n >= 4 else 1)
    W2 = 64 * gsz
    rng2 = np.random.default_rng(7)
    frames = [(rng2.integers(0, 255, (H, W2), dtype=np.uint8),
               rng2.integers(0, 255, (H // 2, W2 // 2), dtype=np.uint8),
               rng2.integers(0, 255, (H // 2, W2 // 2), dtype=np.uint8))
              for _ in range(9)]
    drv = ref_ra.RaDriver(ref_fi.FastIntraEncoder(W2, H, qindex=100,
                                                  n_tiles=1),
                          gop_levels=2, keyint=0)
    pkts = [p for f in frames for p in drv.push(*f)] + drv.flush()
    drv.close()
    return intra, [p.payload for p in pkts]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_reference(n):
    """The twin on ["cpu"] * n: both streams decode to their recon (the
    twin checks that itself, through dav1d here) and equal the
    reference's unsharded bytes at the same configs."""
    import jax  # noqa: F401  (before the reference RA's warm-up thread)
    res = dryrun_multichip(n, ["cpu"] * n)
    assert res["decoder"] == "dav1d" and res["gop_seq"] >= 2
    intra, ra = _ref_dryrun_streams(n)
    assert res["intra"] == intra
    assert res["ra"] == ra


# --- on the card: entries of one GPU, each with a stream ---------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_cuda_sharded_programs_match_cpu(cuda_device, n):
    """On ["cuda"] * n (one stream per entry) the sharded decide and GoP
    program give the CPU's unsharded bytes, and the decide's dispatch
    makes no host sync."""
    group = DeviceGroup([cuda_device] * n)
    assert all(s is not None for s in group.streams)
    y = _plane("edges", 192, 576)
    want = tb.intra_decide_packed(tb.plane_tensor(y, torch.device("cpu")),
                                  700).numpy()
    tb.intra_decide_packed(tb.plane_tensor(y, cuda_device), 700)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tb.intra_decide_sharded(y, 700, 8, 8, group)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.array_equal(np.asarray(got), want)
    planes = _moving_stack("stripes")
    want = tb.gop_search(tb.plane_tensor(planes, torch.device("cpu")),
                         EDGES, 700).numpy()
    got = tb.gop_search_sharded(planes, EDGES, 700, 8, 8, group)
    assert np.array_equal(np.asarray(got), want)


@pytest.mark.cuda
def test_cuda_dryrun_multichip(cuda_device):
    res = dryrun_multichip(2)
    assert res["gop_seq"] >= 2 and res["intra"]
