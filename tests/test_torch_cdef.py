"""CDEF on the card (kernels/cdef.py, csrc/cdef.cu) against the host C.

On the CPU: cdef_frame_plain against native.cdef_run (the shared C
tpue_cdef), both SSEs and the applied planes, byte for byte, at 8 and 10
bit, over strengths, damping, skip maps, sizes (one whose mi area runs
past an odd display width) and the search's sample; cdef_block_list
against the blocks the C writes; the ladder run from one table against
the sequential ladder; whole encodes (low delay, random access, all-intra
with the deferred filter) through the card's route run on the CPU
(CpuCardCdef, a test fake: CardCdef with the plain version in the
kernel's place, built as each encoder's routes), byte-equal to the C's,
also with two deferred filter tasks interleaved on the filter threads'
route; the routes kept across an encoder's frames, the filter threads'
their own, each frame's state in a frame object of its own; and a CPU
encode never launching the kernel.
Tests marked `cuda` hold the kernel itself to both on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cdef.py``.
"""

import ctypes
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from svt_av1_psy_tpu_torch import native
from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig, PredStructure
from svt_av1_psy_tpu_torch.kernels import cdef
from svt_av1_psy_tpu_torch.models.fast_intra import FastIntraEncoder

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from make_test_clip import make_frame  # noqa: E402

# (width, height): whole superblocks, a partial one, and an odd display
# width whose mi area (176) runs past it
SIZES = [(176, 144), (352, 288), (171, 97)]
SKIPS = ["random", "none", "all"]
# (0, sec), (pri, 0), both, the strongest, nothing
QUADS = [(0, 2, 0, 1), (7, 0, 4, 0), (4, 1, 2, 2), (12, 2, 1, 0),
         (0, 0, 0, 0), (1, 0, 0, 2)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(w, h, bd, skip_kind, seed):
    """Pre-CDEF planes in encoder-sized buffers (the mi area and 64 more),
    sources of the same shape, and a skip map: textured planes, so that
    the directions, variances and clamps all vary."""
    rng = np.random.default_rng(seed)
    mi_rows, mi_cols = 2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3)
    top = (1 << bd) - 1
    planes, srcs = [], []
    for sh in (0, 1, 1):
        ph, pw = (mi_rows * 4 >> sh) + 64, (mi_cols * 4 >> sh) + 64
        yy, xx = np.mgrid[:ph, :pw]
        base = (top // 2 + top / 3 * np.sin(yy / (5 + sh) + xx / 7.0) *
                np.cos(xx / (9 - 3 * sh)))
        rec = np.clip(base + rng.normal(0, top / 40, (ph, pw)), 0, top)
        src = np.clip(rec + rng.normal(0, top / 60, (ph, pw)), 0, top)
        planes.append(rec.astype(np.uint16))
        srcs.append(src.astype(np.uint16))
    skip = {"random": rng.random((mi_rows, mi_cols)) < 0.4,
            "none": np.zeros((mi_rows, mi_cols), bool),
            "all": np.ones((mi_rows, mi_cols), bool)}[skip_kind]
    return planes, srcs, skip.astype(np.uint8)


def _area(planes, skip):
    gh, gw = skip.shape[0] * 4, skip.shape[1] * 4
    return [torch.from_numpy(np.ascontiguousarray(
        p[:gh >> s, :gw >> s]).view(np.int16)) for p, s in
        zip(planes, (0, 1, 1))]


def _tensors(srcs):
    return [torch.from_numpy(s.view(np.int16)) for s in srcs]


CASES = [(size, bd, skip, sample) for size in SIZES for bd in (8, 10)
         for skip in SKIPS for sample in (1, 4)]


@pytest.mark.parametrize("size,bd,skip_kind,sample", CASES,
                         ids=[f"{w}x{h}-{bd}bit-{s}-sample{n}"
                              for (w, h), bd, s, n in CASES])
def test_plain_matches_the_c(size, bd, skip_kind, sample):
    """Each quadruple's luma and chroma SSE equal native.cdef_run's search,
    and the planes of an apply equal its apply, over the whole mi area."""
    w, h = size
    i = CASES.index((size, bd, skip_kind, sample))
    damping = 3 + i % 4
    planes, srcs, skip = _frame(w, h, bd, skip_kind, seed=i)
    area = _area(planes, skip)
    got = cdef.cdef_frame_plain(
        area, _tensors(srcs),
        torch.from_numpy(cdef.cdef_block_list(skip, sample)), QUADS, bd,
        damping, w, h)
    want = [native.cdef_run([p.copy() for p in planes], srcs, skip, w, h,
                            bd, damping, q, apply=False, sample=sample)
            for q in QUADS]
    assert got.dtype == torch.int64
    assert [tuple(r) for r in got.tolist()] == want
    q = QUADS[i % len(QUADS)]
    out = cdef.cdef_frame_plain(
        area, None, torch.from_numpy(cdef.cdef_block_list(skip)), [q], bd,
        damping, w, h, apply=True)
    native.cdef_run(planes, srcs, skip, w, h, bd, damping, q, apply=True)
    for o, p in zip(out, _area(planes, skip)):
        assert torch.equal(o, p)


def _c_visits(skip, sample, w, h):
    """The 8x8 blocks tpue_cdef writes, in native.cdef_run's bands: its
    output plane starts at 0xFFFF, which no filtered pixel can be, and its
    filter input is a separate copy."""
    lib = native.get_lib()
    u16p, u8p = ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8)
    mi_rows, mi_cols = skip.shape
    gh, gw = mi_rows * 4, mi_cols * 4
    rng = np.random.default_rng(1)
    iny = rng.integers(0, 256, (gh, gw)).astype(np.uint16)
    inc = rng.integers(0, 256, (gh // 2, gw // 2)).astype(np.uint16)
    py = np.full_like(iny, 0xFFFF)
    pc = np.full_like(inc, 0xFFFF)
    n64r = (mi_rows + 15) // 16
    nb = min(4, n64r)
    bounds = [(0, n64r)] if nb <= 1 else \
        [(i * n64r // nb, (i + 1) * n64r // nb) for i in range(nb)]
    for b0, b1 in bounds:
        sse = (ctypes.c_double * 2)()
        lib.tpue_cdef(py.ctypes.data_as(u16p), gw, pc.ctypes.data_as(u16p),
                      pc.ctypes.data_as(u16p), gw // 2,
                      iny.ctypes.data_as(u16p), inc.ctypes.data_as(u16p),
                      inc.ctypes.data_as(u16p), iny.ctypes.data_as(u16p), gw,
                      inc.ctypes.data_as(u16p), inc.ctypes.data_as(u16p),
                      gw // 2, skip.ctypes.data_as(u8p), mi_rows, mi_cols,
                      mi_cols, w, h, 8, 3, 4, 0, 0, 0, 1, sample, b0, b1,
                      sse)
    written = (py != 0xFFFF).reshape(gh // 8, 8, gw // 8, 8).any(axis=(1, 3))
    return {(8 * r, 8 * c) for r, c in zip(*np.nonzero(written))}


@pytest.mark.parametrize("size", SIZES + [(64, 64), (1920, 1080)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sample", [1, 4])
def test_block_list_is_what_the_c_visits(size, sample):
    """cdef_block_list names the blocks the C filters (its sampled set
    at sample 4, counted afresh per band, n64r < 4 included), each once,
    in its order: 64x64 units row-major, blocks row-major inside."""
    w, h = size
    mi_rows, mi_cols = 2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3)
    skip = (np.random.default_rng(w + h).random((mi_rows, mi_cols)) <
            0.5).astype(np.uint8)
    got = cdef.cdef_block_list(skip, sample)
    assert got.dtype == np.int32 and got.shape[1] == 2
    assert {tuple(b) for b in got.tolist()} == _c_visits(skip, sample, w, h)
    assert len({tuple(b) for b in got.tolist()}) == len(got)
    key = [(y // 64, x // 64, y % 64, x % 64) for y, x in got.tolist()]
    assert key == sorted(key)


def test_block_list_skips_only_whole_skip_blocks():
    """A block is left out only when all of its 2x2 mi inside the frame
    are skip; an odd mi count leaves a half block whose one mi decides."""
    skip = np.ones((3, 5), np.uint8)
    skip[2, 4] = 0                       # the corner block's only mi
    skip[0, 1] = 0
    got = cdef.cdef_block_list(skip).tolist()
    assert got == [[0, 0], [8, 16]]
    assert cdef.cdef_block_list(np.ones((4, 4), np.uint8)).shape == (0, 2)


def _encoder(w, h, bd=8):
    return FastIntraEncoder(w, h, qindex=120, bd=bd, device="cpu")


class CpuCardCdef(cdef.CardCdef):
    """A test fake: CardCdef's route (the upload of the mi area, one table
    per search, the copy home into the mi area) on the CPU, with the plain
    version in the kernel's place and plain copies for the pinned ones."""

    kernel = staticmethod(cdef.cdef_frame_plain)

    def _upload(self, arr):
        if arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        return torch.from_numpy(np.ascontiguousarray(arr)).clone()

    def _home(self, tensors):
        return [t.numpy() for t in tensors]


def _on_the_route(monkeypatch):
    """Every FastIntraEncoder's CDEF through the card's route on the CPU:
    two CpuCardCdef per encoder, the encoder thread's and the filter
    thread's, as _cdef_routes builds two CardCdef on a CUDA device."""
    monkeypatch.setattr(
        FastIntraEncoder, "_cdef_routes",
        lambda self: (CpuCardCdef(self.device), CpuCardCdef(self.device)))


@pytest.mark.parametrize("seed,noise,bd", [(0, 2.0, 8), (1, 12.0, 8),
                                           (2, 40.0, 8), (3, 6.0, 10)])
def test_ladder_from_the_table_picks_as_the_sequential_ladder(
        monkeypatch, seed, noise, bd):
    """The filter stage's CDEF search and apply with every SSE read from
    one table gives the sequential C ladder's strengths and damping, and
    the same planes."""
    w, h = 176, 144
    rng = np.random.default_rng(seed)
    planes, srcs, skip = _frame(w, h, bd, "random", seed)
    top = (1 << bd) - 1
    noisy = [np.clip(p + rng.normal(0, noise * top / 255, p.shape), 0,
                     top).astype(np.uint16) for p in planes]
    got = []
    for routed in (False, True):
        if routed:
            _on_the_route(monkeypatch)
        enc = _encoder(w, h, bd)
        enc.enable_dlf = False
        for buf, p, k in zip((enc._rec_y, enc._rec_u, enc._rec_v), noisy,
                             (0, 1, 1)):
            buf[:enc.ah >> k, :enc.aw >> k] = p[:enc.ah >> k, :enc.aw >> k]
        enc._skip_map[...] = skip
        yp, up, vp = (s[:enc.pah >> k, :enc.paw >> k]
                      for s, k in zip(srcs, (0, 1, 1)))
        _, st, damping, resolve = enc._filter_stage(
            yp, up, vp, 120 + 40 * seed, None, may_defer=False)
        assert resolve is None and enc._cdef_cache == st
        got.append(((st, damping), enc._rec_y.copy(), enc._rec_u.copy(),
                    enc._rec_v.copy()))
    (st_c, *planes_c), (st_t, *planes_t) = got
    assert st_t == st_c
    for a, b in zip(planes_c, planes_t):
        assert np.array_equal(a, b)


def _ld(w, h, device):
    return Encoder(EncoderConfig(enc_mode=10, qp=30, intra_period_length=-1,
                                 pred_structure=PredStructure.LOW_DELAY_B),
                   w, h, device=device)


def _ra(w, h, device):
    return Encoder(EncoderConfig(enc_mode=10, qp=30, hierarchical_levels=2,
                                 intra_period_length=-1), w, h,
                   device=device)


def _ai(w, h, device):
    return Encoder(EncoderConfig(enc_mode=12, qp=35, intra_period_length=0),
                   w, h, device=device)


def _run(make, w, h, n, device="cpu"):
    rng = np.random.default_rng(7)
    frames = [make_frame(w, h, t, 8, 0.02, rng) for t in range(n)]
    enc = make(w, h, device)
    try:
        if make is _ra:
            pkts = [p for f in frames for p in enc.send_picture(*f)]
            pkts += enc.flush()
            return [(p.payload, *(np.array(r) for r in p.recon))
                    for p in pkts if p.display_idx >= 0] + \
                [p.payload for p in pkts]
        outs = [enc.encode(*f) for f in frames]
        return [(o.payload, o.recon_y, o.recon_u, o.recon_v) for o in outs]
    finally:
        enc.close()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, bytes):
            assert x == y
        else:
            assert x[0] == y[0]
            for p, q in zip(x[1:], y[1:]):
                assert np.array_equal(p, q)


ENCODES = {"ld": (_ld, 5), "ra": (_ra, 9), "allintra": (_ai, 10)}


@pytest.mark.parametrize("path", sorted(ENCODES))
def test_encode_through_the_route_equals_the_c(monkeypatch, path):
    """A whole encode whose CDEF goes through the card's route (its plain
    version, on the CPU) gives the C route's bytes and recon: low delay
    (a search on the key, cached applies after), random access (leaves
    deferred to the filter thread) and all-intra (9 deferred frames around
    a re-search)."""
    make, n = ENCODES[path]
    want = _run(make, 176, 144, n)
    _on_the_route(monkeypatch)
    _same(_run(make, 176, 144, n), want)


def test_the_routes_are_kept_across_frames(monkeypatch):
    """An encoder builds its routes once: every CDEF call of its frames on
    the encoder thread goes through one route object, and every call of
    the deferred filter thread through the other; each frame binds the
    route to its planes in a frame object of its own."""
    calls = []
    run = cdef.CardCdefFrame.__call__
    encoder_thread = threading.current_thread()

    def logged(self, *args, **kwargs):
        calls.append((threading.current_thread() is encoder_thread,
                      self.route, self, kwargs["apply"]))
        return run(self, *args, **kwargs)

    _on_the_route(monkeypatch)
    monkeypatch.setattr(cdef.CardCdefFrame, "__call__", logged)
    rng = np.random.default_rng(7)
    enc = _ai(176, 144, "cpu")
    routes = (enc._enc._cdef_route, enc._enc._cdef_side)
    try:
        for t in range(10):
            enc.encode(*make_frame(176, 144, t, 8, 0.02, rng)).recon_y
    finally:
        enc.close()
    assert routes == (enc._enc._cdef_route, enc._enc._cdef_side)
    assert routes[0] is not routes[1]
    main = {id(r) for on_main, r, _, _ in calls if on_main}
    side = {id(r) for on_main, r, _, _ in calls if not on_main}
    assert main == {id(routes[0])} and side == {id(routes[1])}
    # frames 0 and 8 search and apply here; the other 8 apply there
    assert sum(1 for on_main, _, _, apply in calls if on_main and apply) == 2
    assert sum(1 for on_main, _, _, _ in calls if not on_main) == 8
    assert len({id(f) for _, _, f, _ in calls}) == 10


def test_deferred_filters_at_once_equal_the_c(monkeypatch):
    """Two deferred filter tasks in flight at once on the filter threads'
    route, interleaved at its worst: the first task's CDEF apply stops
    before it uploads its mi area until the second one's is uploaded and
    launched, and the second's launch waits until the first has copied its
    result home. Every recon stays the C's."""
    make, n = ENCODES["allintra"]
    want = _run(make, 176, 144, n)
    _on_the_route(monkeypatch)
    encoder_thread = threading.current_thread()
    first, launched, home = [], threading.Event(), threading.Event()
    queue, plain, copy_home = (CpuCardCdef._queue, CpuCardCdef.kernel,
                               CpuCardCdef._home)

    def held_queue(self):
        if threading.current_thread() is not encoder_thread and not first:
            first.append(threading.current_thread())
            launched.wait(30)
        return queue(self)

    def held_kernel(*args, **kwargs):
        me = threading.current_thread()
        if me is not encoder_thread and first and me is not first[0] and \
                not launched.is_set():
            launched.set()
            home.wait(30)
        return plain(*args, **kwargs)

    def held_home(self, tensors):
        out = copy_home(self, tensors)
        if first and threading.current_thread() is first[0]:
            home.set()
        return out

    monkeypatch.setattr(CpuCardCdef, "_queue", held_queue)
    monkeypatch.setattr(CpuCardCdef, "kernel", staticmethod(held_kernel))
    monkeypatch.setattr(CpuCardCdef, "_home", held_home)
    got = _run(make, 176, 144, n)
    assert launched.is_set() and home.is_set()
    _same(got, want)


def test_cpu_encode_runs_the_c_and_never_the_kernel(monkeypatch):
    """On the CPU the frame's CDEF is native.cdef_run's: both routes are
    one NativeCdef over the native module, native.cdef_run runs, and the
    kernel never launches."""
    calls = []
    c_run = native.cdef_run

    def counted(*args, **kwargs):
        calls.append(kwargs.get("apply"))
        return c_run(*args, **kwargs)

    monkeypatch.setattr(native, "cdef_run", counted)
    cdef.cdef_frame_kernel.launches = 0
    enc = _encoder(176, 144)
    assert isinstance(enc._cdef_route, cdef.NativeCdef) and \
        enc._cdef_route.native is native and enc._cdef_side is enc._cdef_route
    _run(_ld, 176, 144, 3)
    assert cdef.cdef_frame_kernel.launches == 0
    assert False in calls and True in calls


def test_the_route_refuses_a_strength_outside_the_ladder():
    """CardCdef reads searches from the LADDER table: a quadruple the
    table does not hold raises, it is never filtered on the side."""
    planes, srcs, skip = _frame(176, 144, 8, "none", 5)
    route = CpuCardCdef(torch.device("cpu"))
    frame = route.frame(planes, srcs, skip, 176, 144, 8, 3)
    assert frame((7, 2, 0, 0), False, sample=4) == \
        native.cdef_run(planes, srcs, skip, 176, 144, 8, 3, (7, 2, 0, 0),
                        False, sample=4)
    with pytest.raises(KeyError):
        frame((3, 0, 0, 0), False, sample=4)
    assert not hasattr(route, "dlf_apply")      # no stand-in for native


def test_kernel_wrapper_counts_only_launches():
    """CPU tensors raise (the kernel never falls back to the plain
    version) and do not count as launches."""
    planes, srcs, skip = _frame(176, 144, 8, "random", 6)
    cdef.cdef_frame_kernel.launches = 0
    with pytest.raises(ValueError, match="one CUDA device"):
        cdef.cdef_frame_kernel(
            _area(planes, skip), _tensors(srcs),
            torch.from_numpy(cdef.cdef_block_list(skip, 4)), cdef.LADDER, 8,
            4, 176, 144)
    assert cdef.cdef_frame_kernel.launches == 0


def test_work_counts_by_hand():
    """cdef_work for one filtered luma pair and the unfiltered chroma on 2
    blocks: 2 x (1,000 + 64 x (77 + 3) + 32 x 3) operations; bytes: the
    int16 mi area, the 8-bit source, the blocks and the (1, 2) table."""
    ops, nbytes = cdef.cdef_work(16, 16, 16, 16, 2, [(1, 0, 0, 0)])
    assert ops == 2 * (1000 + 64 * (77 + 3) + 32 * 3)
    assert nbytes == 16 * 16 * 3 + 16 * 16 + 2 * 64 + 16 + 16


@pytest.mark.parametrize("pair,per_px", [((0, 0), 0), ((3, 0), 77),
                                         ((0, 2), 113), ((7, 1), 149)])
def test_work_counts_only_the_taps_with_a_strength(pair, per_px):
    """A filtered pixel costs 41 (the 12 taps' max/min tests and pairs, the
    rounding and clamps) and constrain's 9 for each of its 4 primary taps
    where pri != 0 and each of its 8 secondary taps where sec != 0; an
    apply counts no SSE, and an unfiltered plane nothing."""
    ops, _ = cdef.cdef_work(16, 16, 16, 16, 3, [pair + pair], apply=True)
    assert ops == 3 * (1000 + 64 * per_px + 32 * per_px)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(bd, dev, seed=11):
    w, h = 1920, 1080
    planes, srcs, skip = _frame(w, h, bd, "random", seed)
    area = [t.to(dev) for t in _area(planes, skip)]
    if bd == 8:
        src = [torch.from_numpy(s.astype(np.uint8)).to(dev) for s in srcs]
    else:
        src = [t.to(dev) for t in _tensors(srcs)]
    return w, h, planes, srcs, skip, area, src


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
def test_kernel_search_matches_plain_and_c_at_1080p(cuda_device, bd):
    w, h, planes, srcs, skip, area, src = _card_case(bd, cuda_device)
    blocks = torch.from_numpy(cdef.cdef_block_list(skip, 4)).to(cuda_device)
    cdef.cdef_frame_kernel.launches = 0
    got = cdef.cdef_frame_kernel(area, src, blocks, cdef.LADDER, bd, 5, w,
                                 h)
    torch.cuda.synchronize()
    assert cdef.cdef_frame_kernel.launches == 1
    plain = cdef.cdef_frame_plain(area, src, blocks, cdef.LADDER, bd, 5, w,
                                  h)
    assert torch.equal(got.cpu(), plain.cpu())
    want = [native.cdef_run(planes, srcs, skip, w, h, bd, 5, q, False,
                            sample=4) for q in cdef.LADDER]
    assert [tuple(r) for r in got.cpu().tolist()] == want


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("q", [(4, 1, 2, 0), (0, 2, 0, 0), (12, 0, 0, 1)])
def test_kernel_apply_matches_plain_and_c_at_1080p(cuda_device, bd, q):
    w, h, planes, srcs, skip, area, _ = _card_case(bd, cuda_device)
    blocks = torch.from_numpy(cdef.cdef_block_list(skip)).to(cuda_device)
    got = cdef.cdef_frame_kernel(area, None, blocks, [q], bd, 4, w, h,
                                 apply=True)
    torch.cuda.synchronize()
    plain = cdef.cdef_frame_plain(area, None, blocks, [q], bd, 4, w, h,
                                  apply=True)
    native.cdef_run(planes, srcs, skip, w, h, bd, 4, q, apply=True)
    for g, p, c in zip(got, plain, _area(planes, skip)):
        assert torch.equal(g.cpu(), p.cpu())
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    w, h, planes, srcs, skip, area, src = _card_case(8, cuda_device)
    blocks = torch.from_numpy(cdef.cdef_block_list(skip)).to(cuda_device)
    with pytest.raises(ValueError):
        cdef.cdef_frame_kernel([a.to(torch.int32) for a in area], src,
                               blocks, cdef.LADDER, 8, 3, w, h)
    with pytest.raises(ValueError):
        cdef.cdef_frame_kernel(area, src, blocks.cpu(), cdef.LADDER, 8, 3,
                               w, h)
    with pytest.raises(ValueError):
        cdef.cdef_frame_kernel(area, None, blocks, cdef.LADDER, 8, 3, w, h,
                               apply=True)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["ld", "ra", "allintra"])
def test_cuda_encode_equals_the_cpu_encode(cuda_device, monkeypatch, path):
    """352x288 encodes on cuda give the CPU's bytes and recon, with the
    frame's CDEF launched on the card through two CardCdef built once for
    the encoder's life (the filter thread's on a stream of its own), never
    one per frame."""
    make, n = ENCODES[path]
    want = _run(make, 352, 288, n)
    built = []
    init = cdef.CardCdef.__init__
    monkeypatch.setattr(cdef.CardCdef, "__init__",
                        lambda self, *a, **k: built.append(self) or
                        init(self, *a, **k))
    cdef.cdef_frame_kernel.launches = 0
    got = _run(make, 352, 288, n, device="cuda")
    assert cdef.cdef_frame_kernel.launches > 0
    assert len(built) == 2 and built[0].stream is None and \
        built[1].stream is not None
    _same(got, want)
