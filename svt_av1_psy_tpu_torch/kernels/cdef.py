"""CDEF on the card: the frame-level CDEF apply and strength search.

cdef_frame_kernel() runs the frame-level CDEF of the fast encoder path
(native/cdef_backend.c tpue_cdef, which the port calls through
native.cdef_run) on a CUDA device, as one launch of csrc/cdef.cu. It
replaces no TPU kernel: the JAX package ran this stage in the same host C.
cdef_frame_plain() is the same arithmetic in plain PyTorch, vectorised
over blocks, on any device; the tests and chip_smoke.py hold the kernel
against it and against the C.

Both take the pre-CDEF mi area of the three planes, the source planes, a
list of 8x8 block origins (cdef_block_list: the blocks tpue_cdef visits,
in its order) and a table of strength quadruples (y_pri, y_sec, uv_pri,
uv_sec). A search returns each quadruple's luma and chroma SSE as int64;
these equal the C's float64 sums exactly (every term is an integer and
the total stays far below 2^53). An apply returns the filtered planes.

An encoder builds its CDEF routes once and keeps them for its life
(FastIntraEncoder._cdef_routes): NativeCdef, the C library's
native.cdef_run, on the CPU; CardCdef, the same calls on the card, on a
CUDA device. A route's frame() binds it to one frame; on the card that is
a CardCdefFrame, which holds the frame's uploaded mi area and search table.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from svt_av1_psy_tpu_torch.kernels import build

VERY_LARGE = 0x7F7F          # what CDEF reads outside the mi area
MAX_CANDIDATES = 32          # kMaxCand of the CUDA source

# every quadruple the frame-level ladder of
# FastIntraEncoder._search_cdef can ask the SSE of: luma (p, s, 0, 0)
# with p in the primary ladder and 0, s in the secondary one and 0; chroma
# (0, 0, p, 0). One search launch computes all of them.
LADDER = tuple((p, s, 0, 0) for p in (0, 1, 2, 4, 7, 12)
               for s in (0, 1, 2)) + tuple((0, 0, p, 0) for p in (1, 2, 4))

_DIRS = (((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)),
         ((0, 1), (1, 2)), ((1, 1), (2, 2)), ((1, 0), (2, 1)),
         ((1, 0), (2, 0)), ((1, 0), (2, -1)))
_PRI_TAPS = ((4, 2), (3, 3))
_SEC_TAPS = (2, 1)
_DIV = (0, 840, 420, 280, 210, 168, 140, 120, 105)


def cdef_block_list(skip: np.ndarray, sample: int = 1,
                    n_threads: int = 4) -> np.ndarray:
    """The 8x8 blocks tpue_cdef filters, as (n, 2) int32 pixel origins
    (y0, x0), in its order: 64x64 units row-major, the 8x8 blocks of a
    unit row-major; a block whose 2x2 mi (inside the frame) are all skip
    is left out. With sample > 1 only every sample-th listed block is
    kept, counted afresh in each of native.cdef_run's bands (nb =
    min(n_threads, n64r) bands of 64-pixel rows, bounds i * n64r // nb), so
    the list is the C's sampled set block for block."""
    mi_rows, mi_cols = skip.shape
    n8r, n8c = (mi_rows + 1) // 2, (mi_cols + 1) // 2
    n64r, n64c = (mi_rows + 15) // 16, (mi_cols + 15) // 16
    sk = np.ones((2 * n8r, 2 * n8c), bool)
    sk[:mi_rows, :mi_cols] = skip != 0
    keep = np.zeros((8 * n64r, 8 * n64c), bool)
    keep[:n8r, :n8c] = ~sk.reshape(n8r, 2, n8c, 2).all(axis=(1, 3))
    fbr, fbc, r, c = np.nonzero(
        keep.reshape(n64r, 8, n64c, 8).transpose(0, 2, 1, 3))
    if sample > 1 and len(fbr):
        nb = max(min(n_threads, n64r), 1)
        bounds = np.array([i * n64r // nb for i in range(nb + 1)])
        band = np.searchsorted(bounds, fbr, side="right") - 1
        first = np.searchsorted(band, np.arange(nb))
        rank = np.arange(len(band)) - first[band]
        sel = rank % sample == 0
        fbr, fbc, r, c = fbr[sel], fbc[sel], r[sel], c[sel]
    return np.stack([(8 * fbr + r) * 8, (8 * fbc + c) * 8],
                    axis=1).astype(np.int32).reshape(-1, 2)


def _quads(strengths) -> list:
    quads = [tuple(int(v) for v in q)
             for q in np.asarray(strengths, np.int64).reshape(-1, 4)]
    if not 1 <= len(quads) <= MAX_CANDIDATES:
        raise ValueError(f"cdef: {len(quads)} strength quadruples; expected "
                         f"1 to {MAX_CANDIDATES}")
    if any(not 0 <= v < 16 for q in quads for v in q):
        raise ValueError(f"cdef: strengths {quads} outside [0, 15]")
    return quads


def _pairs(quads):
    """The distinct luma and chroma (pri, sec) pairs of the quadruples, in
    order of first use, and each quadruple's index into both."""
    ys, cs = [], []
    qy, qc = [], []
    for q in quads:
        for pairs, idx, p in ((ys, qy, q[:2]), (cs, qc, q[2:])):
            if p not in pairs:
                pairs.append(p)
            idx.append(pairs.index(p))
    return ys, cs, qy, qc


def cdef_work(gh: int, gw: int, h: int, w: int, n_blocks: int, strengths,
              src_bytes: int = 1, apply: bool = False):
    """(integer operations, bytes) of one launch, by the roofline's rule:
    each input read once, each output written once. Per block 1,000
    operations for the direction (64 pixels: shift, offset and 8 line
    sums; 8 x 15 lines: square, weight, add). Per pixel and filtered
    candidate: each of the 12 taps 3 for its max/min test and pair, and
    9 more for constrain and the multiply-add (difference, |.|, shift,
    subtract, two clamps, sign, multiply-add) only where its strength is
    not 0 (constrain returns 0 at once otherwise): the 4 primary taps
    where pri != 0, the 8 secondary taps where sec != 0; then rounding and
    the final clamps, 5. (Luma's primary strength is adjusted by the
    block's variance and is 0 where that is 0; such blocks are counted as
    filtered, which only the content decides.) Per pixel and candidate of
    a search 3 for the SSE. An unfiltered candidate costs its SSE only."""
    quads = _quads(strengths)
    ys, cs, _, _ = _pairs(quads)

    def per_px(pairs):
        return sum((5 + 12 * 3 + 4 * 9 * bool(p[0]) + 8 * 9 * bool(p[1]))
                   * bool(p[0] or p[1]) + 3 * (not apply) for p in pairs)

    ops = n_blocks * (1000 + 64 * per_px(ys) + 32 * per_px(cs))
    area = gh * gw * 2 * 3 // 2                 # the int16 mi area
    if apply:                                   # read, and written back
        return ops, 2 * area + n_blocks * 8
    src = (h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)) * src_bytes
    return ops, area + src + n_blocks * 8 + 16 * len(quads)


# --- the plain version -------------------------------------------------------

def _dir_tables():
    """[d, i * 8 + j] -> the partial-sum line of pixel (i, j) in direction d
    (find_dir's partial[d][...]), and [d, k] -> the cost weight of line k."""
    line = np.zeros((8, 64), np.int64)
    for i in range(8):
        for j in range(8):
            line[:, i * 8 + j] = (i + j, i + j // 2, i, 3 + i - j // 2,
                                  7 + i - j, 3 - i // 2 + j, j, i // 2 + j)
    wt = np.zeros((8, 15), np.int64)
    wt[2, :8] = wt[6, :8] = _DIV[8]
    for d in (0, 4):
        for k in range(7):
            wt[d, k] = wt[d, 14 - k] = _DIV[k + 1]
        wt[d, 7] = _DIV[8]
    for d in (1, 3, 5, 7):
        wt[d, 3:8] = _DIV[8]
        for k in range(3):
            wt[d, k] = wt[d, 10 - k] = _DIV[2 * k + 2]
    return line, wt


_LINE, _WEIGHT = _dir_tables()


def _bitlen_minus1(v: torch.Tensor, top: int) -> torch.Tensor:
    """floor(log2(v)) for 1 <= v (0 where v < 2), counting up to top."""
    out = torch.zeros_like(v)
    for b in range(1, top + 1):
        out += (v >= (1 << b)).to(v.dtype)
    return out


def _constrain(diff, strength, damping: int):
    """tpue_cdef's constrain, elementwise; strength broadcasts."""
    strength = torch.as_tensor(strength, dtype=torch.int64,
                               device=diff.device)
    shift = (damping - _bitlen_minus1(strength, 20)).clamp(min=0)
    ad = diff.abs()
    v = torch.minimum(ad, (strength - (ad >> shift)).clamp(min=0))
    return torch.where(strength > 0, torch.where(diff < 0, -v, v), 0)


def _padded(plane: torch.Tensor) -> torch.Tensor:
    """The plane as int64 inside a border of VERY_LARGE: 2 pixels before,
    10 after (the C's padded buffer)."""
    h, w = plane.shape
    out = torch.full((h + 12, w + 12), VERY_LARGE, dtype=torch.int64,
                     device=plane.device)
    out[2:2 + h, 2:2 + w] = plane.to(torch.int64) & 0xFFFF
    return out


def _windows(buf: torch.Tensor, y0, x0, side: int) -> torch.Tensor:
    """(n, side, side) windows of a padded plane whose top-left corners are
    (y0 - 2, x0 - 2) in plane coordinates."""
    ar = torch.arange(side, device=buf.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return buf[rows, cols]


def _find_dir(win: torch.Tensor, coeff_shift: int):
    """tpue_cdef's find_dir on (n, 12, 12) luma windows: (dir, var)."""
    n = win.shape[0]
    x = ((win[:, 2:10, 2:10] >> coeff_shift) - 128).reshape(n, 1, 64)
    line = torch.as_tensor(_LINE, device=win.device)
    part = torch.zeros((n, 8, 15), dtype=torch.int64, device=win.device)
    part.scatter_add_(2, line.expand(n, 8, 64), x.expand(n, 8, 64))
    cost = (part * part * torch.as_tensor(_WEIGHT, device=win.device)).sum(2)
    best = torch.argmax(cost, dim=1)        # the first of equal maxima
    bc = cost.gather(1, best[:, None])[:, 0]
    opp = cost.gather(1, ((best + 4) & 7)[:, None])[:, 0]
    return best, (bc - opp) >> 10


def _adjust_strength(strength: int, var: torch.Tensor) -> torch.Tensor:
    i = torch.where(var >> 6 > 0, _bitlen_minus1(var >> 6, 12), 0)
    return torch.where(var == 0, 0, (strength * (4 + i) + 8) >> 4)


def _filter(win: torch.Tensor, n_px: int, pri, sec: int, dirs, pd: int,
            coeff_shift: int) -> torch.Tensor:
    """tpue_cdef's filter_block on (n, n_px + 4, n_px + 4) windows, every
    block at once: pri (n,) or a number, dirs (n,)."""
    n, side = win.shape[0], n_px + 4
    dev = win.device
    flat = win.reshape(n, side * side)
    ii, jj = torch.meshgrid(torch.arange(n_px, device=dev),
                            torch.arange(n_px, device=dev), indexing="ij")
    centre = ((ii + 2) * side + jj + 2).reshape(1, -1)
    x = flat.gather(1, centre.expand(n, -1))
    pri = torch.as_tensor(pri, dtype=torch.int64, device=dev).reshape(-1, 1)
    taps_i = (pri >> coeff_shift) & 1
    dir_t = torch.as_tensor(_DIRS, dtype=torch.int64, device=dev)
    sm = torch.zeros_like(x)
    mx, mn = x.clone(), x.clone()

    def tap(d, k, sgn):
        off = sgn * (dir_t[d, k, 0] * side + dir_t[d, k, 1])
        return flat.gather(1, centre + off[:, None])

    for k in range(2):
        pt = torch.where(taps_i == 1, _PRI_TAPS[1][k], _PRI_TAPS[0][k])
        for sgn in (1, -1):
            p = tap(dirs, k, sgn)
            sm = sm + pt * _constrain(p - x, pri, pd)
            mx = torch.where(p != VERY_LARGE, torch.maximum(mx, p), mx)
            mn = torch.minimum(mn, p)
            for dd in (2, -2):
                s = tap((dirs + dd) % 8, k, sgn)
                sm = sm + _SEC_TAPS[k] * _constrain(s - x, sec, pd)
                mx = torch.where(s != VERY_LARGE, torch.maximum(mx, s), mx)
                mn = torch.minimum(mn, s)
    y = x + ((8 + sm - (sm < 0).to(sm.dtype)) >> 4)
    return torch.minimum(torch.maximum(y, mn), mx).reshape(n, n_px, n_px)


def _block_grid(y0, x0, n_px: int):
    """(rows, cols) of every pixel of each block: (n, n_px, n_px) each."""
    ar = torch.arange(n_px, device=y0.device)
    return ((y0[:, None] + ar)[:, :, None].expand(-1, -1, n_px),
            (x0[:, None] + ar)[:, None, :].expand(-1, n_px, -1))


def _sse(val, src: torch.Tensor, rows, cols, h: int, w: int) -> int:
    """The sum of (val - src)^2 over the pixels inside (h, w)."""
    inside = (rows < h) & (cols < w)
    r, c = rows[inside], cols[inside]
    d = val[inside] - (src[r, c].to(torch.int64) & 0xFFFF)
    return int((d * d).sum())


def cdef_frame_plain(planes, srcs, blocks, strengths, bd: int, damping: int,
                     w: int, h: int, apply: bool = False):
    """cdef_frame_kernel in plain PyTorch, on any device. planes: the
    pre-CDEF mi area, luma (gh, gw) and chroma (gh // 2, gw // 2), int16
    (or any integer type holding the uint16 pixels); srcs: the source
    planes covering at least (h, w) and ((h + 1) // 2, (w + 1) // 2), uint8
    or int16; blocks: (n, 2) int32 origins; strengths: K quadruples. A
    search (apply False) returns (K, 2) int64: per quadruple its luma and
    chroma SSE over the listed blocks' display pixels, of the filtered
    block, or of the unfiltered one where that plane's pri and sec are 0
    (tpue_cdef's !apply branch). An apply takes one quadruple and returns
    the three planes with every listed block filtered over its whole
    mi-area extent, a plane with pri = sec = 0 left as it was."""
    quads = _quads(strengths)
    if apply and len(quads) != 1:
        raise ValueError("cdef apply takes one strength quadruple")
    cs = bd - 8 if bd > 8 else 0
    dev = planes[0].device
    gh, gw = planes[0].shape
    blocks = torch.as_tensor(blocks, device=dev).to(torch.int64)
    y0, x0 = blocks[:, 0], blocks[:, 1]
    bufs = [_padded(p) for p in planes]
    lwin = _windows(bufs[0], y0, x0, 12)
    cwin = [_windows(b, y0 >> 1, x0 >> 1, 8) for b in bufs[1:]]
    dirs, var = _find_dir(lwin, cs)
    lrows, lcols = _block_grid(y0, x0, 8)
    crows, ccols = _block_grid(y0 >> 1, x0 >> 1, 4)
    ch, cw = (h + 1) // 2, (w + 1) // 2

    def luma(pri, sec):
        if not (pri or sec):
            return lwin[:, 2:10, 2:10]
        t = _adjust_strength(pri << cs, var)
        return _filter(lwin, 8, t, sec << cs,
                       dirs if pri << cs else torch.zeros_like(dirs),
                       damping + cs, cs)

    def chroma(pri, sec):
        if not (pri or sec):
            return [win[:, 2:6, 2:6] for win in cwin]
        return [_filter(win, 4, pri << cs, sec << cs,
                        dirs if pri << cs else torch.zeros_like(dirs),
                        damping + cs - 1, cs) for win in cwin]

    if apply:
        out = [p.clone() for p in planes]
        (y_pri, y_sec, uv_pri, uv_sec), = quads
        for filt, vals, rows, cols, dst, lim in (
                (y_pri or y_sec, lambda: [luma(y_pri, y_sec)], lrows, lcols,
                 out[:1], (gh, gw)),
                (uv_pri or uv_sec, lambda: chroma(uv_pri, uv_sec), crows,
                 ccols, out[1:], (gh // 2, gw // 2))):
            if not filt:
                continue
            inside = (rows < lim[0]) & (cols < lim[1])
            for v, o in zip(vals(), dst):
                o[rows[inside], cols[inside]] = v[inside].to(o.dtype)
        return tuple(out)

    ypairs, cpairs, qy, qc = _pairs(quads)
    sse_y = [_sse(luma(*p), srcs[0], lrows, lcols, h, w) for p in ypairs]
    sse_c = [sum(_sse(v, s, crows, ccols, ch, cw)
                 for v, s in zip(chroma(*p), srcs[1:])) for p in cpairs]
    return torch.tensor([[sse_y[a], sse_c[b]] for a, b in zip(qy, qc)],
                        dtype=torch.int64, device=dev)


# --- the kernel --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("cdef").cdef_frame
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i, i,                 # planes, gh, gw
                   vp, vp, vp, i, i, i,              # sources, strides, bytes
                   vp, i,                            # blocks
                   vp, i, vp, i, vp, vp, i,          # pairs, quadruples
                   i, i, i, i,                       # bd, damping, w, h
                   vp, vp, vp, vp,                   # sse, out planes
                   i, vp]                            # device, stream
    fn.restype = ctypes.c_int
    return fn


def _ints(values):
    return (ctypes.c_int * max(len(values), 1))(*values)


def cdef_frame_kernel(planes, srcs, blocks, strengths, bd: int, damping: int,
                      w: int, h: int, apply: bool = False):
    """cdef_frame_plain as one launch of csrc/cdef.cu, on a CUDA device:
    planes contiguous int16 (the uint16 pixels, all < 2^15); srcs (a
    search only; an apply ignores them) row-contiguous uint8 or int16, all
    of one type; blocks contiguous (n, 2) int32; everything on one CUDA
    device. Anything else, CPU tensors included, raises; there is no
    fallback. The outputs are new tensors, and nothing waits for the
    device."""
    quads = _quads(strengths)
    if apply and len(quads) != 1:
        raise ValueError("cdef apply takes one strength quadruple")
    dev = planes[0].device
    tensors = list(planes) + [blocks] + ([] if apply else list(srcs))
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"cdef_frame_kernel: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}; all "
                         "must be on one CUDA device")
    gh, gw = planes[0].shape
    if any(p.dtype != torch.int16 or not p.is_contiguous() for p in planes) \
            or planes[1].shape != (gh // 2, gw // 2) or \
            planes[2].shape != planes[1].shape or gh % 4 or gw % 4:
        raise ValueError("cdef_frame_kernel: planes must be contiguous int16,"
                         " luma (gh, gw) in whole mi, chroma (gh/2, gw/2); "
                         f"got {[(tuple(p.shape), p.dtype) for p in planes]}")
    if blocks.dtype != torch.int32 or blocks.dim() != 2 or \
            blocks.shape[1] != 2 or not blocks.is_contiguous():
        raise ValueError("cdef_frame_kernel: blocks must be contiguous (n, 2)"
                         f" int32, got {tuple(blocks.shape)} {blocks.dtype}")
    if not 0 < w <= gw or not 0 < h <= gh or not 8 <= bd <= 12:
        raise ValueError(f"cdef_frame_kernel: display {w}x{h} outside the mi"
                         f" area {gw}x{gh}, or bit depth {bd}")
    ys, cs, qy, qc = _pairs(quads)
    srcp, strides, src_bytes, sse, out = [None] * 3, (0, 0), 0, None, None
    if apply:
        out = [torch.empty_like(p) for p in planes]
    else:
        if any(s.dtype != srcs[0].dtype or s.dim() != 2 or s.stride(1) != 1
               for s in srcs) or srcs[0].dtype not in (torch.uint8,
                                                       torch.int16):
            raise ValueError("cdef_frame_kernel: sources must be 2-D, "
                             "row-contiguous, all uint8 or all int16")
        ch, cw = (h + 1) // 2, (w + 1) // 2
        if srcs[0].shape[0] < h or srcs[0].shape[1] < w or \
                any(s.shape[0] < ch or s.shape[1] < cw for s in srcs[1:]) \
                or srcs[1].stride(0) != srcs[2].stride(0):
            raise ValueError("cdef_frame_kernel: sources smaller than the "
                             "display, or chroma strides that differ")
        srcp = [s.data_ptr() for s in srcs]
        strides = (srcs[0].stride(0), srcs[1].stride(0))
        src_bytes = srcs[0].element_size()
        sse = torch.empty((len(quads), 2), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(
        *(p.data_ptr() for p in planes), gh, gw, *srcp, *strides, src_bytes,
        blocks.data_ptr(), blocks.shape[0],
        _ints([v for p in ys for v in p]), len(ys),
        _ints([v for p in cs for v in p]), len(cs), _ints(qy), _ints(qc),
        len(quads), bd, damping, w, h,
        None if sse is None else sse.data_ptr(),
        *((None,) * 3 if out is None else (o.data_ptr() for o in out)),
        dev.index, stream)
    if err != 0:
        raise RuntimeError(f"cdef_frame launch failed: cudaError {err}")
    with _LAUNCH_LOCK:              # the encoder and its filter thread
        cdef_frame_kernel.launches += 1
    return tuple(out) if apply else sse


# launches of the CUDA kernel; callers reset it to 0 to count one run
cdef_frame_kernel.launches = 0
_LAUNCH_LOCK = threading.Lock()


# --- the encoder's route -----------------------------------------------------

_TORCH_TYPES = {np.uint8: torch.uint8, np.int16: torch.int16,
                np.int32: torch.int32}


class NativeCdef:
    """The CPU's route: native.cdef_run, the C library's. frame() binds it
    to one frame, with the sources widened to the C's uint16."""

    def __init__(self, native):
        self.native = native

    def frame(self, planes, srcs, skip, w, h, bd, damping):
        """native.cdef_run(planes, srcs, skip, w, h, bd, damping, ...),
        called with the strengths, apply and sample."""
        srcs = [np.ascontiguousarray(s, np.uint16) for s in srcs]
        return functools.partial(self.native.cdef_run, planes, srcs, skip,
                                 w, h, bd, damping)


class CardCdef:
    """The route on a CUDA device, kept for an encoder's life: the device,
    and the stream its work is queued on (None: the current stream).
    frame() binds it to one frame as a CardCdefFrame, which holds all of
    that frame's state; the route holds none, so threads may share it."""

    kernel = staticmethod(cdef_frame_kernel)

    def __init__(self, device: torch.device, stream=None):
        self.device = torch.device(device)
        self.stream = stream

    def frame(self, planes, srcs, skip, w, h, bd, damping):
        return CardCdefFrame(self, planes, srcs, skip, w, h, bd, damping)

    def _queue(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """arr (uint16 as int16) on the device, through pinned memory."""
        if arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        host = torch.empty(arr.shape, dtype=_TORCH_TYPES[arr.dtype.type],
                           pin_memory=True)
        host.numpy()[...] = arr
        return host.to(self.device, non_blocking=True)

    def _home(self, tensors) -> list:
        """The tensors' numpy copies on the host, waited for."""
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in tensors]
        for hst, t in zip(hosts, tensors):
            hst.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        ev.synchronize()
        return [hst.numpy() for hst in hosts]


class CardCdefFrame:
    """native.cdef_run bound to one frame's planes, sources, skip map,
    display size, bit depth and damping, run on the card through `route`.

    Called with the strengths, apply and sample, it gives cdef_run's
    results: a search returns (sse_y, sse_uv) as floats, an apply filters
    the planes' mi area in place (and returns None). The first call
    uploads the pre-CDEF mi area through pinned memory; the first search
    at a sample computes the SSE of every LADDER quadruple in one launch
    and copies the table home, and later searches read it (a quadruple
    outside LADDER raises KeyError); an apply is one launch whose result is
    copied straight into the planes' mi area, after which nothing of the
    old planes is held. Sources go up in their pixel width (uint8 at 8
    bit, 16-bit ones as int16). Each call waits for its own copy home
    only. The device span cdef_program runs from a call's upload or launch
    to the start of its copy home."""

    def __init__(self, route, planes, srcs, skip, w, h, bd, damping):
        self.route, self.planes, self.skip = route, planes, skip
        self.srcs = [s if s.dtype in (np.uint8, np.uint16)
                     else s.astype(np.uint16) for s in srcs]
        self.geometry = (bd, damping, w, h)
        self._drop()

    def _drop(self) -> None:
        self._area = None           # the uploaded pre-CDEF mi area
        self._tables = {}           # (sample, n_threads) -> {quad: (y, uv)}

    def _mi_area(self):
        if self._area is None:
            gh, gw = self.skip.shape[0] * 4, self.skip.shape[1] * 4
            self._area = [self.route._upload(p[:gh >> s, :gw >> s])
                          for p, s in zip(self.planes, (0, 1, 1))]
        return self._area

    def __call__(self, strengths, apply, sample=1, n_threads=4):
        from svt_av1_psy_tpu_torch.utils import trace as _tr
        route = self.route
        with route._queue():
            if apply:
                span = _tr.device_begin("cdef_program", route.device)
                out = route.kernel(
                    self._mi_area(), None,
                    route._upload(cdef_block_list(self.skip, 1, n_threads)),
                    [strengths], *self.geometry, apply=True)
                _tr.device_end(span)
                for p, a in zip(self.planes, route._home(out)):
                    p[:a.shape[0], :a.shape[1]] = a.view(np.uint16)
                self._drop()                 # the planes have moved on
                return None
            key = (sample, n_threads)
            if key not in self._tables:
                span = _tr.device_begin("cdef_program", route.device)
                sse = route.kernel(
                    self._mi_area(), [route._upload(s) for s in self.srcs],
                    route._upload(cdef_block_list(self.skip, sample,
                                                  n_threads)),
                    LADDER, *self.geometry)
                _tr.device_end(span)
                table, = route._home([sse])
                self._tables[key] = {q: (float(a), float(b))
                                     for q, (a, b) in zip(LADDER, table)}
            return self._tables[key][tuple(int(v) for v in strengths)]
