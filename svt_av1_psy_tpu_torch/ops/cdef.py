"""Normative CDEF — constrained directional enhancement filter (spec 7.15).

Semantics mirror the reference kernels (ref cdef.c svt_aom_cdef_find_dir_c /
svt_cdef_filter_block_c), property-tested bit-exact. The frame driver
follows the spec unit walk: 64x64 filter units over the post-deblock frame,
direction per non-skip luma 8x8, primary strength variance-adjusted for
luma, chroma filtered at 4x4 with the co-located luma direction.
"""
from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x7F7F

# Cdef_Directions (spec 7.15.3), offsets in (dy, dx); index by dir 0..7 with
# +/-2 wraparound handled by modular padding like the reference table.
_DIRS = [
    [(-1, 1), (-2, 2)],
    [(0, 1), (-1, 2)],
    [(0, 1), (0, 2)],
    [(0, 1), (1, 2)],
    [(1, 1), (2, 2)],
    [(1, 0), (2, 1)],
    [(1, 0), (2, 0)],
    [(1, 0), (2, -1)],
]
# padded: dir+2 and dir-2 accesses wrap into these (ref eb_cdef_directions)
def _dir_at(d):
    return _DIRS[d % 8] if 0 <= d % 8 <= 7 else None


_PRI_TAPS = ((4, 2), (3, 3))
_SEC_TAPS = ((2, 1), (2, 1))

_DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)


def find_dir(img: np.ndarray, coeff_shift: int = 0):
    """Direction + variance of one 8x8 (ref svt_aom_cdef_find_dir_c)."""
    x = (img.astype(np.int64) >> coeff_shift) - 128
    i = np.arange(8).reshape(8, 1)
    j = np.arange(8).reshape(1, 8)
    partial = np.zeros((8, 15), np.int64)
    idx = [i + j, i + j // 2, i + 0 * j, 3 + i - j // 2,
           7 + i - j, 3 - i // 2 + j, 0 * i + j, i // 2 + j]
    for d in range(8):
        np.add.at(partial[d], np.broadcast_to(idx[d], (8, 8)).ravel(),
                  x.ravel())
    cost = np.zeros(8, np.int64)
    for d in (2, 6):
        cost[d] = (partial[d][:8] ** 2).sum() * _DIV_TABLE[8]
    for d in (0, 4):
        p = partial[d]
        for k in range(7):
            cost[d] += (p[k] ** 2 + p[14 - k] ** 2) * _DIV_TABLE[k + 1]
        cost[d] += p[7] ** 2 * _DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        p = partial[d]
        cost[d] = (p[3:8] ** 2).sum() * _DIV_TABLE[8]
        for k in range(3):
            cost[d] += (p[k] ** 2 + p[10 - k] ** 2) * _DIV_TABLE[2 * k + 2]
    best = 0
    bc = 0
    for d in range(8):
        if cost[d] > bc:
            bc = int(cost[d])
            best = d
    var = int(bc - cost[(best + 4) & 7]) >> 10
    return best, var


def _constrain(diff, strength, damping):
    if strength == 0:
        return np.zeros_like(diff)
    shift = max(0, damping - (int(strength).bit_length() - 1))
    ad = np.abs(diff)
    return np.sign(diff) * np.minimum(ad, np.maximum(
        0, strength - (ad >> shift)))


def adjust_strength(strength: int, var: int) -> int:
    """Luma primary strength adjusted by directional variance."""
    if var == 0:
        return 0
    i = min((var >> 6).bit_length() - 1, 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


def filter_block(buf: np.ndarray, y0: int, x0: int, n: int, pri: int,
                 sec: int, direction: int, pri_damping: int,
                 sec_damping: int, coeff_shift: int = 0) -> np.ndarray:
    """Filter one n x n block whose top-left is at (y0, x0) in `buf`, a
    16-bit padded plane (CDEF_VERY_LARGE outside the frame). Returns the
    filtered block (ref svt_cdef_filter_block_c)."""
    taps_i = (pri >> coeff_shift) & 1
    pri_taps = _PRI_TAPS[taps_i]
    sec_taps = _SEC_TAPS[taps_i]
    x = buf[y0:y0 + n, x0:x0 + n].astype(np.int32)
    sm = np.zeros((n, n), np.int32)
    mx = x.copy()
    mn = x.copy()

    def tap(dy, dx):
        return buf[y0 + dy:y0 + dy + n, x0 + dx:x0 + dx + n].astype(np.int32)

    for k in range(2):
        for sgn in (1, -1):
            dy, dx = _DIRS[direction][k]
            p = tap(sgn * dy, sgn * dx)
            sm += pri_taps[k] * _constrain(p - x, pri, pri_damping)
            avail = p != CDEF_VERY_LARGE
            mx = np.maximum(mx, np.where(avail, p, 0))
            mn = np.minimum(mn, p)
            for dd in (2, -2):
                dy2, dx2 = _DIRS[(direction + dd) % 8][k]
                # the reference's padded table: dir+2 for dir>=6 and dir-2
                # for dir<2 use the wrapped rows, identical to mod-8
                s = tap(sgn * dy2, sgn * dx2)
                sm += sec_taps[k] * _constrain(s - x, sec, sec_damping)
                savail = s != CDEF_VERY_LARGE
                mx = np.maximum(mx, np.where(savail, s, 0))
                mn = np.minimum(mn, s)
    y = x + ((8 + sm - (sm < 0)) >> 4)
    return np.clip(y, mn, mx)


def cdef_frame(planes, skip_map, levels, damping: int, dims, bd: int = 8,
               cdef_idx=None):
    """Apply CDEF in place (spec 7.15).

    planes: [y, u, v] post-deblock recon (modified in place); input borders
    come from a pre-CDEF copy, VERY_LARGE outside the frame.
    skip_map: (mi_rows, mi_cols) uint8 per-4x4 skip flags.
    levels: list of (y_pri, y_sec, uv_pri, uv_sec) strength sets (sec
    already 3->4 mapped); cdef_idx: per-64x64 set index grid (None -> 0).
    dims: [(w, h)] * 3 plane dims. 4:2:0 only.
    """
    if isinstance(levels[0], (int, np.integer)):
        levels = [tuple(levels)]
    if cdef_idx is None and not any(levels[0]):
        return
    coeff_shift = max(bd - 8, 0)
    mi_rows, mi_cols = skip_map.shape
    srcs = []
    for plane in range(3):
        w, h = dims[plane]
        sh = 0 if plane == 0 else 1
        gw = (mi_cols * 4) >> sh          # unit-grid extent in px
        gh = (mi_rows * 4) >> sh
        buf = np.full((gh + 12, gw + 12), CDEF_VERY_LARGE, np.int32)
        # the CDEF frame boundary is the MI AREA, not the display size
        # (spec 7.15: MiCols*4 px; mi columns past an odd display width
        # hold real reconstructed pixels)
        ph, pw = planes[plane].shape
        ch_, cw_ = min(gh, ph), min(gw, pw)
        buf[2:2 + ch_, 2:2 + cw_] = planes[plane][:ch_, :cw_]
        srcs.append(buf)
    n64r = (mi_rows + 15) // 16
    n64c = (mi_cols + 15) // 16
    for fbr in range(n64r):
        for fbc in range(n64c):
            # non-skip 8x8 list within this 64x64 (ref
            # svt_sb_compute_cdef_list: all four 4x4s skip -> omit)
            blocks = []
            r0, c0 = fbr * 16, fbc * 16
            maxr = min(16, mi_rows - r0)
            maxc = min(16, mi_cols - c0)
            for r in range(0, maxr, 2):
                for c in range(0, maxc, 2):
                    s = skip_map[r0 + r:r0 + r + 2, c0 + c:c0 + c + 2]
                    if not s.all():
                        blocks.append((r >> 1, c >> 1))
            if not blocks:
                continue
            li = 0 if cdef_idx is None else max(0, int(cdef_idx[fbr, fbc]))
            y_pri, y_sec, uv_pri, uv_sec = levels[li]
            if not (y_pri or y_sec or uv_pri or uv_sec):
                continue
            dirs = {}
            for (by, bx) in blocks:
                y0 = (r0 + by * 2) * 4
                x0 = (c0 + bx * 2) * 4
                img = srcs[0][2 + y0:2 + y0 + 8, 2 + x0:2 + x0 + 8]
                dirs[(by, bx)] = find_dir(img, coeff_shift)
            for plane in range(3):
                pri = (y_pri if plane == 0 else uv_pri) << coeff_shift
                sec = (y_sec if plane == 0 else uv_sec) << coeff_shift
                if pri == 0 and sec == 0:
                    continue
                pd = damping + coeff_shift - (1 if plane else 0)
                sd = pd
                n = 8 if plane == 0 else 4
                sh = 0 if plane == 0 else 1
                for (by, bx) in blocks:
                    d, var = dirs[(by, bx)]
                    t = pri if plane else adjust_strength(pri, var)
                    y0 = ((r0 + by * 2) * 4) >> sh
                    x0 = ((c0 + bx * 2) * 4) >> sh
                    outb = filter_block(srcs[plane], 2 + y0, 2 + x0, n,
                                        t, sec, d if pri else 0, pd, sd,
                                        coeff_shift)
                    planes[plane][y0:y0 + n, x0:x0 + n] = outb


class CdefSearch:
    """Encoder-side strength search (ref enc_cdef.c cdef search, simplified
    to one strength set, cdef_bits == 0): directions and block lists are
    computed once; candidate strengths are evaluated by filtered-SSE against
    the source."""

    def __init__(self, planes, skip_map, dims, bd: int = 8):
        self.planes = planes
        self.dims = dims
        self.bd = bd
        self.coeff_shift = max(bd - 8, 0)
        mi_rows, mi_cols = skip_map.shape
        self.srcs = []
        for plane in range(3):
            w, h = dims[plane]
            sh = 0 if plane == 0 else 1
            gw = (mi_cols * 4) >> sh
            gh = (mi_rows * 4) >> sh
            buf = np.full((gh + 12, gw + 12), CDEF_VERY_LARGE, np.int32)
            buf[2:2 + h, 2:2 + w] = planes[plane][:h, :w]
            self.srcs.append(buf)
        self.blocks = []          # (mi_r, mi_c) of non-skip 8x8s
        n64r = (mi_rows + 15) // 16
        n64c = (mi_cols + 15) // 16
        for fbr in range(n64r):
            for fbc in range(n64c):
                r0, c0 = fbr * 16, fbc * 16
                for r in range(0, min(16, mi_rows - r0), 2):
                    for c in range(0, min(16, mi_cols - c0), 2):
                        if not skip_map[r0 + r:r0 + r + 2,
                                        c0 + c:c0 + c + 2].all():
                            self.blocks.append((r0 + r, c0 + c))
        self.dirs = [find_dir(self.srcs[0][2 + mr * 4:10 + mr * 4,
                                           2 + mc * 4:10 + mc * 4],
                              self.coeff_shift)
                     for (mr, mc) in self.blocks]

    def _patches(self, plane, n, sh):
        key = ("patches", plane)
        if not hasattr(self, "_cache"):
            self._cache = {}
        if key not in self._cache:
            pl = []
            for (mr, mc) in self.blocks:
                y0 = (mr * 4) >> sh
                x0 = (mc * 4) >> sh
                pl.append(self.srcs[plane][y0:y0 + n + 4, x0:x0 + n + 4])
            self._cache[key] = np.stack(pl) if pl else \
                np.zeros((0, n + 4, n + 4), np.int32)
        return self._cache[key]

    def plane_sse(self, plane, pri, sec, damping, src_plane):
        """SSE of the filtered plane vs source, filtering only the listed
        blocks (unfiltered area contributes its current SSE)."""
        cs = self.coeff_shift
        prs = pri << cs
        ses = sec << cs
        pd = damping + cs - (1 if plane else 0)
        n = 8 if plane == 0 else 4
        sh = 0 if plane == 0 else 1
        w, h = self.dims[plane]
        patches = self._patches(plane, n, sh)
        dirs = np.array([d for (d, v) in self.dirs], np.int32)
        if plane == 0:
            pris = np.array([adjust_strength(prs, v)
                             for (d, v) in self.dirs], np.int32)
        else:
            pris = np.full(len(self.dirs), prs, np.int32)
        if prs == 0:
            dirs = np.zeros_like(dirs)
        if prs == 0 and ses == 0:
            outs = patches[:, 2:2 + n, 2:2 + n]
        else:
            outs = filter_blocks_batch(patches, n, pris, ses, dirs, pd, pd,
                                       cs)
        total = 0
        for bi, (mr, mc) in enumerate(self.blocks):
            y0 = (mr * 4) >> sh
            x0 = (mc * 4) >> sh
            ny = min(n, h - y0)
            nx = min(n, w - x0)
            if ny <= 0 or nx <= 0:
                continue
            ref = src_plane[y0:y0 + ny, x0:x0 + nx].astype(np.int64)
            df = outs[bi, :ny, :nx].astype(np.int64) - ref
            total += int((df * df).sum())
        return total

    def search(self, src_planes, damping):
        """Best (y_pri, y_sec, uv_pri, uv_sec) by per-plane SSE."""
        def best_for(plane_list, src_idx):
            def sse(pri, sec):
                return sum(self.plane_sse(p, pri, sec, damping,
                                          src_planes[p])
                           for p in plane_list)
            pris = (0, 1, 2, 3, 5, 7, 9, 12, 15)
            bp = min(pris, key=lambda p: sse(p, 0))
            secs = (0, 1, 2, 4)
            bs = min(secs, key=lambda s2: sse(bp, s2))
            return bp, bs
        y_pri, y_sec = best_for((0,), 0)
        uv_pri, uv_sec = best_for((1, 2), 1)
        return (y_pri, y_sec, uv_pri, uv_sec)


def filter_blocks_batch(patches: np.ndarray, n: int, pris, sec: int,
                        dirs, pri_damping: int, sec_damping: int,
                        coeff_shift: int = 0) -> np.ndarray:
    """Vectorized filter_block over a batch: patches (B, n+4, n+4) with the
    block at [2:2+n, 2:2+n]; pris/dirs per-block arrays. Returns (B, n, n).
    Bit-identical to filter_block (grouped by (dir, pri) so taps and
    constrain shifts stay scalar)."""
    B = patches.shape[0]
    out = np.empty((B, n, n), np.int32)
    pris = np.asarray(pris)
    dirs = np.asarray(dirs)
    for d in range(8):
        for pri in np.unique(pris[dirs == d]) if B else []:
            sel = np.nonzero((dirs == d) & (pris == pri))[0]
            if sel.size == 0:
                continue
            buf = patches[sel]
            x = buf[:, 2:2 + n, 2:2 + n].astype(np.int32)
            sm = np.zeros_like(x)
            mx = x.copy()
            mn = x.copy()

            def tap(dy, dx):
                return buf[:, 2 + dy:2 + dy + n,
                           2 + dx:2 + dx + n].astype(np.int32)

            taps_i = (int(pri) >> coeff_shift) & 1
            pri_taps = _PRI_TAPS[taps_i]
            sec_taps = _SEC_TAPS[taps_i]
            for k in range(2):
                for sgn in (1, -1):
                    dy, dx = _DIRS[d][k]
                    p = tap(sgn * dy, sgn * dx)
                    sm += pri_taps[k] * _constrain(p - x, int(pri),
                                                   pri_damping)
                    avail = p != CDEF_VERY_LARGE
                    mx = np.maximum(mx, np.where(avail, p, 0))
                    mn = np.minimum(mn, p)
                    for dd in (2, -2):
                        dy2, dx2 = _DIRS[(d + dd) % 8][k]
                        sv = tap(sgn * dy2, sgn * dx2)
                        sm += sec_taps[k] * _constrain(sv - x, sec,
                                                       sec_damping)
                        savail = sv != CDEF_VERY_LARGE
                        mx = np.maximum(mx, np.where(savail, sv, 0))
                        mn = np.minimum(mn, sv)
            y = x + ((8 + sm - (sm < 0)) >> 4)
            out[sel] = np.clip(y, mn, mx)
    return out
