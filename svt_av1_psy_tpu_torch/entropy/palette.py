"""Palette coding helpers shared by the tile parser and tile writer.

AV1 luma palette (spec 5.11.42 palette_mode_info / 5.11.49
palette_tokens): a block's palette is coded as reuse flags against a
color cache merged from the above/left neighbor palettes plus delta
coding of the new colors; the per-pixel color index map is coded in
anti-diagonal wavefront order with neighbor-derived contexts and a
dynamic color order.

Reference counterparts (behavioral, no code shared):
 - Source/Lib/Codec/entropy_coding.c write_palette_colors_y /
   write_palette_mode_info / tokenize_palette
 - Source/Lib/Codec/cabac_context_model.c:2458
   svt_get_palette_color_index_context
"""
from __future__ import annotations

import numpy as np


def merge_color_cache(above, left):
    """Sorted-merge dedupe of the above/left palettes (spec
    get_palette_cache). `above`/`left` are sorted tuples or None."""
    cache = []
    a = list(above) if above else []
    l = list(left) if left else []
    ai = li = 0
    while ai < len(a) and li < len(l):
        va, vl = a[ai], l[li]
        if vl < va:
            if not cache or vl != cache[-1]:
                cache.append(vl)
            li += 1
        else:
            if not cache or va != cache[-1]:
                cache.append(va)
            ai += 1
            if vl == va:
                li += 1
    cache.extend(v for v in a[ai:] if not cache or v != cache[-1])
    while li < len(l):
        if not cache or l[li] != cache[-1]:
            cache.append(l[li])
        li += 1
    return cache


_PAL_CTX_LOOKUP = (-1, -1, 0, -1, -1, 4, 3, 2, 1)


def palette_color_ctx(m, rr, cc, n):
    """get_palette_color_context: (cdf ctx, color order) for map cell
    (rr, cc) given the already-coded index map `m`."""
    nb = [int(m[rr, cc - 1]) if cc > 0 else -1,
          int(m[rr - 1, cc]) if rr > 0 else -1,
          int(m[rr - 1, cc - 1]) if (rr > 0 and cc > 0) else -1]
    sc = [2, 2, 1]
    if nb[0] == nb[1]:
        sc[0] += sc[1]
        nb[1] = -1
        if nb[0] == nb[2]:
            sc[0] += sc[2]
            nb[2] = -1
    elif nb[0] == nb[2]:
        sc[0] += sc[2]
        nb[2] = -1
    elif nb[1] == nb[2]:
        sc[1] += sc[2]
        nb[2] = -1
    ranks = []
    scores = []
    for idx in range(3):
        if nb[idx] != -1:
            ranks.append(nb[idx])
            scores.append(sc[idx])
    if len(ranks) >= 2 and (scores[0] < scores[1] or
                            (scores[0] == scores[1] and
                             ranks[0] > ranks[1])):
        ranks[0], ranks[1] = ranks[1], ranks[0]
        scores[0], scores[1] = scores[1], scores[0]
    if len(ranks) >= 3:
        if scores[0] < scores[2]:
            ranks[0], ranks[2] = ranks[2], ranks[0]
            scores[0], scores[2] = scores[2], scores[0]
        if scores[1] < scores[2]:
            ranks[1], ranks[2] = ranks[2], ranks[1]
            scores[1], scores[2] = scores[2], scores[1]
    h = 0
    mult = (1, 2, 2)
    pads = scores + [0] * (3 - len(scores))
    for idx in range(3):
        h += pads[idx] * mult[idx]
    ctx = _PAL_CTX_LOOKUP[h]
    order = ranks + [x for x in range(n) if x not in ranks]
    return ctx, order


def wavefront_cells(h_on: int, w_on: int):
    """Anti-diagonal map coding order after the (0, 0) cell (spec
    palette_tokens traversal)."""
    for i in range(1, h_on + w_on - 1):
        for j in range(min(i, w_on - 1), max(0, i - h_on + 1) - 1, -1):
            yield i - j, j


def ceil_log2(x) -> int:
    x = int(x)
    return 0 if x < 2 else (x - 1).bit_length()


def uniform_bits(n: int) -> int:
    """Bit width parameter of write/read_uniform(n)."""
    return n.bit_length() - 1 if (n & (n - 1)) == 0 else \
        (n - 1).bit_length()


def plan_color_coding(colors, cache, bd: int):
    """Encoder plan for palette_colors_y: which cache entries to reuse
    and how to delta-code the rest.

    colors: sorted tuple of desired palette colors (distinct ints).
    Returns (flags, new_colors, bits_extra, total_bits) where `flags`
    has one 0/1 per scanned cache entry (scan stops once n colors are
    reused, mirroring the parser), or None when the color set cannot be
    represented (new-color delta underflow, only possible for
    non-increasing duplicates — excluded by `distinct`).
    """
    colors = [int(v) for v in colors]
    n = len(colors)
    want = set(colors)
    flags = []
    got = []
    for v in cache:
        if len(got) >= n:
            break
        if v in want and v not in got:
            flags.append(1)
            got.append(v)
        else:
            flags.append(0)
    new = sorted(want - set(got))
    total = float(len(flags))
    bits_extra = 0
    if new:
        total += bd
        if len(new) > 1:
            # simulate the shrinking-width delta loop for the smallest
            # feasible pal_bits extra (parser: d = lit(bits)+1,
            # bits = min(bits, ceil_log2(rng)) after rng -= d)
            deltas = [new[i + 1] - new[i] for i in range(len(new) - 1)]
            for extra in range(4):
                bits = (bd - 3) + extra
                rng = (1 << bd) - new[0] - 1
                used = 2.0
                ok = True
                for d in deltas:
                    if d - 1 >= (1 << bits):
                        ok = False
                        break
                    used += bits
                    rng -= d
                    bits = min(bits, ceil_log2(rng))
                if ok:
                    bits_extra = extra
                    total += used
                    break
            else:
                return None
        # len(new) == 1: only the bd-bit color0 literal (no pal_bits)
    return flags, new, bits_extra, total
