"""Inter-frame partition tree from the device full-pel SAD tree.

The reference drives inter partition depth from its open-loop ME tree
(ref motion_estimation.c open_loop_me_fullpel_search_sblock:781 — the
fullpel search produces SADs for the whole 8x8..64x64 block tree and
MD's depth decisions follow inter prediction quality). Our fast path
previously reused the INTRA source-SAD split tree on inter frames,
which on noisy content splits to 8x8 over most of the frame — an order
of magnitude more commit-walk RD trials than the reference runs, and a
partition-bit tax the low-rate tail cannot afford.

ops/jax_backend.hme_sad_tree supplies, per prediction edge, SADs at 32
and 64 granularity with each node evaluated at its children's winning
MVs (best single MV). The split rule is then the same cost shape the
device intra tree uses, but over INTER prediction error:

    split(node) when  sum(children SADs) + bias < node SAD
                 — finer MVs genuinely reduce prediction error by more
                   than the extra MV/mode/partition bits cost, or
              when  the intra tree splits AND prediction is poor
                 — occlusion reveals / uncovered detail code through
                   the walk's intra fallback, which needs depth.

16x16 -> 8x8 splits are allowed only where the intra tree wanted one
AND the inter prediction is poor: fine partitions purely for source
detail are exactly what inter skip blocks absorb for free.

Multiple edges (LAST[, ALTREF][, GOLDEN]) combine by elementwise min
at every level — a block predicted well by ANY reference needn't
split, and the walk's per-block RD picks the actual reference.
"""

from __future__ import annotations

import os

import numpy as np


def _pool_sum(a: np.ndarray, f: int = 2) -> np.ndarray:
    r, c = a.shape
    return a.reshape(r // f, f, c // f, f).sum(axis=(1, 3))


def _pool_max(a: np.ndarray, f: int) -> np.ndarray:
    r, c = a.shape
    return a.reshape(r // f, f, c // f, f).max(axis=(1, 3))


def _pool_min(a: np.ndarray, f: int) -> np.ndarray:
    r, c = a.shape
    return a.reshape(r // f, f, c // f, f).min(axis=(1, 3))


def inter_split_maps(edges: list, intra_split: dict, qindex: int,
                     bd: int = 8):
    """Build {64: s64, 32: s32, 16: s16} split maps for an inter frame.

    edges: list of (sad16, sad32, sad64) int arrays per prediction
    edge — half-res SADs from the device HME + SAD tree.
    intra_split: the device intra split maps (content-detail depth for
    the poor-prediction fallback). qindex/bd set the bias scale."""
    from svt_av1_psy_tpu_torch.ops.quant import ac_q

    assert edges
    qstep = ac_q(qindex, bd) / (8.0 * (1 << (bd - 8)))
    s16 = edges[0][0].astype(np.int64)
    s32 = edges[0][1].astype(np.int64)
    s64 = edges[0][2].astype(np.int64)
    for e16, e32, e64 in edges[1:]:
        s16 = np.minimum(s16, e16.astype(np.int64))
        s32 = np.minimum(s32, e32.astype(np.int64))
        s64 = np.minimum(s64, e64.astype(np.int64))

    # split bias: the extra partition/mode/MV bits of coding 4 children
    # instead of 1 block, in half-res SAD units (lambda-ish: scales
    # with the quantizer). Tunable for the BD harness sweep.
    bias_k = float(os.environ.get("SVT_TREE_BIAS", "16"))
    noise_k = float(os.environ.get("SVT_TREE_NOISE", "0.5"))
    bias = bias_k * qstep

    # Measured calibration (40f CIF classes, p6 RA, 4-CRF BD vs the
    # same-preset reference):
    #   - blocking 16->8 splits where inter prediction is adequate
    #     turned the default class +17% -> -1.4% (8x8 partitions of
    #     noise-like residual are pure partition-bit tax);
    #   - COLLAPSING 32/64 nodes regressed pan badly at every floor
    #     threshold tried (0.5q: +147, 0.15q: +43 vs +35 baseline) —
    #     full-pel SADs cannot see the subpel-phase gains finer MVs buy
    #     on textured motion (zoom/parallax fields), so the intra
    #     tree's depth is kept at 32/64;
    #   - the gain rule (children SAD sum + bias beats the node's best
    #     single-MV SAD) measured BD-neutral on pan and adds the splits
    #     scroll seams / occlusion boundaries need.
    # CONTENT-relative poor-prediction threshold: the frame's own
    # best-predicted cells (10th percentile) estimate the sensor-noise
    # floor; cells meaningfully above it carry structure finer MVs /
    # modes can still win on. A quantizer-scaled threshold here
    # (earlier variants) killed pan's 8x8 partitions exactly at the
    # low-rate end of the BD integral (qstep grows, texture doesn't).
    mad16 = s16.astype(np.float64) / 64.0
    floor = np.percentile(mad16, 10)
    poor16 = mad16 > noise_k * 3.0 * max(floor, 1e-3)

    i16 = np.asarray(intra_split[16]).astype(bool)
    i32 = np.asarray(intra_split[32]).astype(bool)
    i64 = np.asarray(intra_split[64]).astype(bool)

    gain32 = _pool_sum(s16) + bias < s32
    gain64 = _pool_sum(s32) + bias < s64

    # NOTE: collapsing 32/64 nodes was ALSO tried with this
    # content-relative floor (all cells transparent) — it regressed
    # every class (default -3.1% -> +11.9%): even noise-like content
    # wants 16x16 granularity (per-block MV/compound choices), so only
    # the 16->8 descent is gated
    split64 = i64 | gain64
    split32 = i32 | gain32
    split16 = i16 & poor16
    return {64: split64.astype(np.uint8), 32: split32.astype(np.uint8),
            16: split16.astype(np.uint8)}
