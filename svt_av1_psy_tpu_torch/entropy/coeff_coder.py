"""AV1 transform-coefficient coding (spec 5.11.39-5.11.47).

Encoder mirror of the reference's av1_write_coeffs_txb path
(ref: Source/Lib/Codec/entropy_coding.c:459-570) and of the context helpers
in txb context derivation. This scalar implementation is the trusted commit
path; the batched symbol-stream producer (device side) feeds the same symbol
sequence.

Every context formula below is decoder-normative — dav1d recomputes it, so
any deviation breaks the stream. Layout notes:
  - levels buffer: per-row padding of TX_PAD_HOR columns (right) like the
    reference, so neighbor reads never branch.
  - For 64-side transforms all coding happens on the compact kept 32x32
    region (adjusted tx size).
"""

from __future__ import annotations

import numpy as np

from svt_av1_psy_tpu_torch.constants import (TX_SIZE_HIGH, TX_SIZE_SQR,
                                       TX_SIZE_SQR_UP, TX_SIZE_WIDE, TxType,
                                       get_scan)
from svt_av1_psy_tpu_torch.entropy.range_coder import RangeEncoder
from svt_av1_psy_tpu_torch.ops.quant import adjusted_tx_size

TX_PAD_HOR = 4
NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
MAX_TX_32_CTX = 3  # min(txs_ctx, TX_32X32) for coeff_br

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2

_TX_CLASS = {
    TxType.DCT_DCT: TX_CLASS_2D, TxType.ADST_DCT: TX_CLASS_2D,
    TxType.DCT_ADST: TX_CLASS_2D, TxType.ADST_ADST: TX_CLASS_2D,
    TxType.FLIPADST_DCT: TX_CLASS_2D, TxType.DCT_FLIPADST: TX_CLASS_2D,
    TxType.FLIPADST_FLIPADST: TX_CLASS_2D, TxType.ADST_FLIPADST: TX_CLASS_2D,
    TxType.FLIPADST_ADST: TX_CLASS_2D, TxType.IDTX: TX_CLASS_2D,
    TxType.V_DCT: TX_CLASS_VERT, TxType.H_DCT: TX_CLASS_HORIZ,
    TxType.V_ADST: TX_CLASS_VERT, TxType.H_ADST: TX_CLASS_HORIZ,
    TxType.V_FLIPADST: TX_CLASS_VERT, TxType.H_FLIPADST: TX_CLASS_HORIZ,
}


def tx_class_of(tx_type: int) -> int:
    return _TX_CLASS[TxType(tx_type)]


def txs_entropy_ctx(tx_size: int) -> int:
    """get_txsize_entropy_ctx: 0..4."""
    return (TX_SIZE_SQR[tx_size] + TX_SIZE_SQR_UP[tx_size] + 1) >> 1


def eob_multi_size(tx_size: int) -> int:
    """txsize_log2_minus4 of the adjusted size: 16->0 ... 1024->5 (+6 for 64s)."""
    w = min(TX_SIZE_WIDE[tx_size], 32)
    h = min(TX_SIZE_HIGH[tx_size], 32)
    return max(0, (w * h).bit_length() - 1 - 4)


def get_eob_pos_token(eob: int) -> tuple[int, int, int]:
    """Returns (eob_pt, extra, n_offset_bits). eob >= 1."""
    if eob <= 2:
        t = eob
    else:
        t = (eob - 1).bit_length() + 1
    group_start = 1 if t == 1 else (2 if t == 2 else (1 << (t - 2)) + 1)
    extra = eob - group_start
    bits = 0 if t < 3 else t - 2
    # eob_pt 3 covers {3,4}: 1 offset bit; matches k_eob_offset_bits
    if t == 3:
        bits = 1
    return t, extra, bits


def get_eob_pos_token_from_pt(eob_pt: int) -> tuple[int, None, int]:
    """Offset-bit count for a given eob_pt (decode side)."""
    bits = 0 if eob_pt < 3 else eob_pt - 2
    return eob_pt, None, bits


# --- levels buffer ----------------------------------------------------------

def init_levels(qcoeff: np.ndarray) -> np.ndarray:
    """uint8 |level| clamped to 127, padded TX_PAD_HOR to the right and
    4 rows below (reads never leave the buffer)."""
    h, w = qcoeff.shape
    lv = np.zeros((h + 4, w + TX_PAD_HOR), np.uint8)
    lv[:h, :w] = np.minimum(np.abs(qcoeff), 127).astype(np.uint8)
    return lv


# --- context derivation (all normative) -------------------------------------

def _nz_map_ctx_offset_2d(row: int, col: int, w: int, h: int) -> int:
    if row == 0 and col == 0:
        return 0
    if w < h and row < 2:
        return 11
    if w > h and col < 2:
        return 16
    if row + col < 2:
        return 1
    if row + col < 4:
        return 6
    return 21


def base_ctx(levels: np.ndarray, row: int, col: int, w: int, h: int,
             tx_class: int, real_w: int = 0, real_h: int = 0) -> int:
    """get_lower_levels_ctx: 0..41.

    w/h: compact (kept-coefficient) dims that index `levels`; real_w/real_h:
    the ORIGINAL tx dims, which drive the 2D offset shape rules for 64-side
    transforms (ref av1_nz_map_ctx_offset[tx_size] is built from real dims).
    """
    if not real_w:
        real_w, real_h = w, h
    c3 = lambda v: min(int(v), 3)
    if tx_class == TX_CLASS_2D:
        mag = (c3(levels[row, col + 1]) + c3(levels[row + 1, col]) +
               c3(levels[row + 1, col + 1]) + c3(levels[row, col + 2]) +
               c3(levels[row + 2, col]))
        ctx = min((mag + 1) >> 1, 4)
        if row == 0 and col == 0:
            return 0
        return ctx + _nz_map_ctx_offset_2d(row, col, real_w, real_h)
    if tx_class == TX_CLASS_HORIZ:
        mag = (c3(levels[row, col + 1]) + c3(levels[row + 1, col]) +
               c3(levels[row, col + 2]) + c3(levels[row, col + 3]) +
               c3(levels[row, col + 4]))
        ctx = min((mag + 1) >> 1, 4)
        pos = col
    else:
        mag = (c3(levels[row, col + 1]) + c3(levels[row + 1, col]) +
               c3(levels[row + 2, col]) + c3(levels[row + 3, col]) +
               c3(levels[row + 4, col]))
        ctx = min((mag + 1) >> 1, 4)
        pos = row
    if pos == 0:
        return ctx + 26
    if pos == 1:
        return ctx + 31
    return ctx + 36


def base_eob_ctx(scan_idx: int, w: int, h: int) -> int:
    """get_lower_levels_ctx_eob: 0..3."""
    if scan_idx == 0:
        return 0
    n = w * h
    if scan_idx <= n // 8:
        return 1
    if scan_idx <= n // 4:
        return 2
    return 3


def br_ctx(levels: np.ndarray, row: int, col: int, tx_class: int) -> int:
    """get_br_ctx: 0..20."""
    mag = int(levels[row, col + 1]) + int(levels[row + 1, col])
    if tx_class == TX_CLASS_2D:
        mag += int(levels[row + 1, col + 1])
        mag = min((mag + 1) >> 1, 6)
        if row == 0 and col == 0:
            return mag
        if row < 2 and col < 2:
            return mag + 7
    elif tx_class == TX_CLASS_HORIZ:
        mag += int(levels[row, col + 2])
        mag = min((mag + 1) >> 1, 6)
        if row == 0 and col == 0:
            return mag
        if col == 0:
            return mag + 7
    else:
        mag += int(levels[row + 2, col])
        mag = min((mag + 1) >> 1, 6)
        if row == 0 and col == 0:
            return mag
        if row == 0:
            return mag + 7
    return mag + 14


_SKIP_CONTEXTS = np.array([
    [1, 2, 2, 2, 3],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 6]], np.int32)

COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = (1 << COEFF_CONTEXT_BITS) - 1  # 63


def txb_skip_ctx(above_ctx: np.ndarray, left_ctx: np.ndarray, plane: int,
                 tx_covers_block: bool, plane_bsize_larger: bool) -> int:
    """get_txb_skip_ctx over the per-4px entropy-context spans of this txb.

    above_ctx/left_ctx: packed bytes (cul|sign<<6) spanning the txb width /
    height in 4-px units."""
    if plane == 0:
        if tx_covers_block:
            return 0
        top = 0
        left = 0
        for v in above_ctx:
            top |= int(v)
        for v in left_ctx:
            left |= int(v)
        top &= COEFF_CONTEXT_MASK
        left &= COEFF_CONTEXT_MASK
        mx = min(top | left, 4)
        mn = min(min(top, left), 4)
        return int(_SKIP_CONTEXTS[mn][mx])
    ca = int(any((int(v) & COEFF_CONTEXT_MASK) != 0 for v in above_ctx))
    cl = int(any((int(v) & COEFF_CONTEXT_MASK) != 0 for v in left_ctx))
    return 7 + (3 if plane_bsize_larger else 0) + ca + cl


def dc_sign_ctx(above_ctx: np.ndarray, left_ctx: np.ndarray) -> int:
    """get_dc_sign_ctx from packed neighbor bytes (sign field in bits 6-7)."""
    dc = 0
    for v in above_ctx:
        s = int(v) >> COEFF_CONTEXT_BITS
        if s == 1:
            dc -= 1
        elif s == 2:
            dc += 1
    for v in left_ctx:
        s = int(v) >> COEFF_CONTEXT_BITS
        if s == 1:
            dc -= 1
        elif s == 2:
            dc += 1
    if dc > 0:
        return 2
    if dc < 0:
        return 1
    return 0


# --- the txb encoder --------------------------------------------------------

def encode_txb(enc: RangeEncoder, fc, qcoeff: np.ndarray, tx_size: int,
               tx_type: int, plane_type: int, skip_ctx: int,
               sign_ctx: int) -> int:
    """Encode one transform block's coefficients (after the all_zero symbol
    has been decided). qcoeff: compact (ch, cw) int32. Returns the packed
    cul_level byte for neighbor entropy-context updates.

    Caller has already written the txb_skip symbol (and tx_type if any); this
    writes eob, base levels, br, signs, golomb — in the reference's exact
    symbol order so CDF adaptation states match the decoder."""
    adj = adjusted_tx_size(tx_size)
    w, h = TX_SIZE_WIDE[adj], TX_SIZE_HIGH[adj]
    real_w, real_h = TX_SIZE_WIDE[tx_size], TX_SIZE_HIGH[tx_size]
    assert qcoeff.shape == (h, w)
    txs_ctx = txs_entropy_ctx(tx_size)
    tx_class = tx_class_of(tx_type)
    scan = get_scan(tx_size, tx_type)
    flat = qcoeff.reshape(-1)
    nz = np.nonzero(flat[scan])[0]
    assert len(nz) > 0, "all-zero blocks take the txb_skip path"
    eob = int(nz[-1]) + 1

    # eob position token
    ems = eob_multi_size(tx_size)
    eob_pt, extra, nbits = get_eob_pos_token(eob)
    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    cdf = fc.eob_flag(ems)[plane_type][eob_multi_ctx]
    enc.encode_symbol(eob_pt - 1, cdf, nsyms=ems + 5, adapt=True)
    if nbits > 0:
        hi = (extra >> (nbits - 1)) & 1
        # 22-context legacy layout indexed by eob_pt directly
        # (ref: entropy_coding.c:553 eob_extra_cdf[txs_ctx][ptype][eob_pt])
        enc.encode_symbol(
            hi, fc.eob_extra[txs_ctx][plane_type][eob_pt], adapt=True)
        for i in range(1, nbits):
            enc.encode_literal((extra >> (nbits - 1 - i)) & 1, 1)

    levels = init_levels(qcoeff)
    # reverse-scan base levels + interleaved br
    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        row, col = pos >> w.bit_length() - 1, pos & (w - 1)
        level = abs(int(flat[pos]))
        if c == eob - 1:
            ctx = base_eob_ctx(c, w, h)
            enc.encode_symbol(
                min(level, 3) - 1,
                fc.coeff_base_eob[txs_ctx][plane_type][ctx], adapt=True)
        else:
            ctx = base_ctx(levels, row, col, w, h, tx_class, real_w, real_h)
            enc.encode_symbol(
                min(level, 3),
                fc.coeff_base[txs_ctx][plane_type][ctx], adapt=True)
        if level > NUM_BASE_LEVELS:
            bctx = br_ctx(levels, row, col, tx_class)
            cdf_br = fc.coeff_br[min(txs_ctx, MAX_TX_32_CTX)][plane_type][bctx]
            base_range = level - 1 - NUM_BASE_LEVELS
            idx = 0
            while idx < COEFF_BASE_RANGE:
                k = min(base_range - idx, BR_CDF_SIZE - 1)
                enc.encode_symbol(k, cdf_br, nsyms=BR_CDF_SIZE, adapt=True)
                if k < BR_CDF_SIZE - 1:
                    break
                idx += BR_CDF_SIZE - 1

    # forward: signs + golomb residuals
    cul_level = 0
    for c in range(eob):
        pos = int(scan[c])
        v = int(flat[pos])
        level = abs(v)
        cul_level += level
        if level:
            if c == 0:
                enc.encode_symbol(1 if v < 0 else 0,
                                  fc.dc_sign[plane_type][sign_ctx], adapt=True)
            else:
                enc.encode_literal(1 if v < 0 else 0, 1)
            if level > COEFF_BASE_RANGE + NUM_BASE_LEVELS:
                enc.encode_golomb(level - COEFF_BASE_RANGE - 1 -
                                  NUM_BASE_LEVELS)

    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    dc = int(flat[int(scan[0])])
    if dc < 0:
        cul_level |= 1 << COEFF_CONTEXT_BITS
    elif dc > 0:
        cul_level += 2 << COEFF_CONTEXT_BITS
    return cul_level
