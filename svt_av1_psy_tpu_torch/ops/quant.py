"""AV1 quantization / dequantization — reference-exact integer math.

Forward quantizer mirrors the reference's quantize_b path
(ref: Source/Lib/Codec/full_loop.c svt_aom_quantize_b_c:78 and the
av1_build_quantizer table construction in Source/Lib/Codec/av1_quantize.c);
dequant is decoder-normative (spec 7.12.3). All functions are batched numpy
over arbitrary leading dims; the JAX path reuses the same arithmetic (integer
ops vectorize cleanly on the VPU).

PSY hook: `sharpness_bias` shrinks the zero-bin and grows rounding exactly the
way the PSY fork biases qzbin_factor/rounding for --sharpness > 0
(ref: Source/Lib/Codec/md_config_process.c:96-117).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from svt_av1_psy_tpu_torch.constants import TX_SIZE_HIGH, TX_SIZE_WIDE, TxSize, tables

AOM_QM_BITS = 5
QM_LEVELS = 16

# av1_get_adjusted_tx_size: 64-side sizes reuse the 32-side matrices/scan.
ADJUSTED_TX_SIZE = {
    TxSize.TX_64X64: TxSize.TX_32X32,
    TxSize.TX_64X32: TxSize.TX_32X32,
    TxSize.TX_32X64: TxSize.TX_32X32,
    TxSize.TX_16X64: TxSize.TX_16X32,
    TxSize.TX_64X16: TxSize.TX_32X16,
}


def adjusted_tx_size(ts: int) -> int:
    return int(ADJUSTED_TX_SIZE.get(TxSize(ts), TxSize(ts)))


def tx_scale(ts: int) -> int:
    """av1_get_tx_scale: extra downshift for big transforms."""
    pels = TX_SIZE_WIDE[ts] * TX_SIZE_HIGH[ts]
    return (pels > 256) + (pels > 1024)


def dc_q(qindex: int, bd: int = 8) -> int:
    assert bd in (8, 10), f"bit depth {bd} unsupported (no 12-bit tables)"
    return int(tables()["dc_qlookup"][0 if bd == 8 else 1][
        int(np.clip(qindex, 0, 255))])


def ac_q(qindex: int, bd: int = 8) -> int:
    assert bd in (8, 10), f"bit depth {bd} unsupported (no 12-bit tables)"
    return int(tables()["ac_qlookup"][0 if bd == 8 else 1][
        int(np.clip(qindex, 0, 255))])


@functools.lru_cache(maxsize=None)
def _qm_offset(adj_ts: int) -> int:
    """Offset of a (non-64) tx size in the flat 3344-entry QM tables,
    following libaom av1_qm_init's TX_SIZES_ALL traversal."""
    off = 0
    for t in range(19):
        if adjusted_tx_size(t) != t:
            continue
        if t == adj_ts:
            return off
        off += TX_SIZE_WIDE[t] * TX_SIZE_HIGH[t]
    raise ValueError(adj_ts)


def qm_matrix(level: int, plane: int, ts: int) -> np.ndarray | None:
    """Forward QM weights (Q5) raster-order, shape (ch, cw); None = flat."""
    if level >= QM_LEVELS - 1:
        return None
    adj = adjusted_tx_size(ts)
    w, h = TX_SIZE_WIDE[adj], TX_SIZE_HIGH[adj]
    off = _qm_offset(adj)
    flat = tables()["qm_wt"][level, 1 if plane else 0][off:off + w * h]
    return flat.reshape(h, w).astype(np.int32)


def iqm_matrix(level: int, plane: int, ts: int) -> np.ndarray | None:
    if level >= QM_LEVELS - 1:
        return None
    adj = adjusted_tx_size(ts)
    w, h = TX_SIZE_WIDE[adj], TX_SIZE_HIGH[adj]
    off = _qm_offset(adj)
    flat = tables()["qm_iwt"][level, 1 if plane else 0][off:off + w * h]
    return flat.reshape(h, w).astype(np.int32)


def get_qmlevel(qindex: int, first: int, last: int, tune: int = 1) -> int:
    """Frame QM level from qindex (ref md_config_process.c:175-215).

    tune 0/1: linear aom_get_qmlevel; tune 2/3: PSY sigmoidal curve
    (psy_get_qmlevel); tune 4: still-picture polynomial
    (psy_still_get_qmlevel)."""
    import math

    if tune in (2, 3):
        s = 2.0 / (1.0 + math.exp(0.01 * qindex))
        v = int(round(first + (qindex ** s) * (last + 1 - first) /
                      (256.0 ** s)))
        return int(np.clip(v, first, last))
    if tune == 4:
        coeffs = [1.10464272e-14, -9.78597634e-12, 3.46261763e-09,
                  -6.26759877e-07, 6.10876647e-05, -3.04942759e-03,
                  4.79930113e-02, 9.86922373e+00]
        result, x = 0.0, 1.0
        for c in reversed(coeffs):
            result += c * x
            x *= qindex
        return int(np.clip(int(round(result)), first, last))
    return first + (qindex * (last + 1 - first)) // 256


def _invert_quant(d: int) -> tuple[int, int]:
    """libaom invert_quant: returns (quant_q16_minus_65536, shift)."""
    t = d
    l = 0
    while t > 1:
        t >>= 1
        l += 1
    m = 1 + (1 << (16 + l)) // d
    return m - (1 << 16), 1 << (16 - l)


@dataclass
class PlaneQuant:
    """Per-plane quantizer tables; index 0 = DC, 1 = AC."""
    zbin: np.ndarray          # (2,) int32
    round: np.ndarray         # (2,) int32
    quant: np.ndarray         # (2,) int32 (q16 - 65536, may be negative)
    quant_shift: np.ndarray   # (2,) int32
    dequant: np.ndarray       # (2,) int32


def sharpness_factors(qindex: int, base_q: int, sharpness: int, bd: int):
    """PSY sharpness quant bias (ref md_config_process.c:96-117):
    positive sharpness shrinks the zbin and raises rounding for qindexes
    BELOW the frame base (delta-q boosted blocks keep more energy);
    negative does the reverse above the base. Returns
    (qzbin_factor, qrounding_factor)."""
    if qindex == 0:
        qzbin = 64
    else:
        qzbin = 84 if dc_q(qindex, bd) < (148 << (2 * (bd - 8) // 2)) \
            else 80
    qround = 64 if qindex == 0 else 48
    if sharpness:
        diff = qindex - base_q
        if sharpness > 0 and diff < 0:
            adj = max(sharpness << 1, abs(diff))
            qzbin -= adj
            qround += adj
        elif sharpness < 0 and diff > 0:
            adj = min((-sharpness) << 1, diff)
            qzbin += adj
            qround -= adj
        qzbin = min(max(qzbin, 1), 256)
        qround = min(max(qround, 1), 256)
    return qzbin, qround


def build_plane_quant(qindex: int, dc_delta: int = 0, ac_delta: int = 0,
                      bd: int = 8, sharpness_bias: int = 0,
                      sharpness: int = 0, base_q: int = -1) -> PlaneQuant:
    """av1_build_quantizer for one plane at one qindex.

    sharpness_bias in [-7..7]: legacy uniform bias (slow path);
    sharpness/base_q: the reference's diff-based PSY rule."""
    dcq = dc_q(int(np.clip(qindex + dc_delta, 0, 255)), bd)
    acq = ac_q(int(np.clip(qindex + ac_delta, 0, 255)), bd)
    if sharpness and base_q >= 0:
        qzbin_factor, qrounding_factor = sharpness_factors(
            qindex, base_q, sharpness, bd)
    else:
        # get_qzbin_factor: threshold scales 4x per 2 extra bits of depth
        if qindex == 0:
            qzbin_factor = 64
        else:
            qzbin_factor = 84 if dc_q(qindex, bd) < \
                (148 << (2 * (bd - 8) // 2)) else 80
        qrounding_factor = 64 if qindex == 0 else 48
        if sharpness_bias > 0:
            qzbin_factor = max(qzbin_factor - sharpness_bias * 2, 64)
            qrounding_factor = min(qrounding_factor + sharpness_bias * 2,
                                   63 + 1)
    zbin = np.zeros(2, np.int32)
    rnd = np.zeros(2, np.int32)
    q = np.zeros(2, np.int32)
    qs = np.zeros(2, np.int32)
    dq = np.zeros(2, np.int32)
    for i, d in enumerate((dcq, acq)):
        qq, sh = _invert_quant(d)
        q[i] = qq
        qs[i] = sh
        zbin[i] = (qzbin_factor * d + 64) >> 7          # ROUND_POWER_OF_TWO(,7)
        rnd[i] = (qrounding_factor * d) >> 7
        dq[i] = d
    return PlaneQuant(zbin=zbin, round=rnd, quant=q, quant_shift=qs, dequant=dq)


def quantize_b(coeff: np.ndarray, ts: int, pq: PlaneQuant,
               qm: np.ndarray | None = None,
               iqm: np.ndarray | None = None):
    """Reference-exact quantize_b over batched blocks.

    coeff: int (..., ch, cw) transform output (compact for 64-side).
    Returns (qcoeff int32, dqcoeff int32) same shape. eob is computed
    separately from the scan (entropy layer owns scan order).
    """
    log_scale = tx_scale(ts)
    c = coeff.astype(np.int64)
    ch, cw = c.shape[-2:]
    is_dc = np.zeros((ch, cw), bool)
    is_dc[0, 0] = True
    # ROUND_POWER_OF_TWO(zbin, log_scale)
    zbin = np.where(is_dc,
                    (int(pq.zbin[0]) + (1 << log_scale >> 1)) >> log_scale,
                    (int(pq.zbin[1]) + (1 << log_scale >> 1)) >> log_scale)
    rnd = np.where(is_dc,
                   (int(pq.round[0]) + (1 << log_scale >> 1)) >> log_scale,
                   (int(pq.round[1]) + (1 << log_scale >> 1)) >> log_scale)
    quant = np.where(is_dc, int(pq.quant[0]), int(pq.quant[1]))
    qshift = np.where(is_dc, int(pq.quant_shift[0]), int(pq.quant_shift[1]))
    deq = np.where(is_dc, int(pq.dequant[0]), int(pq.dequant[1]))

    wt = np.full((ch, cw), 1 << AOM_QM_BITS, np.int64) if qm is None \
        else qm.astype(np.int64)
    iwt = np.full((ch, cw), 1 << AOM_QM_BITS, np.int64) if iqm is None \
        else iqm.astype(np.int64)

    sign = np.where(c < 0, -1, 1)
    abs_c = np.abs(c)
    nz = abs_c * wt >= (zbin << AOM_QM_BITS)

    tmp = np.clip(abs_c + rnd, -32768, 32767) * wt
    # ((((tmp * quant) >> 16) + tmp) * quant_shift) >> (16 - log_scale + QM)
    tmp32 = ((((tmp * quant) >> 16) + tmp) * qshift) >> (
        16 - log_scale + AOM_QM_BITS)
    tmp32 = np.where(nz, tmp32, 0)
    dequant_w = (deq * iwt + (1 << (AOM_QM_BITS - 1))) >> AOM_QM_BITS
    abs_dq = (tmp32 * dequant_w) >> log_scale
    return (tmp32 * sign).astype(np.int32), (abs_dq * sign).astype(np.int32)


def dequant_coeffs(qcoeff: np.ndarray, ts: int, pq: PlaneQuant,
                   iqm: np.ndarray | None = None) -> np.ndarray:
    """Decoder-normative dequant (spec 7.12.3) for conformance checking."""
    log_scale = tx_scale(ts)
    ch, cw = qcoeff.shape[-2:]
    is_dc = np.zeros((ch, cw), bool)
    is_dc[0, 0] = True
    deq = np.where(is_dc, int(pq.dequant[0]), int(pq.dequant[1])).astype(np.int64)
    iwt = np.full((ch, cw), 1 << AOM_QM_BITS, np.int64) if iqm is None \
        else iqm.astype(np.int64)
    dqv = (deq * iwt + (1 << (AOM_QM_BITS - 1))) >> AOM_QM_BITS
    q = qcoeff.astype(np.int64)
    sign = np.where(q < 0, -1, 1)
    dq = ((np.abs(q) * dqv) & 0xFFFFFF) >> log_scale
    return (dq * sign).astype(np.int32)
