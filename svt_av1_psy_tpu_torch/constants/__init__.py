"""Normative AV1 constant tables + enums.

`av1_tables.npz` holds spec-mandated data (default CDFs, dequant lookups, scan
orders, quantizer matrices) extracted programmatically from the reference
implementation's tables (see tools/gen_spec_constants.py); these values are
identical in every conforming AV1 codec. Enums mirror the AV1 spec section 6.
"""

from __future__ import annotations

import functools
import pathlib
from enum import IntEnum

import numpy as np

_NPZ = pathlib.Path(__file__).parent / "av1_tables.npz"


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    """Load (once) every normative table as {name: np.ndarray}."""
    with np.load(_NPZ) as z:
        return {k: z[k] for k in z.files}


# --- Transform sizes (spec 6.10.2; TX_SIZES_ALL order) ---------------------
class TxSize(IntEnum):
    TX_4X4 = 0
    TX_8X8 = 1
    TX_16X16 = 2
    TX_32X32 = 3
    TX_64X64 = 4
    TX_4X8 = 5
    TX_8X4 = 6
    TX_8X16 = 7
    TX_16X8 = 8
    TX_16X32 = 9
    TX_32X16 = 10
    TX_32X64 = 11
    TX_64X32 = 12
    TX_4X16 = 13
    TX_16X4 = 14
    TX_8X32 = 15
    TX_32X8 = 16
    TX_16X64 = 17
    TX_64X16 = 18


TX_SIZES_ALL = 19
TX_SIZES = 5  # square only

TX_SIZE_WIDE = [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64]
TX_SIZE_HIGH = [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16]

# square size category of each tx size (for CDF indexing: TX_4X4..TX_64X64)
TX_SIZE_SQR = [0, 1, 2, 3, 4, 0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 2, 2]
# min(width,height) square, capped at 32 (TX_SIZE_SQR_UP capped for coef ctx)
TX_SIZE_SQR_UP = [0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 2, 2, 3, 3, 4, 4]


def tx_size_wide(ts: int) -> int:
    return TX_SIZE_WIDE[ts]


def tx_size_high(ts: int) -> int:
    return TX_SIZE_HIGH[ts]


# --- Transform types (spec 6.10.3) -----------------------------------------
class TxType(IntEnum):
    DCT_DCT = 0
    ADST_DCT = 1
    DCT_ADST = 2
    ADST_ADST = 3
    FLIPADST_DCT = 4
    DCT_FLIPADST = 5
    FLIPADST_FLIPADST = 6
    ADST_FLIPADST = 7
    FLIPADST_ADST = 8
    IDTX = 9
    V_DCT = 10
    H_DCT = 11
    V_ADST = 12
    H_ADST = 13
    V_FLIPADST = 14
    H_FLIPADST = 15


TX_TYPES = 16

# --- Block sizes (spec 6.10.4; BLOCK_SIZES_ALL order) -----------------------
class BlockSize(IntEnum):
    BLOCK_4X4 = 0
    BLOCK_4X8 = 1
    BLOCK_8X4 = 2
    BLOCK_8X8 = 3
    BLOCK_8X16 = 4
    BLOCK_16X8 = 5
    BLOCK_16X16 = 6
    BLOCK_16X32 = 7
    BLOCK_32X16 = 8
    BLOCK_32X32 = 9
    BLOCK_32X64 = 10
    BLOCK_64X32 = 11
    BLOCK_64X64 = 12
    BLOCK_64X128 = 13
    BLOCK_128X64 = 14
    BLOCK_128X128 = 15
    BLOCK_4X16 = 16
    BLOCK_16X4 = 17
    BLOCK_8X32 = 18
    BLOCK_32X8 = 19
    BLOCK_16X64 = 20
    BLOCK_64X16 = 21


BLOCK_SIZES_ALL = 22
BLOCK_SIZE_WIDE = [4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128,
                   4, 16, 8, 32, 16, 64]
BLOCK_SIZE_HIGH = [4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128,
                   16, 4, 32, 8, 64, 16]

# --- Intra prediction modes (spec 6.10.18) ----------------------------------
class PredMode(IntEnum):
    DC_PRED = 0
    V_PRED = 1
    H_PRED = 2
    D45_PRED = 3
    D135_PRED = 4
    D113_PRED = 5
    D157_PRED = 6
    D203_PRED = 7
    D67_PRED = 8
    SMOOTH_PRED = 9
    SMOOTH_V_PRED = 10
    SMOOTH_H_PRED = 11
    PAETH_PRED = 12
    UV_CFL_PRED = 13  # chroma only


INTRA_MODES = 13
UV_INTRA_MODES = 14
DIRECTIONAL_MODES = 8
MAX_ANGLE_DELTA = 3

# mode -> base angle (degrees) for directional modes (spec 8.?; Dr_Intra)
MODE_TO_ANGLE = {
    PredMode.V_PRED: 90, PredMode.H_PRED: 180, PredMode.D45_PRED: 45,
    PredMode.D135_PRED: 135, PredMode.D113_PRED: 113, PredMode.D157_PRED: 157,
    PredMode.D203_PRED: 203, PredMode.D67_PRED: 67,
}

# --- Partition types (spec 6.10.4) ------------------------------------------
class Partition(IntEnum):
    NONE = 0
    HORZ = 1
    VERT = 2
    SPLIT = 3
    HORZ_A = 4
    HORZ_B = 5
    VERT_A = 6
    VERT_B = 7
    HORZ_4 = 8
    VERT_4 = 9


EXT_PARTITION_TYPES = 10

# --- Quantization ------------------------------------------------------------
QINDEX_RANGE = 256
MAX_QINDEX = 255


def dc_q(qindex: int, bit_depth: int = 8) -> int:
    """Normative DC dequant step (spec 7.12.2)."""
    return int(tables()["dc_qlookup"][0 if bit_depth == 8 else 1][np.clip(qindex, 0, 255)])


def ac_q(qindex: int, bit_depth: int = 8) -> int:
    return int(tables()["ac_qlookup"][0 if bit_depth == 8 else 1][np.clip(qindex, 0, 255)])


def get_scan(tx_size: int, tx_type: int) -> np.ndarray:
    """Normative scan order (spec 5.11.41). For 64-side TXs the scan covers the
    up-to-32x32 kept coefficients only (the stored table may be over-length
    for 16x64/64x16 — slice to the compact area)."""
    n = (min(TX_SIZE_WIDE[tx_size], 32) * min(TX_SIZE_HIGH[tx_size], 32))
    return tables()[f"scan_{int(tx_size)}_{int(tx_type)}"][:n]


def coef_qctx(base_qindex: int) -> int:
    """Quantizer bin for coefficient CDF defaults (ref cabac_context_model.c:2274)."""
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3
