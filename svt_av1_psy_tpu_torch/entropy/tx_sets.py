"""AV1 extended transform-type sets (spec 5.11.47 / Ext_Tx tables).

Shared by the tile writer (forward permutation when signaling) and the
conformance parser (inverse permutation when reading). Chroma intra types
are derived, never signaled (spec compute_tx_type for plane > 0)."""

from __future__ import annotations

from svt_av1_psy_tpu_torch.constants import (TX_SIZE_SQR, TX_SIZE_SQR_UP, TxSize,
                                       TxType)

# intra mode -> tx type (libaom intra_mode_to_tx_type / ref mode2txfm)
MODE2TXFM = [
    TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST, TxType.DCT_DCT,
    TxType.ADST_ADST, TxType.ADST_DCT, TxType.DCT_ADST, TxType.DCT_ADST,
    TxType.ADST_DCT, TxType.ADST_ADST, TxType.ADST_DCT, TxType.DCT_ADST,
    TxType.ADST_ADST, TxType.DCT_DCT,  # UV_CFL -> DCT
]

# set index -> symbol order (spec Ext_Tx_Inv / ref cabac_context_model.h:695)
EXT_TX_INV = {
    1: [9, 0, 10, 11, 3, 1, 2],        # DTT4_IDTX_1DDCT (7 syms)
    2: [9, 0, 3, 1, 2],                # DTT4_IDTX (5 syms)
}
EXT_TX_FWD = {s: {t: i for i, t in enumerate(order)}
              for s, order in EXT_TX_INV.items()}
EXT_TX_SET_SIZES = {0: 1, 1: 7, 2: 5}

# filter-intra mode -> equivalent intra dir for tx-type cdf indexing
# (libaom fimode_to_intradir)
FIMODE_TO_INTRADIR = [0, 1, 2, 6, 0]   # DC, V, H, D157, PAETH->DC


def intra_tx_set(tx_size: int, reduced: bool) -> int:
    """Intra ext-tx-set index: 0 DCTONLY, 1 DTT4_IDTX_1DDCT, 2 DTT4_IDTX
    (libaom get_ext_tx_set_type for is_inter=0)."""
    if TX_SIZE_SQR_UP[tx_size] >= int(TxSize.TX_32X32):
        return 0
    if reduced:
        return 2
    return 2 if TX_SIZE_SQR[tx_size] == int(TxSize.TX_16X16) else 1


def uv_tx_type(uv_mode: int, tx_size: int, reduced: bool) -> int:
    """Chroma intra tx type (derived, spec compute_tx_type for plane>0)."""
    if TX_SIZE_SQR_UP[tx_size] > int(TxSize.TX_32X32):
        return int(TxType.DCT_DCT)
    t = int(MODE2TXFM[uv_mode])
    ts = intra_tx_set(tx_size, reduced)
    if ts == 0:
        return int(TxType.DCT_DCT)
    return t if t in EXT_TX_INV[ts] else int(TxType.DCT_DCT)


# --- inter tx sets (ref definitions.h get_ext_tx_set_type, av1_ext_tx_inv) --
# set TYPES: 0 DCTONLY, 1 DCT_IDTX, 2 DTT4_IDTX, 3 DTT4_IDTX_1DDCT,
#            4 DTT9_IDTX_1DDCT, 5 ALL16
EXT_TX_SET_TYPE_INV = {
    1: [9, 0],
    4: [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8],
    5: [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8],
}
EXT_TX_SET_TYPE_FWD = {
    1: [1] + [0] * 8 + [0] + [0] * 6,
    4: [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    5: [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6],
}
EXT_TX_SET_TYPE_SIZES = {0: 1, 1: 2, 2: 5, 3: 7, 4: 12, 5: 16}
# set type -> cdf row index (inter): ext_tx_set_index[1][...]
EXT_TX_SET_TYPE_TO_IDX_INTER = {0: 0, 1: 3, 4: 2, 5: 1}
# membership (av1_ext_tx_used)
EXT_TX_USED = {
    0: {0},
    1: {0, 9},
    2: {0, 1, 2, 3, 9},
    3: {0, 1, 2, 3, 9, 10, 11},
    4: {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    5: set(range(16)),
}


def inter_tx_set_type(tx_size: int, reduced: bool) -> int:
    from svt_av1_psy_tpu_torch.constants import TX_SIZE_SQR, TX_SIZE_SQR_UP
    up = TX_SIZE_SQR_UP[tx_size]     # TxSize enum of the square sup
    if up > 3:                       # larger than TX_32X32
        return 0
    if up == 3:                      # TX_32X32
        return 1
    if reduced:
        return 1
    return 4 if TX_SIZE_SQR[tx_size] == 2 else 5
