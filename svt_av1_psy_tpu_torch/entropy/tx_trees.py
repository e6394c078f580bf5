"""TX-size tree helpers (spec Split_Tx_Size / depth mappings).

Shared by the tile writer (signal side) and conformance parser (read side).
"""

from __future__ import annotations

from svt_av1_psy_tpu_torch.constants import TX_SIZE_SQR_UP, BlockSize, TxSize
from svt_av1_psy_tpu_torch.entropy.tile_writer import MAX_TX_SIZE_RECT

# tx size -> next smaller in the depth tree (spec Split_Tx_Size)
SUB_TX = [
    TxSize.TX_4X4, TxSize.TX_4X4, TxSize.TX_8X8, TxSize.TX_16X16,
    TxSize.TX_32X32, TxSize.TX_4X4, TxSize.TX_4X4, TxSize.TX_8X8,
    TxSize.TX_8X8, TxSize.TX_16X16, TxSize.TX_16X16, TxSize.TX_32X32,
    TxSize.TX_32X32, TxSize.TX_4X8, TxSize.TX_8X4, TxSize.TX_8X16,
    TxSize.TX_16X8, TxSize.TX_16X32, TxSize.TX_32X16,
]


def max_tx_depth(bsize: int) -> int:
    """bsize_to_max_depth (libaom): intra tx split depth limit (<= 2)."""
    tx = int(MAX_TX_SIZE_RECT[bsize])
    depth = 0
    while tx != int(TxSize.TX_4X4) and depth < 2:
        depth += 1
        tx = int(SUB_TX[tx])
    return depth


def tx_size_cat(bsize: int) -> int:
    """bsize_to_tx_size_cat: TX_SIZE_SQR_UP(max rect tx) - 1, max 3."""
    tx = int(MAX_TX_SIZE_RECT[bsize])
    return min(TX_SIZE_SQR_UP[tx], 4) - 1


def max_uv_tx_size(bsize: int, ss_x: int = 1, ss_y: int = 1) -> int:
    """Largest chroma tx size for a block (ref av1_get_max_uv_txsize):
    the max rect tx of the subsampled plane block, capped at 32x32."""
    from svt_av1_psy_tpu_torch.constants import (BLOCK_SIZE_HIGH, BLOCK_SIZE_WIDE,
                                           TX_SIZE_HIGH, TX_SIZE_WIDE)
    from svt_av1_psy_tpu_torch.entropy.tile_writer import MAX_TX_SIZE_RECT
    bw = max(4, BLOCK_SIZE_WIDE[bsize] >> ss_x)
    bh = max(4, BLOCK_SIZE_HIGH[bsize] >> ss_y)
    # find the plane bsize with those dims, then its max rect tx
    for b in range(len(BLOCK_SIZE_WIDE)):
        if BLOCK_SIZE_WIDE[b] == bw and BLOCK_SIZE_HIGH[b] == bh:
            ts = int(MAX_TX_SIZE_RECT[b])
            # cap at 32 per side (TX_32X32 ceiling for chroma)
            while TX_SIZE_WIDE[ts] > 32 or TX_SIZE_HIGH[ts] > 32:
                from svt_av1_psy_tpu_torch.entropy.tx_trees import SUB_TX
                ts = int(SUB_TX[ts])
            return ts
    raise ValueError((bsize, bw, bh))
