"""The work of one decide (intra_decide_packed) counted from the
algorithm, as benchmark/reference/programs.py intra_decide defines it,
not from any implementation of it: the yardstick decide_roofline reads,
and the one a hand-written decide kernel is later judged by.

Bytes: the padded 8-bit (or 16-bit) luma plane read once, and the packed
result written once (a split flag per 64, 32 and 16 block, and the top
N_CANDS modes per block at every size, one byte each).

Operations, integer, for each block size from 64 down to min_block and
each pixel of the plane (every pixel lies in one block of each size):

- the 13 modes' predicted pixels: DC, V and H copy a block value or an
  edge pixel (0); SMOOTH takes four products, four adds and a shift (9);
  SMOOTH_V and SMOOTH_H two products, two adds and a shift (5 each);
  PAETH the base (2), three differences with their absolutes (6), three
  compares and two selects (13); each of the 6 directional modes the
  interpolation's weight (1), two products, two adds and a shift, the
  choice between interpolated and fill value (1) and the clamp to the
  pixel range (2) (9 each): 86;
- each mode's absolute difference against the source, added into the
  block's sum: a difference, an absolute and an add (3 x 13 = 39);

and for each node of the split tree above min_block, the four children's
costs added (3), the split bias added (1), the compare and the select
(6). Left out, as small beside these: the edges' gathering and sums, the
per-block minimum and the stable sort of 13 costs.

The operations' peak is the card's 32-bit integer lanes: 64 per SM and
clock (four partitions of 16 INT32 units), 132 SMs on the H100 SXM, at
its 1,980 MHz boost clock: 1.6727e13 operations/s, the rate PERF.md's K1
floor uses. It lives here, with its derivation,
beside the bytes' peak that peaks.json gives (hbm_bytes_per_s)."""

N_CANDS = 3
MODES = 13
PRED_OPS = 0 + 0 + 0 + 9 + 5 + 5 + 13 + 6 * 9     # per predicted pixel set
SAD_OPS = 3 * MODES
SPLIT_NODE_OPS = 6
INT_LANES_PER_SM_CLOCK = 64
SMS = 132
CLOCK_HZ = 1.98e9
INT_OPS_PER_S = {"NVIDIA H100 80GB HBM3":
                 INT_LANES_PER_SM_CLOCK * SMS * CLOCK_HZ}


def padded(h: int, w: int) -> tuple:
    """The plane the program runs on: whole superblocks of 64."""
    return -(-h // 64) * 64, -(-w // 64) * 64


def _sizes(min_block: int) -> list:
    return [s for s in (64, 32, 16, 8) if s >= min_block]


def bytes_moved(h: int, w: int, pixel_bytes: int = 1) -> int:
    """The padded plane (h, w) read once, the packed result written once."""
    out = sum((h // s) * (w // s) for s in (64, 32, 16))
    out += N_CANDS * sum((h // s) * (w // s) for s in (64, 32, 16, 8))
    return h * w * pixel_bytes + out


def operations(h: int, w: int, min_block: int = 8) -> int:
    """Integer operations of one decide on the padded plane (h, w)."""
    sizes = _sizes(min_block)
    ops = len(sizes) * h * w * (PRED_OPS + SAD_OPS)
    ops += SPLIT_NODE_OPS * sum((h // s) * (w // s) for s in sizes[:-1])
    return ops


def least_s(h: int, w: int, pixel_bytes: int, min_block: int,
            hbm_bytes_per_s: float, int_ops_per_s: float) -> float:
    """The least time of one decide: the larger of its bytes at the HBM
    peak and its operations at the integer-lane peak."""
    return max(bytes_moved(h, w, pixel_bytes) / hbm_bytes_per_s,
               operations(h, w, min_block) / int_ops_per_s)
