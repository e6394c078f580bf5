"""intra_walk_tile_imbalance (%, SVT_TRACE spans `walk_tile`): how far the
slowest tile sets a key frame's walk: 100 * (the slowest tile's wall time
/ the mean tile's - 1), averaged over the window's intra walks."""

import harness


def read(ctx):
    walks = harness.load_module("metrics", "_intra_spans").key_tiles(ctx)
    if walks is None:
        return None
    vals = []
    for tiles in walks.values():
        walls = [t["t1"] - t["t0"] for t in tiles]
        mean = sum(walls) / len(walls)
        if mean > 0:
            vals.append(100.0 * (max(walls) / mean - 1.0))
    if not vals:
        return None
    return sum(vals) / len(vals)
