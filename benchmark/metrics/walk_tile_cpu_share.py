"""walk_tile_cpu_share (%, SVT_TRACE spans `walk_tile`): how much of its
wall time a tile of the inter walk had a core: 100 * the CPU time the
tile threads spent (thread_time_ns) / their wall time, summed over the
window's inter walks. Below 100 the tile threads wait for cores."""

import harness


def read(ctx):
    walks = harness.load_module("metrics", "_program_spans").inter_tiles(ctx)
    if walks is None:
        return None
    tiles = [t for v in walks.values() for t in v]
    wall = sum(t["t1"] - t["t0"] for t in tiles)
    if wall <= 0:
        return None
    return 100.0 * sum(t["cpu_ns"] for t in tiles) / wall
