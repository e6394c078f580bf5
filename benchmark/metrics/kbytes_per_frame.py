"""kbytes_per_frame (KiB/frame): payload bytes of the frames that
encode_fps counts, over their number (hidden anchors and shown-existing
units included in their mini-GoP's bytes)."""


def read(ctx):
    if not ctx.frames:
        return None
    return ctx.bytes / 1024.0 / ctx.frames
