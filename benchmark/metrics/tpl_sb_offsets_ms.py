"""tpl_sb_offsets_ms (ms, the harness's span around each call): the
command's lookahead offsets (models/tpl.py tpl_sb_offsets: 3 K1 searches
and the host splat), the mean per call, one call per frame, in the
window."""


def read(ctx):
    spans = ctx.spans.get("tpl_sb_offsets")
    if not spans:
        return None
    return 1000.0 * sum(spans) / len(spans)
