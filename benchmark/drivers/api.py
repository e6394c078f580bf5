"""Drives the encoder's API (svt_av1_psy_tpu_torch.api.Encoder) in random
access: send_picture per frame; packets come back a mini-GoP at a time.

Set-up builds the encoder at the configuration's size and bit depth, then
sends frames until the traffic's warm-up count of packet batches has come
back (the key frame and the first mini-GoP: the dispatch / walk pipeline
is full and every program has run once). The window then counts the
frames of each mini-GoP whose packets return inside it.
"""

from __future__ import annotations


def drive(ctx) -> None:
    from svt_av1_psy_tpu_torch.api import Encoder, EncoderConfig

    c = ctx.config
    enc = Encoder(EncoderConfig(**c["encoder"]), c["width"], c["height"],
                  bit_depth=c["bit_depth"], device=str(ctx.device))
    try:
        t = 0
        returned = 0
        while returned < ctx.traffic["warmup"]["ra_returns"]:
            if enc.send_picture(*ctx.source.frame(t)):
                returned += 1
            t += 1
        ctx.open_window()
        while ctx.in_window:
            pkts = enc.send_picture(*ctx.source.frame(t))
            t += 1
            if pkts:
                ctx.complete(sum(p.display_idx >= 0 for p in pkts),
                             sum(len(p.payload) for p in pkts))
            ctx.tick()
    finally:
        enc.close()
