"""Bridge between the C API (native/capi_backend.c) and api.Encoder.

The C side passes raw plane pointers; this module wraps them as numpy
views (zero-copy) and returns coded packets as (bytes, pts) tuples the
C side queues for svt_tpu_enc_get_packet (the output-stream FIFO role
of ref Source/Lib/Globals/enc_handle.c:5983).

The port's copy of svt_av1_psy_tpu/capi_bridge.py, which the port's shim
(libsvtav1_torch.so, built by svt_av1_psy_tpu_torch/capi_build.py from
the same native/capi_backend.c) imports. Only make_encoder differs: the
C config (native/capi.h SvtTpuConfig) has no device field, so a C caller
names the device with a staged parameter string that is exactly one
``device=<name>`` pair (``svt_tpu_enc_parse_parameter(h, "device=cpu")``;
default ``cuda``, which fails svt_tpu_enc_init on a machine without a
GPU, never encoding on the CPU instead).
"""
from __future__ import annotations

import ctypes

import numpy as np

from svt_av1_psy_tpu_torch.api import Encoder
from svt_av1_psy_tpu_torch.config import (DEFAULT, EncoderConfig,
                                          parse_parameter_string)


def make_encoder(width, height, bit_depth, enc_mode, crf, intra_period,
                 frame_rate, tile_columns, hierarchical_levels,
                 pred_structure, extra_params=()):
    cfg = EncoderConfig(
        enc_mode=enc_mode,
        intra_period_length=intra_period,
        frame_rate_numerator=frame_rate * 1000,
        frame_rate_denominator=1000,
        tile_columns=DEFAULT if tile_columns < 0 else tile_columns,
        hierarchical_levels=hierarchical_levels,
        pred_structure=pred_structure,
    ).with_crf(float(crf))
    # the device pair is taken out whole, before parse_parameter_string
    # splits its strings on ':' (which "cuda:1" contains)
    device = "cuda"
    for s in extra_params:
        if s.startswith("device="):
            device = s[len("device="):]
        else:
            cfg = parse_parameter_string(cfg, s)
    return Encoder(cfg, width, height, bit_depth=bit_depth, device=device)


def _plane(ptr: int, h: int, w: int, stride: int, bd: int) -> np.ndarray:
    ct = ctypes.c_uint8 if bd == 8 else ctypes.c_uint16
    n = stride * h
    buf = (ct * n).from_address(ptr)
    dt = np.uint8 if bd == 8 else np.uint16
    return np.frombuffer(buf, dtype=dt).reshape(h, stride)[:, :w]


def send_picture(enc: Encoder, y_ptr: int, y_stride: int, u_ptr: int,
                 v_ptr: int, uv_stride: int):
    bd = enc.cfg.encoder_bit_depth
    W, H = enc.width, enc.height
    cw, ch = (W + 1) // 2, (H + 1) // 2
    y = _plane(y_ptr, H, W, y_stride, bd).copy()
    u = _plane(u_ptr, ch, cw, uv_stride, bd).copy()
    v = _plane(v_ptr, ch, cw, uv_stride, bd).copy()
    pkts = enc.send_picture(y, u, v)
    return [(p.payload, int(p.display_idx)) for p in pkts]


def flush(enc: Encoder):
    return [(p.payload, int(p.display_idx)) for p in enc.flush()]
