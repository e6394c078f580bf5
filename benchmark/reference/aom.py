"""The reference decoder of the stream check: libaom, the AV1 reference
codec, through ctypes (the aom_decoder.h ABI of libaom 3.x). It imports
nothing of the encoder.

The library is the system's libaom.so.3 where there is one, else the copy
that an installed OpenCV wheel carries in its `<package>.libs` folder
(opencv-python bundles libaom with its FFmpeg). find_library() says which
one loaded; None where neither does.
"""

from __future__ import annotations

import ctypes as ct
import glob
import os
import sys

import numpy as np

_AOM_IMG_FMT_HIGHBITDEPTH = 0x800


class _Image(ct.Structure):
    _fields_ = [("fmt", ct.c_int), ("cp", ct.c_int), ("tc", ct.c_int),
                ("mc", ct.c_int), ("monochrome", ct.c_int),
                ("csp", ct.c_int), ("range", ct.c_int),
                ("w", ct.c_uint), ("h", ct.c_uint),
                ("bit_depth", ct.c_uint),
                ("d_w", ct.c_uint), ("d_h", ct.c_uint),
                ("r_w", ct.c_uint), ("r_h", ct.c_uint),
                ("x_chroma_shift", ct.c_uint),
                ("y_chroma_shift", ct.c_uint),
                ("planes", ct.c_void_p * 3), ("stride", ct.c_int * 3),
                ("bps", ct.c_int)]


class _DecCfg(ct.Structure):
    _fields_ = [("threads", ct.c_uint), ("w", ct.c_uint), ("h", ct.c_uint),
                ("allow_lowbitdepth", ct.c_uint)]


class _Ctx(ct.Structure):
    # aom_codec_ctx_t, with room to spare after its known fields
    _fields_ = [("name", ct.c_char_p), ("iface", ct.c_void_p),
                ("err", ct.c_int), ("err_detail", ct.c_char_p),
                ("init_flags", ct.c_long), ("config", ct.c_void_p),
                ("priv", ct.c_void_p), ("_pad", ct.c_byte * 64)]


_LIB = None
_PATH = None


def _candidates() -> list:
    out = ["libaom.so.3"]
    for p in sys.path:
        if p and os.path.isdir(p):
            out += sorted(glob.glob(os.path.join(p, "*.libs",
                                                 "libaom*.so*")))
    return out


def find_library():
    """The path of the libaom that loaded (None when none does)."""
    global _LIB, _PATH
    if _LIB is not None:
        return _PATH
    for path in _candidates():
        try:
            lib = ct.CDLL(path)
            lib.aom_codec_av1_dx.restype = ct.c_void_p
        except (OSError, AttributeError):
            continue
        lib.aom_codec_dec_init_ver.restype = ct.c_int
        lib.aom_codec_dec_init_ver.argtypes = [
            ct.POINTER(_Ctx), ct.c_void_p, ct.POINTER(_DecCfg), ct.c_long,
            ct.c_int]
        lib.aom_codec_decode.restype = ct.c_int
        lib.aom_codec_decode.argtypes = [ct.POINTER(_Ctx), ct.c_char_p,
                                         ct.c_size_t, ct.c_void_p]
        lib.aom_codec_get_frame.restype = ct.POINTER(_Image)
        lib.aom_codec_get_frame.argtypes = [ct.POINTER(_Ctx),
                                            ct.POINTER(ct.c_void_p)]
        lib.aom_codec_destroy.argtypes = [ct.POINTER(_Ctx)]
        lib.aom_codec_error.restype = ct.c_char_p
        lib.aom_codec_error.argtypes = [ct.POINTER(_Ctx)]
        _LIB, _PATH = lib, path
        return path
    return None


def _plane(img: _Image, i: int, w: int, h: int) -> np.ndarray:
    stride = img.stride[i]
    if img.fmt & _AOM_IMG_FMT_HIGHBITDEPTH:
        buf = (ct.c_uint16 * (stride // 2 * h)).from_address(img.planes[i])
        return np.ctypeslib.as_array(buf).reshape(h, stride // 2)[:, :w] \
            .copy()
    buf = (ct.c_uint8 * (stride * h)).from_address(img.planes[i])
    return np.ctypeslib.as_array(buf).reshape(h, stride)[:, :w].copy()


def decode(packets, threads: int = 4):
    """Decode temporal units in decode order; yields the shown frames'
    (y, u, v) planes in display order. Raises RuntimeError where libaom
    refuses a unit."""
    if find_library() is None:
        raise RuntimeError("libaom did not load")
    lib = _LIB
    ctx = _Ctx()
    cfg = _DecCfg(threads=threads, w=0, h=0, allow_lowbitdepth=1)
    iface = lib.aom_codec_av1_dx()
    # the ABI version the library was built with is not exported: probe
    if not any(lib.aom_codec_dec_init_ver(ct.byref(ctx), iface,
                                          ct.byref(cfg), 0, v) == 0
               for v in range(1, 32)):
        raise RuntimeError("aom_codec_dec_init_ver accepted no ABI version")
    try:
        for pkt in packets:
            if lib.aom_codec_decode(ct.byref(ctx), pkt, len(pkt), None):
                err = lib.aom_codec_error(ct.byref(ctx)) or b""
                raise RuntimeError("libaom: " + err.decode(errors="replace"))
            it = ct.c_void_p(None)
            while True:
                p = lib.aom_codec_get_frame(ct.byref(ctx), ct.byref(it))
                if not p:
                    break
                img = p.contents
                w, h = img.d_w, img.d_h
                cw = (w + (1 << img.x_chroma_shift) - 1) >> \
                    img.x_chroma_shift
                ch = (h + (1 << img.y_chroma_shift) - 1) >> \
                    img.y_chroma_shift
                yield (_plane(img, 0, w, h), _plane(img, 1, cw, ch),
                       _plane(img, 2, cw, ch))
    finally:
        lib.aom_codec_destroy(ct.byref(ctx))
