"""ctypes binding for the system libaom decoder (cross-check oracle).

Second conformance decoder next to :mod:`svt_av1_psy_tpu.decoder.dav1d` —
when the two disagree on a stream we produced, the AV1 spec (and not either
decoder's quirk) decides. Mirrors the aom_decoder.h ABI of libaom 3.x.
"""
from __future__ import annotations

import ctypes as ct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from svt_av1_psy_tpu_torch.bitstream.ivf import read_ivf

_lib: Optional[ct.CDLL] = None
_abi_version: Optional[int] = None


class _AomImage(ct.Structure):
    _fields_ = [
        ("fmt", ct.c_int),
        ("cp", ct.c_int),
        ("tc", ct.c_int),
        ("mc", ct.c_int),
        ("monochrome", ct.c_int),
        ("csp", ct.c_int),
        ("range", ct.c_int),
        ("w", ct.c_uint),
        ("h", ct.c_uint),
        ("bit_depth", ct.c_uint),
        ("d_w", ct.c_uint),
        ("d_h", ct.c_uint),
        ("r_w", ct.c_uint),
        ("r_h", ct.c_uint),
        ("x_chroma_shift", ct.c_uint),
        ("y_chroma_shift", ct.c_uint),
        ("planes", ct.c_void_p * 3),
        ("stride", ct.c_int * 3),
        ("bps", ct.c_int),
        ("temporal_id", ct.c_int),
        ("spatial_id", ct.c_int),
        ("user_priv", ct.c_void_p),
        ("img_data", ct.c_void_p),
        ("img_data_owner", ct.c_int),
        ("self_allocd", ct.c_int),
        ("fb_priv", ct.c_void_p),
    ]


class _DecCfg(ct.Structure):
    _fields_ = [
        ("threads", ct.c_uint),
        ("w", ct.c_uint),
        ("h", ct.c_uint),
        ("allow_lowbitdepth", ct.c_uint),
    ]


class _Ctx(ct.Structure):
    # aom_codec_ctx_t with generous trailing padding for safety
    _fields_ = [
        ("name", ct.c_char_p),
        ("iface", ct.c_void_p),
        ("err", ct.c_int),
        ("err_detail", ct.c_char_p),
        ("init_flags", ct.c_long),
        ("config", ct.c_void_p),
        ("priv", ct.c_void_p),
        ("_pad", ct.c_byte * 64),
    ]


def _load() -> ct.CDLL:
    global _lib
    if _lib is None:
        _lib = ct.CDLL("libaom.so.3")
        _lib.aom_codec_av1_dx.restype = ct.c_void_p
        _lib.aom_codec_dec_init_ver.restype = ct.c_int
        _lib.aom_codec_dec_init_ver.argtypes = [
            ct.POINTER(_Ctx), ct.c_void_p, ct.POINTER(_DecCfg),
            ct.c_long, ct.c_int]
        _lib.aom_codec_decode.restype = ct.c_int
        _lib.aom_codec_decode.argtypes = [
            ct.POINTER(_Ctx), ct.c_char_p, ct.c_size_t, ct.c_void_p]
        _lib.aom_codec_get_frame.restype = ct.POINTER(_AomImage)
        _lib.aom_codec_get_frame.argtypes = [
            ct.POINTER(_Ctx), ct.POINTER(ct.c_void_p)]
        _lib.aom_codec_destroy.restype = ct.c_int
        _lib.aom_codec_destroy.argtypes = [ct.POINTER(_Ctx)]
        _lib.aom_codec_error_detail.restype = ct.c_char_p
        _lib.aom_codec_error_detail.argtypes = [ct.POINTER(_Ctx)]
        _lib.aom_codec_error.restype = ct.c_char_p
        _lib.aom_codec_error.argtypes = [ct.POINTER(_Ctx)]
    return _lib


def _init(ctx: _Ctx, cfg: _DecCfg) -> None:
    """Init the decoder, probing the ABI version the .so was built with."""
    global _abi_version
    lib = _load()
    iface = lib.aom_codec_av1_dx()
    versions = ([_abi_version] if _abi_version is not None
                else list(range(1, 32)))
    for ver in versions:
        rc = lib.aom_codec_dec_init_ver(ct.byref(ctx), iface,
                                        ct.byref(cfg), 0, ver)
        if rc == 0:
            _abi_version = ver
            return
    raise RuntimeError("aom_codec_dec_init_ver: no ABI version accepted")


@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    bit_depth: int


def _plane(img: _AomImage, i: int, w: int, h: int, hbd: bool) -> np.ndarray:
    stride = img.stride[i]
    if hbd:
        buf = (ct.c_uint16 * (stride // 2 * h)).from_address(img.planes[i])
        a = np.ctypeslib.as_array(buf).reshape(h, stride // 2)[:, :w]
    else:
        buf = (ct.c_uint8 * (stride * h)).from_address(img.planes[i])
        a = np.ctypeslib.as_array(buf).reshape(h, stride)[:, :w]
    return a.copy()


def decode_obus(packets: List[bytes]) -> List[DecodedFrame]:
    lib = _load()
    ctx = _Ctx()
    cfg = _DecCfg(threads=1, w=0, h=0, allow_lowbitdepth=1)
    _init(ctx, cfg)
    out: List[DecodedFrame] = []
    try:
        for pkt in packets:
            rc = lib.aom_codec_decode(ct.byref(ctx), pkt, len(pkt), None)
            if rc != 0:
                err = lib.aom_codec_error(ct.byref(ctx)) or b""
                detail = lib.aom_codec_error_detail(ct.byref(ctx)) or b""
                raise RuntimeError(
                    f"aom_codec_decode failed rc={rc} "
                    f"{err.decode()!r} {detail.decode()!r}")
            it = ct.c_void_p(None)
            while True:
                img_p = lib.aom_codec_get_frame(ct.byref(ctx), ct.byref(it))
                if not img_p:
                    break
                img = img_p.contents
                hbd = bool(img.fmt & 0x800)  # AOM_IMG_FMT_HIGHBITDEPTH
                w, h = img.d_w, img.d_h
                cw = (w + (1 << img.x_chroma_shift) - 1) >> img.x_chroma_shift
                ch = (h + (1 << img.y_chroma_shift) - 1) >> img.y_chroma_shift
                out.append(DecodedFrame(
                    y=_plane(img, 0, w, h, hbd),
                    u=_plane(img, 1, cw, ch, hbd),
                    v=_plane(img, 2, cw, ch, hbd),
                    bit_depth=img.bit_depth))
    finally:
        lib.aom_codec_destroy(ct.byref(ctx))
    return out


def decode_ivf(data: bytes) -> List[DecodedFrame]:
    _, frames = read_ivf(data)
    return decode_obus([payload for _, payload in frames])
