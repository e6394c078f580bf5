"""dav1d conformance-decoder oracle via ctypes.

Plays the role of the reference's libaom-backed RefDecoder
(ref: test/e2e_test/RefDecoder.{h,cc}, libaom_dependency.cmake): every
bitstream the encoder emits must decode cleanly AND decode to exactly the
encoder's own reconstruction. The system library `libdav1d.so.6` (dav1d
1.0.0) is used; structs below mirror its public ABI (include/dav1d/*.h at
that version).

Only used by tests / tools — never on the encode path.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

_lib = None


class _Dav1dDataProps(ctypes.Structure):
    _fields_ = [
        ("timestamp", ctypes.c_int64),
        ("duration", ctypes.c_int64),
        ("offset", ctypes.c_int64),
        ("size", ctypes.c_size_t),
        ("user_data_data", ctypes.c_void_p),
        ("user_data_ref", ctypes.c_void_p),
    ]


class _Dav1dData(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("sz", ctypes.c_size_t),
        ("ref", ctypes.c_void_p),
        ("m", _Dav1dDataProps),
    ]


class _Dav1dPictureParameters(ctypes.Structure):
    _fields_ = [
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
        ("layout", ctypes.c_int),  # 0=I400 1=I420 2=I422 3=I444
        ("bpc", ctypes.c_int),
    ]


class _Dav1dPicture(ctypes.Structure):
    _fields_ = [
        ("seq_hdr", ctypes.c_void_p),
        ("frame_hdr", ctypes.c_void_p),
        ("data", ctypes.c_void_p * 3),
        ("stride", ctypes.c_ssize_t * 2),
        ("p", _Dav1dPictureParameters),
        ("m", _Dav1dDataProps),
        ("content_light", ctypes.c_void_p),
        ("mastering_display", ctypes.c_void_p),
        ("itut_t35", ctypes.c_void_p),
        ("reserved", ctypes.c_size_t * 4),
        ("frame_hdr_ref", ctypes.c_void_p),
        ("seq_hdr_ref", ctypes.c_void_p),
        ("content_light_ref", ctypes.c_void_p),
        ("mastering_display_ref", ctypes.c_void_p),
        ("itut_t35_ref", ctypes.c_void_p),
        ("reserved_ref", ctypes.c_size_t * 4),
        ("ref", ctypes.c_void_p),
        ("allocator_data", ctypes.c_void_p),
    ]


class _Dav1dSettings(ctypes.Structure):
    _fields_ = [
        ("n_threads", ctypes.c_int),
        ("max_frame_delay", ctypes.c_int),
        ("apply_grain", ctypes.c_int),
        ("operating_point", ctypes.c_int),
        ("all_layers", ctypes.c_int),
        ("frame_size_limit", ctypes.c_uint),
        ("allocator", ctypes.c_uint8 * 24),  # Dav1dPicAllocator (opaque here)
        ("logger", ctypes.c_uint8 * 16),     # Dav1dLogger (opaque here)
        ("strict_std_compliance", ctypes.c_int),
        ("output_invisible_frames", ctypes.c_int),
        ("inloop_filters", ctypes.c_int),
        ("reserved", ctypes.c_uint8 * 20),
    ]


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL("libdav1d.so.6")
        lib.dav1d_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(_Dav1dSettings)]
        lib.dav1d_default_settings.argtypes = [ctypes.POINTER(_Dav1dSettings)]
        lib.dav1d_data_create.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.dav1d_data_create.argtypes = [ctypes.POINTER(_Dav1dData),
                                          ctypes.c_size_t]
        lib.dav1d_send_data.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(_Dav1dData)]
        lib.dav1d_get_picture.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(_Dav1dPicture)]
        lib.dav1d_picture_unref.argtypes = [ctypes.POINTER(_Dav1dPicture)]
        lib.dav1d_data_unref.argtypes = [ctypes.POINTER(_Dav1dData)]
        lib.dav1d_close.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        _lib = lib
    return _lib


@dataclass
class DecodedFrame:
    """Planes as numpy arrays: y (H,W), u/v subsampled per layout (or None)."""
    y: np.ndarray
    u: np.ndarray | None
    v: np.ndarray | None
    bit_depth: int
    layout: int  # 0=I400 1=I420 2=I422 3=I444


def _plane_from_ptr(ptr, stride, h, w, bpc) -> np.ndarray:
    itemsize = 1 if bpc == 8 else 2
    nbytes = stride * h
    buf = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes)).contents
    arr = np.frombuffer(buf, dtype=np.uint8 if bpc == 8 else np.uint16)
    arr = arr.reshape(h, stride // itemsize)[:, :w]
    return arr.copy()


class Dav1dDecoder:
    """Streaming decoder: feed OBU frames (no container), collect pictures."""

    def __init__(self, n_threads: int = 1, apply_grain: bool = True):
        lib = _load()
        s = _Dav1dSettings()
        lib.dav1d_default_settings(ctypes.byref(s))
        s.n_threads = n_threads
        s.apply_grain = 1 if apply_grain else 0
        self._ctx = ctypes.c_void_p()
        rc = lib.dav1d_open(ctypes.byref(self._ctx), ctypes.byref(s))
        if rc != 0:
            raise RuntimeError(f"dav1d_open failed: {rc}")

    def close(self):
        if self._ctx:
            _load().dav1d_close(ctypes.byref(self._ctx))
            self._ctx = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _get_picture(self) -> DecodedFrame | None:
        lib = _load()
        pic = _Dav1dPicture()
        rc = lib.dav1d_get_picture(self._ctx, ctypes.byref(pic))
        if rc == -11:  # EAGAIN
            return None
        if rc != 0:
            raise RuntimeError(f"dav1d_get_picture failed: {rc}")
        try:
            w, h, layout, bpc = pic.p.w, pic.p.h, pic.p.layout, pic.p.bpc
            y = _plane_from_ptr(pic.data[0], pic.stride[0], h, w, bpc)
            u = v = None
            if layout != 0:
                ss_hor = 1 if layout != 3 else 0
                ss_ver = 1 if layout == 1 else 0
                cw = (w + ss_hor) >> ss_hor
                ch = (h + ss_ver) >> ss_ver
                u = _plane_from_ptr(pic.data[1], pic.stride[1], ch, cw, bpc)
                v = _plane_from_ptr(pic.data[2], pic.stride[1], ch, cw, bpc)
            return DecodedFrame(y=y, u=u, v=v, bit_depth=bpc, layout=layout)
        finally:
            lib.dav1d_picture_unref(ctypes.byref(pic))

    def send(self, obu_bytes: bytes) -> list[DecodedFrame]:
        """Send one temporal unit; return any pictures that became ready."""
        lib = _load()
        data = _Dav1dData()
        ptr = lib.dav1d_data_create(ctypes.byref(data), len(obu_bytes))
        if not ptr:
            raise MemoryError("dav1d_data_create failed")
        ctypes.memmove(ptr, obu_bytes, len(obu_bytes))
        out: list[DecodedFrame] = []
        while True:
            rc = lib.dav1d_send_data(self._ctx, ctypes.byref(data))
            if rc == 0 and data.sz == 0:
                break
            if rc not in (0, -11):
                lib.dav1d_data_unref(ctypes.byref(data))
                raise RuntimeError(f"dav1d_send_data failed: {rc}")
            # consumed partially or decoder full: drain pictures, resend
            f = self._get_picture()
            if f is not None:
                out.append(f)
            if rc == 0 and data.sz == 0:
                break
        while True:
            f = self._get_picture()
            if f is None:
                break
            out.append(f)
        return out

    def flush(self) -> list[DecodedFrame]:
        out = []
        while True:
            try:
                f = self._get_picture()
            except RuntimeError:
                break
            if f is None:
                break
            out.append(f)
        return out


def parse_sequence_header(obu_bytes: bytes) -> bool:
    """Validate a sequence-header OBU with dav1d_parse_sequence_header.

    Returns True if dav1d accepts it (rc == 0)."""
    lib = _load()
    out = (ctypes.c_uint8 * 8192)()  # Dav1dSequenceHeader is ~1.5 KB
    buf = (ctypes.c_uint8 * len(obu_bytes)).from_buffer_copy(obu_bytes)
    rc = lib.dav1d_parse_sequence_header(out, buf, len(obu_bytes))
    return rc == 0


def decode_ivf(path_or_bytes) -> list[DecodedFrame]:
    """Decode a whole IVF file; returns all frames in display order."""
    from svt_av1_psy_tpu_torch.bitstream.ivf import read_ivf

    header, packets = read_ivf(path_or_bytes)
    dec = Dav1dDecoder()
    frames: list[DecodedFrame] = []
    try:
        for _pts, payload in packets:
            frames.extend(dec.send(payload))
        frames.extend(dec.flush())
    finally:
        dec.close()
    return frames


def decode_obus(data: bytes,
                apply_grain: bool = True) -> list[DecodedFrame]:
    """Decode a raw OBU stream (single temporal unit or concatenated TUs)."""
    dec = Dav1dDecoder(apply_grain=apply_grain)
    try:
        frames = dec.send(data)
        frames.extend(dec.flush())
    finally:
        dec.close()
    return frames
