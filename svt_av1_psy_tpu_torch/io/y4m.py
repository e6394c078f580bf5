"""Y4M (YUV4MPEG2) reader/writer.

Equivalent of the reference's app-side y4m probe/reader
(ref: Source/App/app_input_y4m.c:1-248) re-done as a Python iterator that
yields numpy planes. Supports 8-bit C420 and 10-bit C420p10 (the two formats
the encoder accepts, matching --input-depth 8/10).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional, Tuple, Union

import numpy as np

_MAGIC = b"YUV4MPEG2"

_COLORSPACE_MAP = {
    b"420": (8, 1, 1),
    b"420jpeg": (8, 1, 1),
    b"420mpeg2": (8, 1, 1),
    b"420paldv": (8, 1, 1),
    b"420p10": (10, 1, 1),
    b"mono": (8, 0, 0),
}


@dataclass
class Y4mHeader:
    width: int
    height: int
    fps_num: int
    fps_den: int
    bit_depth: int
    interlace: str = "p"
    aspect_num: int = 0
    aspect_den: int = 0
    colorspace: str = "420"

    @property
    def frame_size_bytes(self) -> int:
        bpp = 2 if self.bit_depth > 8 else 1
        luma = self.width * self.height
        chroma = (self.width // 2) * (self.height // 2)
        return (luma + 2 * chroma) * bpp


def parse_header(line: bytes) -> Y4mHeader:
    if not line.startswith(_MAGIC):
        raise ValueError("not a YUV4MPEG2 stream")
    hdr = Y4mHeader(width=0, height=0, fps_num=30, fps_den=1, bit_depth=8)
    for tok in line[len(_MAGIC):].split():
        tag, val = tok[:1], tok[1:]
        if tag == b"W":
            hdr.width = int(val)
        elif tag == b"H":
            hdr.height = int(val)
        elif tag == b"F":
            n, d = val.split(b":")
            hdr.fps_num, hdr.fps_den = int(n), int(d)
        elif tag == b"I":
            hdr.interlace = val.decode()
            if hdr.interlace not in ("p", "?"):
                raise ValueError("interlaced y4m is not supported")
        elif tag == b"A":
            n, d = val.split(b":")
            hdr.aspect_num, hdr.aspect_den = int(n), int(d)
        elif tag == b"C":
            cs = val.lower()
            if cs not in _COLORSPACE_MAP:
                raise ValueError(f"unsupported y4m colorspace {val!r} (420/420p10 only)")
            hdr.bit_depth = _COLORSPACE_MAP[cs][0]
            hdr.colorspace = cs.decode()
    if hdr.width <= 0 or hdr.height <= 0:
        raise ValueError("y4m header missing W/H")
    return hdr


class Y4mReader:
    """Iterates (y, u, v) numpy planes; uint8 for 8-bit, uint16 for 10-bit."""

    def __init__(self, source: Union[str, os.PathLike, BinaryIO]):
        if isinstance(source, (str, os.PathLike)):
            self._f: BinaryIO = open(source, "rb")
            self._owns = True
        else:
            self._f = source
            self._owns = False
        self.header = parse_header(self._readline())

    def _readline(self) -> bytes:
        buf = bytearray()
        while True:
            c = self._f.read(1)
            if not c or c == b"\n":
                return bytes(buf)
            buf += c

    def read_frame(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        line = self._readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"bad frame marker {line!r}")
        h = self.header
        dt = np.uint16 if h.bit_depth > 8 else np.uint8
        raw = self._f.read(h.frame_size_bytes)
        if len(raw) < h.frame_size_bytes:
            raise EOFError("truncated y4m frame")
        a = np.frombuffer(raw, dtype=dt)
        yl = h.width * h.height
        cl = (h.width // 2) * (h.height // 2)
        y = a[:yl].reshape(h.height, h.width)
        u = a[yl:yl + cl].reshape(h.height // 2, h.width // 2)
        v = a[yl + cl:yl + 2 * cl].reshape(h.height // 2, h.width // 2)
        return y, u, v

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self):
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class Y4mWriter:
    """Writes y4m (used by --enable-stat-report style recon dumps and tests)."""

    def __init__(self, dest: Union[str, os.PathLike, BinaryIO], width: int,
                 height: int, fps_num: int = 30, fps_den: int = 1,
                 bit_depth: int = 8):
        if isinstance(dest, (str, os.PathLike)):
            self._f: BinaryIO = open(dest, "wb")
            self._owns = True
        else:
            self._f = dest
            self._owns = False
        self.bit_depth = bit_depth
        cs = b"420p10" if bit_depth == 10 else b"420mpeg2"
        self._f.write(
            b"YUV4MPEG2 W%d H%d F%d:%d Ip A0:0 C%s\n"
            % (width, height, fps_num, fps_den, cs)
        )

    def write_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        dt = np.uint16 if self.bit_depth > 8 else np.uint8
        self._f.write(b"FRAME\n")
        for p in (y, u, v):
            self._f.write(np.ascontiguousarray(p, dtype=dt).tobytes())

    def close(self):
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
