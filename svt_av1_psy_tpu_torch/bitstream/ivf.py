"""IVF container writer/reader (AV01 fourcc).

ref: Source/App/app_output_ivf.c (61 LoC): 32-byte file header + 12-byte
frame headers, little-endian.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Tuple, Union


@dataclass
class IvfHeader:
    width: int
    height: int
    fps_num: int
    fps_den: int
    frame_count: int = 0
    fourcc: bytes = b"AV01"


class IvfWriter:
    def __init__(self, dest: Union[str, os.PathLike, BinaryIO], width: int,
                 height: int, fps_num: int = 30, fps_den: int = 1):
        if isinstance(dest, (str, os.PathLike)):
            self._f: BinaryIO = open(dest, "wb")
            self._owns = True
        else:
            self._f = dest
            self._owns = False
        self._count = 0
        self._f.write(struct.pack(
            "<4sHH4sHHIIII",
            b"DKIF", 0, 32, b"AV01",
            width, height, fps_num, fps_den,
            0,  # frame count, patched on close when seekable
            0,  # unused
        ))

    def write_frame(self, payload: bytes, pts: int):
        self._f.write(struct.pack("<IQ", len(payload), pts))
        self._f.write(payload)
        self._count += 1

    def close(self):
        if self._f.seekable():
            self._f.seek(24)
            self._f.write(struct.pack("<I", self._count))
            self._f.seek(0, 2)
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_ivf(source: Union[str, os.PathLike, bytes]) -> Tuple[IvfHeader, List[Tuple[int, bytes]]]:
    """Returns (header, [(pts, payload), ...])."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            data = f.read()
    else:
        data = source
    magic, ver, hdr_sz, fourcc, w, h, num, den, cnt = struct.unpack(
        "<4sHH4sHHIII", data[:28])
    if magic != b"DKIF":
        raise ValueError("not an IVF file")
    hdr = IvfHeader(width=w, height=h, fps_num=num, fps_den=den,
                    frame_count=cnt, fourcc=fourcc)
    frames = []
    off = hdr_sz
    while off + 12 <= len(data):
        sz, pts = struct.unpack("<IQ", data[off:off + 12])
        off += 12
        frames.append((pts, data[off:off + sz]))
        off += sz
    return hdr, frames
