"""Metadata OBUs: HDR CLL / mastering display (MDCV) / ITU-T T.35.

The reference carries HDR10 static metadata and DoVi/HDR10+ dynamic
metadata as an OBU metadata array attached to input pictures
(ref Source/Globals/metadata_handle.c; API/EbSvtAv1Metadata.h:92;
app-side injection app_process_cmd.c:463-495). This module writes the
normative payloads (spec 5.8.2-5.8.4) and parses the app-facing string
formats the reference CLI uses (--content-light "cll,fall";
--mastering-display "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)").
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

from svt_av1_psy_tpu_torch.bitstream.bitwriter import BitWriter
from svt_av1_psy_tpu_torch.bitstream.obu import ObuType, wrap_obu


class MetadataType(IntEnum):
    HDR_CLL = 1
    HDR_MDCV = 2
    SCALABILITY = 3
    ITUT_T35 = 4
    TIMECODE = 5


def _metadata_obu(mtype: MetadataType, payload: bytes) -> bytes:
    """spec 5.8.1 metadata_obu: leb128 metadata_type + payload +
    trailing bits (metadata OBUs are not in the no-trailing set,
    spec 5.3.1)."""
    w = BitWriter()
    w.leb128(int(mtype))
    w.write_bytes(payload)
    w.bit(1)              # trailing_one_bit
    w.byte_align()
    return wrap_obu(ObuType.METADATA, w.data())


@dataclass
class ContentLightLevel:
    """HDR CLL (spec 5.8.3): nits, both u16."""
    max_cll: int
    max_fall: int

    @staticmethod
    def parse(s: str) -> "ContentLightLevel":
        cll, fall = (int(x) for x in s.split(","))
        return ContentLightLevel(cll, fall)

    def obu(self) -> bytes:
        w = BitWriter()
        w.f(self.max_cll & 0xFFFF, 16)
        w.f(self.max_fall & 0xFFFF, 16)
        return _metadata_obu(MetadataType.HDR_CLL, w.data())


@dataclass
class MasteringDisplay:
    """HDR MDCV (spec 5.8.4). Chromaticities in 0.16 fixed point
    (normative order R, G, B), luminance max 24.8 / min 18.14 fixed."""
    rx: float
    ry: float
    gx: float
    gy: float
    bx: float
    by: float
    wx: float
    wy: float
    max_luminance: float
    min_luminance: float

    @staticmethod
    def parse(s: str) -> "MasteringDisplay":
        """The reference CLI string: G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)
        (ref enc_settings.c str_to_mastering_display)."""
        m = re.fullmatch(
            r"G\(([^,]+),([^)]+)\)B\(([^,]+),([^)]+)\)R\(([^,]+),([^)]+)\)"
            r"WP\(([^,]+),([^)]+)\)L\(([^,]+),([^)]+)\)", s.strip())
        if not m:
            raise ValueError(f"bad mastering-display string: {s!r}")
        gx, gy, bx, by, rx, ry, wx, wy, lmax, lmin = \
            (float(x) for x in m.groups())
        return MasteringDisplay(rx, ry, gx, gy, bx, by, wx, wy, lmax, lmin)

    def obu(self) -> bytes:
        def q16(v):
            return max(0, min(65535, int(round(v * 65536.0))))

        w = BitWriter()
        for x, y in ((self.rx, self.ry), (self.gx, self.gy),
                     (self.bx, self.by)):
            w.f(q16(x), 16)
            w.f(q16(y), 16)
        w.f(q16(self.wx), 16)
        w.f(q16(self.wy), 16)
        w.f(max(0, min((1 << 32) - 1,
                       int(round(self.max_luminance * 256.0)))), 32)
        w.f(max(0, min((1 << 32) - 1,
                       int(round(self.min_luminance * 16384.0)))), 32)
        return _metadata_obu(MetadataType.HDR_MDCV, w.data())


def itut_t35_obu(blob: bytes) -> bytes:
    """ITU-T T.35 passthrough (spec 5.8.2): the blob carries country
    code + payload verbatim (DoVi RPU / HDR10+ containers)."""
    return _metadata_obu(MetadataType.ITUT_T35, blob)


def build_metadata_payload(content_light: Optional[str] = None,
                           mastering_display: Optional[str] = None,
                           t35_blob: Optional[bytes] = None) -> bytes:
    """Concatenated metadata OBUs to splice into a temporal unit after
    the TD (the metadata_handle.c array → packetization path)."""
    out = b""
    if content_light:
        out += ContentLightLevel.parse(content_light).obu()
    if mastering_display:
        out += MasteringDisplay.parse(mastering_display).obu()
    if t35_blob:
        out += itut_t35_obu(t35_blob)
    return out


def parse_metadata_obu(payload: bytes):
    """Parse a metadata OBU payload back into (type, fields) — used by
    tests and the conformance decoder's skip path."""
    from svt_av1_psy_tpu_torch.bitstream.bitwriter import BitReader
    r = BitReader(payload)
    mtype = r.leb128()
    if mtype == MetadataType.HDR_CLL:
        return mtype, {"max_cll": r.f(16), "max_fall": r.f(16)}
    if mtype == MetadataType.HDR_MDCV:
        prim = [(r.f(16), r.f(16)) for _ in range(3)]
        wp = (r.f(16), r.f(16))
        return mtype, {"primaries": prim, "white_point": wp,
                       "max_luminance": r.f(32) / 256.0,
                       "min_luminance": r.f(32) / 16384.0}
    return mtype, {"raw": payload}
