"""OBU framing (spec 5.3) — temporal delimiter, header, payload wrapping.

Role of the OBU assembly in the reference's packetization + entropy coding
(ref: Source/Lib/Codec/packetization_process.c:469, entropy_coding.c
svt_aom_encode_sps_av1). Sequence/frame-header *payloads* live in
headers.py; this module only frames them.
"""

from __future__ import annotations

from enum import IntEnum

from svt_av1_psy_tpu_torch.bitstream.bitwriter import BitReader, BitWriter


class ObuType(IntEnum):
    SEQUENCE_HEADER = 1
    TEMPORAL_DELIMITER = 2
    FRAME_HEADER = 3
    TILE_GROUP = 4
    METADATA = 5
    FRAME = 6  # frame header + tile group in one OBU
    REDUNDANT_FRAME_HEADER = 7
    TILE_LIST = 8
    PADDING = 15


def wrap_obu(obu_type: ObuType, payload: bytes, *, has_size: bool = True,
             temporal_id: int = 0, spatial_id: int = 0) -> bytes:
    """spec 5.3.2 obu_header + optional leb128 size + payload."""
    w = BitWriter()
    ext = temporal_id != 0 or spatial_id != 0
    w.f(0, 1)                      # obu_forbidden_bit
    w.f(int(obu_type), 4)          # obu_type
    w.f(1 if ext else 0, 1)        # obu_extension_flag
    w.f(1 if has_size else 0, 1)   # obu_has_size_field
    w.f(0, 1)                      # obu_reserved_1bit
    if ext:
        w.f(temporal_id, 3)
        w.f(spatial_id, 2)
        w.f(0, 3)                  # extension_header_reserved_3bits
    if has_size:
        w.leb128(len(payload))
    w.write_bytes(payload)
    return w.data()


def temporal_delimiter() -> bytes:
    return wrap_obu(ObuType.TEMPORAL_DELIMITER, b"")


def parse_obus(data: bytes):
    """Yield (obu_type, temporal_id, spatial_id, payload) for each OBU."""
    pos = 0
    while pos < len(data):
        r = BitReader(data[pos:])
        if r.f(1) != 0:
            raise ValueError("obu_forbidden_bit set")
        obu_type = ObuType(r.f(4))
        ext = r.f(1)
        has_size = r.f(1)
        r.f(1)  # reserved
        tid = sid = 0
        if ext:
            tid = r.f(3)
            sid = r.f(2)
            r.f(3)
        if not has_size:
            payload = data[pos + (r.bit_pos // 8):]
            yield obu_type, tid, sid, payload
            return
        size = r.leb128()
        hdr_bytes = r.bit_pos // 8
        payload = data[pos + hdr_bytes: pos + hdr_bytes + size]
        if len(payload) != size:
            raise ValueError("truncated OBU")
        yield obu_type, tid, sid, payload
        pos += hdr_bytes + size
