"""MSB-first bit writer/reader for AV1 uncompressed headers and OBU payloads.

Equivalent role to the reference's OutputBitstreamUnit f(v)/uvlc/leb128 writers
(ref: Source/Lib/Codec/bitstream_unit.c). Implements the AV1 spec descriptors:
f(n), le(n), leb128(), uvlc(), su(n), ns(n).
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._buf = bytearray()
        self._bitpos = 0  # bits written into the current (last) byte

    # --- f(n): n-bit big-endian unsigned ---
    def f(self, value: int, n: int):
        if n == 0:
            return
        if value < 0 or value >= (1 << n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        for i in range(n - 1, -1, -1):
            bit = (value >> i) & 1
            if self._bitpos == 0:
                self._buf.append(0)
            self._buf[-1] |= bit << (7 - self._bitpos)
            self._bitpos = (self._bitpos + 1) & 7

    def bit(self, value: int):
        self.f(1 if value else 0, 1)

    # --- su(n): signed, MSB is sign (two's complement over 1+n bits) ---
    def su(self, value: int, n: int):
        self.f(value & ((1 << n) - 1), n)

    # --- ns(n): non-symmetric unsigned encoding, spec 4.10.7 ---
    def ns(self, value: int, n: int):
        w = n.bit_length()
        m = (1 << w) - n
        if value < m:
            self.f(value, w - 1)
        else:
            extra = value - m
            self.f(m + (extra >> 1), w - 1)
            self.f(extra & 1, 1)

    # --- uvlc(): spec 4.10.3 ---
    def uvlc(self, value: int):
        v = value + 1
        n = v.bit_length()
        self.f(0, n - 1)
        self.f(v, n)

    # --- le(n): n-byte little-endian (only byte-aligned) ---
    def le(self, value: int, nbytes: int):
        assert self._bitpos == 0, "le() requires byte alignment"
        self._buf += value.to_bytes(nbytes, "little")

    # --- leb128(): spec 4.10.5 ---
    def leb128(self, value: int):
        assert self._bitpos == 0, "leb128() requires byte alignment"
        while True:
            byte = value & 0x7F
            value >>= 7
            if value:
                self._buf.append(byte | 0x80)
            else:
                self._buf.append(byte)
                return

    def byte_align(self, bit: int = 0):
        while self._bitpos != 0:
            self.bit(bit)

    def trailing_bits(self):
        """spec 5.3.4: a 1 bit then zeros to byte alignment."""
        self.bit(1)
        self.byte_align(0)

    def write_bytes(self, data: bytes):
        assert self._bitpos == 0
        self._buf += data

    @property
    def bit_count(self) -> int:
        return len(self._buf) * 8 - ((8 - self._bitpos) & 7)

    def data(self) -> bytes:
        return bytes(self._buf)


class BitReader:
    """Mirror of BitWriter, used by the conformance decoder."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # absolute bit position

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def bit(self) -> int:
        return self.f(1)

    def su(self, n: int) -> int:
        v = self.f(n)
        sign_bit = 1 << (n - 1)
        return (v ^ sign_bit) - sign_bit

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        lead = 0
        while self.f(1) == 0:
            lead += 1
            if lead > 32:
                raise ValueError("uvlc overflow")
        if lead == 0:
            return 0
        return (1 << lead) - 1 + self.f(lead)

    def le(self, nbytes: int) -> int:
        assert self._pos % 8 == 0
        start = self._pos >> 3
        self._pos += nbytes * 8
        return int.from_bytes(self._data[start:start + nbytes], "little")

    def leb128(self) -> int:
        assert self._pos % 8 == 0
        v = 0
        for i in range(8):
            byte = self._data[self._pos >> 3]
            self._pos += 8
            v |= (byte & 0x7F) << (7 * i)
            if not byte & 0x80:
                return v
        raise ValueError("leb128 too long")

    def byte_align(self):
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_pos(self) -> int:
        return self._pos

    def bits_left(self) -> int:
        return len(self._data) * 8 - self._pos
