"""AV1 multi-symbol arithmetic (range) coder — encoder AND decoder.

This is the normative Daala entropy coder from the AV1 spec (spec 8.2:
"Boolean decoding process"; encoder mirror of ref:
Source/Lib/Codec/bitstream_unit.c:64-409). Both directions are implemented so
the in-repo conformance decoder can act as the bitstream oracle (the reference
uses libaom's decoder for this role, ref: test/e2e_test/RefDecoder.cc).

Conventions (identical to the spec / reference):
  - 15-bit probabilities; stored CDFs are "inverse": icdf[i] = 32768 - cum(i).
    A CDF array for N symbols has N+1 entries; icdf[N-1] == 0 and icdf[N] is
    the adaptation counter.
  - EC_PROB_SHIFT = 6, EC_MIN_PROB = 4 (each symbol reserves a floor
    probability), window = 32 bits, encoder cnt starts at -9, rng at 0x8000.

This scalar implementation is the trusted bring-up path; the batched device
backend (Pallas sequential kernel over tiles) plugs in behind the same
interface (SURVEY.md §7 "architecture stance").
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

PROB_TOP = 1 << 15  # CDF_PROB_TOP
EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
_W = 32  # window bits
_WMASK = (1 << _W) - 1
_LOTS_OF_BITS = 0x4000


def icdf_from_probs(probs: Sequence[float]) -> np.ndarray:
    """Build an inverse CDF (with trailing adaptation counter) from probabilities."""
    p = np.asarray(probs, dtype=np.float64)
    p = p / p.sum()
    cum = np.cumsum(p)
    icdf = PROB_TOP - np.round(cum * PROB_TOP).astype(np.int64)
    icdf[-1] = 0
    # keep every symbol's interval non-empty
    for i in range(len(icdf) - 2, -1, -1):
        if icdf[i] <= icdf[i + 1]:
            icdf[i] = icdf[i + 1] + 1
    out = np.zeros(len(p) + 1, dtype=np.uint16)
    out[:len(p)] = icdf
    return out


def uniform_icdf(nsyms: int) -> np.ndarray:
    """Equiprobable icdf over nsyms symbols (spec Default init for some trees)."""
    return icdf_from_probs([1.0] * nsyms)


def update_cdf(icdf: np.ndarray, val: int, nsymbs: Optional[int] = None) -> None:
    """Normative CDF adaptation (spec 8.4; ref cabac_context_model.h:389-408).

    In-place; icdf[nsymbs] is the count used to derive the adaptation rate.
    """
    if nsymbs is None:
        nsymbs = len(icdf) - 1
    count = int(icdf[nsymbs])
    speed = 0 if nsymbs < 2 else (1 if nsymbs < 4 else 2)
    rate = 3 + (count > 15) + (count > 31) + speed
    tmp = PROB_TOP
    for i in range(nsymbs - 1):
        if i == val:
            tmp = 0
        c = int(icdf[i])
        if tmp < c:
            icdf[i] = c - ((c - tmp) >> rate)
        else:
            icdf[i] = c + ((tmp - c) >> rate)
    if count < 32:
        icdf[nsymbs] = count + 1


def _ilog(v: int) -> int:
    return v.bit_length()


class RangeEncoder:
    """od_ec_enc equivalent. Produces the final byte string via done()."""

    def __init__(self):
        self.low = 0
        self.rng = 0x8000
        self.cnt = -9
        self.precarry: list = []

    # --- internals -----------------------------------------------------
    def _normalize(self, low: int, rng: int) -> None:
        d = 16 - _ilog(rng)
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & _WMASK
        self.rng = (rng << d) & 0xFFFF
        self.cnt = s

    def _encode_q15(self, fl: int, fh: int, s: int, nsyms: int) -> None:
        l, r = self.low, self.rng
        assert 32768 <= r <= 65536
        n = nsyms - 1
        if fl < PROB_TOP:
            u = ((r >> 8) * (fl >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - (s - 1))
            v = ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - (s + 0))
            l += r - u
            r = u - v
        else:
            r -= ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - (s + 0))
        self._normalize(l, r)

    # --- public API ------------------------------------------------------
    def encode_symbol(self, s: int, icdf, nsyms: Optional[int] = None,
                      adapt: bool = False) -> None:
        """Encode symbol s with inverse CDF; optionally adapt the CDF in place."""
        if nsyms is None:
            nsyms = len(icdf) - 1
        fl = PROB_TOP if s == 0 else int(icdf[s - 1])
        fh = int(icdf[s])
        self._encode_q15(fl, fh, s, nsyms)
        if adapt:
            update_cdf(icdf, s, nsyms)

    def encode_bool(self, val: int, f: int) -> None:
        """Encode a boolean; f = 15-bit probability that val == 0."""
        l, r = self.low, self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        if val:
            l += r - v
            r = v
        else:
            r -= v
        self._normalize(l, r)

    def encode_literal(self, value: int, bits: int) -> None:
        """spec L(n): raw equiprobable bits, MSB first."""
        for i in range(bits - 1, -1, -1):
            self.encode_bool((value >> i) & 1, PROB_TOP // 2)

    def encode_golomb(self, value: int) -> None:
        """Exp-Golomb used by coefficient base-range overflow (spec 5.11.44)."""
        length = (value + 1).bit_length()
        for _ in range(length - 1):
            self.encode_literal(0, 1)
        self.encode_literal(value + 1, length)

    def tell_bits(self) -> int:
        return self.cnt + 10 + len(self.precarry) * 8

    def done(self) -> bytes:
        """Flush: minimum bits so the stream decodes regardless of what follows."""
        l, c = self.low, self.cnt
        s = 10
        m = 0x3FFF
        e = ((l + m) & ~m) | (m + 1)
        s += c
        pre = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                pre.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        # carry propagation
        out = bytearray(len(pre))
        carry = 0
        for i in range(len(pre) - 1, -1, -1):
            v = pre[i] + carry
            out[i] = v & 0xFF
            carry = v >> 8
        assert carry == 0, "carry out of the first byte cannot happen (low < 2*rng)"
        return bytes(out)


class RangeDecoder:
    """od_ec_dec equivalent (the spec's 8.2 Boolean decoder).

    Works on the complemented window like the spec; safe to read past the end
    of the buffer (implicit zeros).
    """

    def __init__(self, data: bytes):
        self.data = data
        self.bptr = 0
        self.dif = (1 << (_W - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = _W - 9 - (self.cnt + 15)
        dif, cnt, bptr = self.dif, self.cnt, self.bptr
        end = len(self.data)
        while s >= 0 and bptr < end:
            dif ^= self.data[bptr] << s
            cnt += 8
            bptr += 1
            s -= 8
        if bptr >= end:
            cnt = _LOTS_OF_BITS
        self.dif, self.cnt, self.bptr = dif, cnt, bptr

    def _normalize(self, dif: int, rng: int) -> None:
        d = 16 - _ilog(rng)
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _WMASK
        self.rng = (rng << d) & 0xFFFF
        if self.cnt < 0:
            self._refill()

    def decode_symbol(self, icdf, nsyms: Optional[int] = None,
                      adapt: bool = False) -> int:
        if nsyms is None:
            nsyms = len(icdf) - 1
        dif, r = self.dif, self.rng
        c = dif >> (_W - 16)
        v = r
        ret = -1
        while True:
            ret += 1
            u = v
            v = ((r >> 8) * (int(icdf[ret]) >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (nsyms - ret - 1)
            if c >= v:
                break
        r_new = u - v
        dif -= v << (_W - 16)
        self._normalize(dif, r_new)
        if adapt:
            update_cdf(icdf, ret, nsyms)
        return ret

    def decode_bool(self, f: int) -> int:
        dif, r = self.dif, self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (_W - 16)
        if dif >= vw:
            self._normalize(dif - vw, r - v)
            return 0
        self._normalize(dif, v)
        return 1

    def decode_literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.decode_bool(PROB_TOP // 2)
        return v

    def decode_golomb(self) -> int:
        length = 1
        while self.decode_literal(1) == 0:
            length += 1
            if length > 32:
                raise ValueError("golomb overflow")
        v = 1
        for _ in range(length - 1):
            v = (v << 1) | self.decode_literal(1)
        return v - 1


def sym_cost(icdf, s: int) -> float:
    """Exact bit cost of coding symbol s under a live 15-bit icdf.

    Mirrors the reference's av1_cost_symbol (md_rate_estimation.c) but in
    float bits; used for encoder-side RD only, never for coding.
    """
    import math
    fl = 32768 if s == 0 else int(icdf[s - 1])
    fh = int(icdf[s])
    p = (fl - fh) / 32768.0
    if p <= 0:
        return 15.0
    return -math.log2(p)
