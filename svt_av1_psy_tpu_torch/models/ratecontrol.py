"""Rate control: CRF, capped CRF, one-pass VBR, CBR, and 2-pass VBR.

The reference's rate-control process (ref Source/Lib/Codec/rc_process.c:3269)
derives a per-frame qindex from the mode (CRF/VBR/CBR), a rate model, a
leaky-bucket buffer, and a recode loop that re-encodes frames whose size
violates the buffer constraints; the two-pass path allocates bits from
first-pass complexity stats (ref Source/Lib/Codec/pass2_strategy.c).

This module is the control-plane equivalent: pure host Python (RC is
decision logic, not compute — SURVEY §2.5). It exposes:

- ``RateController``      — per-frame qindex + post-frame feedback +
                            recode verdicts for all one-pass modes.
- ``FirstPassStats``      — pass-1 collection and the stats-file format
                            (the svtav1_2pass.log analog).
- ``TwoPassAllocator``    — pass-2 per-frame bit targets from stats.

The q <-> bits model is the reference's ``bits ~ c / qstep`` family: per
frame-type constants ``c`` are tracked as EWMAs and inverted through the
AV1 quantizer tables (ref rc_process.c av1_rc_bits_per_mb usage).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from svt_av1_psy_tpu_torch.ops.quant import ac_q, dc_q

# frame-type classes for the rate model (key / P-or-base / other layers)
_KEY, _BASE, _HI = 0, 1, 2


def _qstep(qindex: int, bd: int = 8) -> float:
    return max(ac_q(max(1, min(255, qindex)), bd) / 8.0, 0.0625)


def _q_from_qstep(want: float, bd: int = 8) -> int:
    """Invert the ac quantizer table (monotonic -> binary search)."""
    lo, hi = 1, 255
    while lo < hi:
        mid = (lo + hi) // 2
        if _qstep(mid, bd) < want:
            lo = mid + 1
        else:
            hi = mid
    return lo


@dataclass
class RateController:
    """One-pass rate control (ref rc_process.c:3269).

    mode: "crf" (fixed base q; capped CRF when max_bit_rate > 0),
          "vbr" (average bitrate with a soft reservoir),
          "cbr" (leaky-bucket buffer model with recode).
    """

    mode: str = "crf"
    base_qindex: int = 100
    target_bps: float = 0.0          # VBR/CBR target, bits/second
    max_bps: float = 0.0             # capped-CRF / CBR peak, bits/second
    fps: float = 30.0
    bd: int = 8
    # leaky bucket (ms, like EbSvtAv1Enc.h starting/optimal/maximum level)
    buf_size_ms: int = 1000
    buf_initial_ms: int = 600
    buf_optimal_ms: int = 600
    undershoot_pct: int = 25
    overshoot_pct: int = 25
    gop_size: int = 0                # informative (key boost scheduling)
    recode: bool = True              # enable the recode loop (CBR/capped)
    max_recodes: int = 2

    def __post_init__(self):
        self.target_per_frame = (self.target_bps / self.fps
                                 if self.target_bps > 0 else 0.0)
        self.buf_max = self.max_rate_per_sec() * self.buf_size_ms / 1000.0
        self.buf_level = self.max_rate_per_sec() * \
            self.buf_initial_ms / 1000.0
        self.buf_optimal = self.max_rate_per_sec() * \
            self.buf_optimal_ms / 1000.0
        # per-class rate model: bits * qstep EWMA (None until seeded)
        self._c = [None, None, None]
        self._reservoir = 0.0        # VBR accumulated (target - actual)
        self._frames = 0
        self._window_bits = []       # capped-CRF sliding 1s window
        self._last_q = self.base_qindex

    # --- model -----------------------------------------------------------
    def max_rate_per_sec(self) -> float:
        if self.mode == "cbr":
            return self.max_bps or self.target_bps
        return self.max_bps or self.target_bps or 1.0

    def _cls(self, is_key: bool, layer: int) -> int:
        return _KEY if is_key else (_BASE if layer <= 0 else _HI)

    def _predict_bits(self, qindex: int, cls: int) -> float:
        c = self._c[cls]
        if c is None:
            # fall back to the nearest seeded class with a type ratio
            # (keys ~ 6x a P at the same q, ref kf boost behavior)
            ratios = {(_KEY, _BASE): 6.0, (_KEY, _HI): 9.0,
                      (_BASE, _KEY): 1 / 6.0, (_BASE, _HI): 1.5,
                      (_HI, _KEY): 1 / 9.0, (_HI, _BASE): 1 / 1.5}
            for other in (_BASE, _KEY, _HI):
                if self._c[other] is not None:
                    c = self._c[other] * ratios.get((cls, other), 1.0)
                    break
        if c is None:
            return self.target_per_frame or 1.0
        return c / _qstep(qindex, self.bd)

    def _q_for_bits(self, want_bits: float, cls: int, fallback: int) -> int:
        c = self._c[cls]
        if c is None:
            return fallback
        want_bits = max(want_bits, 16.0)
        return _q_from_qstep(c / want_bits, self.bd)

    # --- per-frame q -----------------------------------------------------
    def frame_qindex(self, is_key: bool, layer: int = 0) -> int:
        """Base qindex for the next frame (before the encoder's own
        key-boost / pyramid-layer offsets, which it applies internally)."""
        if self.mode == "crf":
            q = self.base_qindex
            if self.max_bps > 0:
                # capped CRF (--mbr): push q up while the 1s window
                # exceeds the cap (ref rc_process.c capped_crf)
                win = sum(self._window_bits)
                if win > self.max_bps:
                    over = win / self.max_bps - 1.0
                    q = min(255, int(q + min(48, 96 * over)))
            self._last_q = q
            return q

        cls = self._cls(is_key, layer)
        if self.mode == "vbr":
            # drain the reservoir over ~2 seconds
            drain = self._reservoir / max(2.0 * self.fps, 1.0)
            want = self.target_per_frame + drain
            lo = self.target_per_frame * (1 - self.undershoot_pct / 100.0)
            hi = self.target_per_frame * (1 + self.overshoot_pct / 100.0) \
                * (6.0 if is_key else 1.0)
            want = max(lo, min(hi, want))
        else:                       # cbr
            # steer the buffer toward the optimal level over ~1 second
            err = self.buf_level - self.buf_optimal
            want = self.target_per_frame + err / max(self.fps, 1.0)
            room = max(self.buf_level, 1.0)
            want = max(16.0, min(want, 0.5 * room))
            if is_key:
                want = min(want * 4.0, 0.8 * room)
        q = self._q_for_bits(want, cls, self._last_q)
        # bound q excursion frame-to-frame (ref rc q clamping)
        q = max(self._last_q - 40, min(self._last_q + 40, q))
        q = max(1, min(255, q))
        if not is_key:
            self._last_q = q
        return q

    # --- recode ----------------------------------------------------------
    def recode_qindex(self, qindex: int, bits: int, is_key: bool,
                      layer: int = 0, attempt: int = 0) -> Optional[int]:
        """Recode verdict after encoding a frame at `qindex` producing
        `bits`. Returns a new qindex to re-encode at, or None to keep
        (the reference's recode loop, ref rc_process.c:3269)."""
        if not self.recode or attempt >= self.max_recodes:
            return None
        limit = None
        if self.mode == "cbr":
            # hard: frame must fit in the current buffer
            limit = max(0.9 * self.buf_level,
                        2.0 * self.target_per_frame)
        elif self.mode == "vbr":
            limit = self.target_per_frame * \
                (1 + self.overshoot_pct / 100.0) * (8.0 if is_key else 4.0)
        elif self.max_bps > 0:      # capped CRF
            limit = 2.0 * self.max_rate_per_sec() / max(self.fps, 1.0) \
                * (4.0 if is_key else 1.0)
        if limit is None or bits <= limit:
            return None
        # model-inverted bump toward the limit, at least +8 q
        cls = self._cls(is_key, layer)
        self._seed(cls, qindex, bits)
        nq = self._q_for_bits(limit, cls, qindex + 24)
        nq = max(qindex + 8, nq)
        if nq > 255:
            nq = 255
        return None if nq <= qindex else nq

    # --- feedback --------------------------------------------------------
    def _seed(self, cls: int, qindex: int, bits: int):
        c = bits * _qstep(qindex, self.bd)
        self._c[cls] = c if self._c[cls] is None else \
            0.6 * self._c[cls] + 0.4 * c

    def update(self, qindex: int, bits: int, is_key: bool,
               layer: int = 0) -> None:
        """Post-frame model + buffer update."""
        cls = self._cls(is_key, layer)
        self._seed(cls, qindex, bits)
        self._frames += 1
        if self.mode == "vbr":
            self._reservoir += self.target_per_frame - bits
            # cap the reservoir at a few seconds of rate
            cap = 4.0 * self.target_bps
            self._reservoir = max(-cap, min(cap, self._reservoir))
        elif self.mode == "cbr":
            self.buf_level += self.target_per_frame - bits
            self.buf_level = max(0.0, min(self.buf_max, self.buf_level))
        if self.max_bps > 0 and self.mode == "crf":
            self._window_bits.append(bits)
            if len(self._window_bits) > max(int(self.fps), 1):
                self._window_bits.pop(0)


# --- two-pass ---------------------------------------------------------------

@dataclass
class FirstPassStats:
    """Pass-1 stat collection + the stats-file format (one JSON object
    per frame; the svtav1_2pass.log analog, ref firstpass.c:210)."""

    frames: list = field(default_factory=list)

    def add(self, frame_index: int, qindex: int, bits: int,
            is_key: bool, intra_sad: float = 0.0,
            inter_sad: float = 0.0) -> None:
        self.frames.append({
            "i": frame_index, "q": qindex, "bits": bits,
            "key": int(is_key),
            "intra_sad": float(intra_sad), "inter_sad": float(inter_sad)})

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps({"version": 1, "n": len(self.frames)}))
            f.write("\n")
            for r in self.frames:
                f.write(json.dumps(r))
                f.write("\n")

    @staticmethod
    def load(path: str) -> "FirstPassStats":
        st = FirstPassStats()
        with open(path) as f:
            header = json.loads(f.readline())
            assert header.get("version") == 1, "bad stats file"
            for line in f:
                line = line.strip()
                if line:
                    st.frames.append(json.loads(line))
        return st


class TwoPassAllocator:
    """Pass-2 bit allocation from first-pass stats (the
    pass2_strategy.c analog): total budget split by per-frame
    complexity = bits * qstep at the pass-1 q, with key frames boosted.

    The linear bits ~ c/qstep model drifts over large q excursions, so a
    damped multiplicative correction is learned from the actual bits of
    already-encoded pass-2 frames (the reference achieves the same with
    its recode/GF-group feedback), and the remaining budget is
    re-distributed over the remaining frames after every update."""

    def __init__(self, stats: FirstPassStats, target_bps: float,
                 fps: float, bd: int = 8):
        self.bd = bd
        self.fps = fps
        n = len(stats.frames)
        self.total_budget = target_bps / fps * n
        compl = []
        for r in stats.frames:
            c = r["bits"] * _qstep(r["q"], bd)
            if r["key"]:
                c *= 1.3         # kf boost (ref pass2 kf group boost)
            compl.append(max(c, 1.0))
        self._w = compl
        s = sum(compl)
        self.targets = [self.total_budget * c / s for c in compl]
        self.stats = stats
        # model constants straight from pass 1; corrected online
        self._c = [r["bits"] * _qstep(r["q"], bd) for r in stats.frames]
        self._corr = 1.0
        self._spent = 0.0
        self._done = 0
        self._last_q = {}

    def frame_qindex(self, frame_index: int) -> int:
        if frame_index >= len(self.targets):
            return 100
        # remaining budget spread by remaining complexity weights
        rem_w = sum(self._w[self._done:])
        rem_budget = max(self.total_budget - self._spent, 1.0)
        want = max(rem_budget * self._w[frame_index] / max(rem_w, 1.0),
                   16.0)
        q = _q_from_qstep(self._c[frame_index] * self._corr / want,
                          self.bd)
        q = max(1, min(255, q))
        self._last_q[frame_index] = q
        return q

    def update(self, frame_index: int, bits: int) -> None:
        """Feedback from an encoded pass-2 frame: learn the model error
        and account the spent budget."""
        self._spent += bits
        self._done = max(self._done, frame_index + 1)
        q = self._last_q.get(frame_index)
        if q is None or frame_index >= len(self._c):
            return
        implied_c = bits * _qstep(q, self.bd)
        base_c = self._c[frame_index] * self._corr
        if base_c > 0:
            ratio = implied_c / base_c
            self._corr *= min(4.0, max(0.25, ratio)) ** 0.7


# --- round-1 compatibility shim ---------------------------------------------

@dataclass
class RateControl:
    """Round-1 CRF/ABR skeleton (kept for the slow-path encoder)."""
    mode: str = "crf"
    base_qindex: int = 100
    target_bits_per_frame: float = 0.0
    key_boost: int = 18
    p_offset: int = 8

    def __post_init__(self):
        self._model_c = None
        self._int_err = 0.0
        self._q = float(self.base_qindex)

    def frame_qindex(self, frame_index: int, is_key: bool) -> int:
        if self.mode == "crf":
            q = self.base_qindex - (self.key_boost if is_key
                                    else -self.p_offset)
            return max(1, min(255, q))
        q = self._q - (self.key_boost if is_key else 0)
        return max(1, min(255, int(round(q))))

    def update(self, qindex: int, bits: int) -> None:
        if self.mode != "abr" or self.target_bits_per_frame <= 0:
            return
        qstep = dc_q(qindex, 8) / 8.0
        c = bits * qstep
        self._model_c = c if self._model_c is None else \
            0.7 * self._model_c + 0.3 * c
        want_qstep = self._model_c / self.target_bits_per_frame
        best, bestd = self.base_qindex, 1e18
        for q in range(1, 256):
            d = abs(dc_q(q, 8) / 8.0 - want_qstep)
            if d < bestd:
                best, bestd = q, d
        err = bits / self.target_bits_per_frame - 1.0
        self._int_err = max(-0.5, min(0.5, self._int_err + 0.1 * err))
        self._q = max(1.0, min(255.0, best + 24.0 * self._int_err))


__all__ = ["RateController", "FirstPassStats", "TwoPassAllocator",
           "RateControl"]
