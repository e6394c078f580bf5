"""The lookahead's credit splat of tpl_sb_offsets (the port's
models/tpl.py _splat_credit) against the per-block loop it replaced.

- The float64 credit plane is equal to the loop's, bit for bit, for
  1-3 lookahead frames at the padded sizes 1088x1920, 144x176 and
  80x112: random MVs and benefits, MVs that clamp at each of the four
  edges, the extremes of the int16 MVs the searches return, blocks with
  zero or negative benefit and frames with none positive, and many
  blocks landing on one area, where the order of the additions shows.
- The whole tpl_sb_offsets, with hme_mv_sad stubbed by designed MVs and
  SADs in both packages, equals the JAX package's.
"""

import numpy as np
import pytest

import svt_av1_psy_tpu.models.fast_intra as ref_fi
import svt_av1_psy_tpu_torch.models.fast_intra as port_fi
from svt_av1_psy_tpu.models import tpl as ref_tpl
from svt_av1_psy_tpu_torch.models import tpl as port_tpl

SIZES = [(1088, 1920), (144, 176), (80, 112)]        # padded (ph, pw)
KINDS = ["random", "edges", "extremes", "nonpositive", "pile"]
# K1 searches +-12 half-res pixels, +-24 full-pel; int16 is what the
# unpacked MVs hold
MV_EXTREMES = [-32768, -25, -24, -23, -1, 0, 1, 23, 24, 25, 32767]
DECAY = 0.7


def _loop_credit(bens, mvs, shape):
    """The splat as tpl_sb_offsets ran it before: one slice add per
    block with a positive benefit, frame by frame."""
    credit = np.zeros(shape, np.float64)
    hh, wh = credit.shape
    for ben, mv16 in zip(bens, mvs):
        n8r, n8c = ben.shape
        for br in range(n8r):
            for bc in range(n8c):
                b = ben[br, bc]
                if b <= 0:
                    continue
                y0 = br * 8 + int(mv16[br, bc, 0]) // 2
                x0 = bc * 8 + int(mv16[br, bc, 1]) // 2
                y0 = max(0, min(y0, hh - 8))
                x0 = max(0, min(x0, wh - 8))
                credit[y0:y0 + 8, x0:x0 + 8] += b / 64.0
    return credit


def _frame(kind, k, n_frames, n8r, n8c, rng):
    """Benefits and MVs of lookahead frame k: benefits as tpl_sb_offsets
    makes them (an integer gain times decay ** (k + 1)), about half of
    them positive."""
    gain = np.clip(rng.integers(-400, 900, (n8r, n8c)), 0, None)
    ben = gain.astype(np.float64) * (DECAY ** (k + 1))
    mv = rng.integers(-24, 25, (n8r, n8c, 2)).astype(np.int64)
    if kind == "edges":
        # every border band points out of the plane, each by a random
        # amount past the edge
        far = rng.integers(2, 200, (n8r, n8c))
        mv[0, :, 0] = -far[0, :]
        mv[-1, :, 0] = far[-1, :]
        mv[:, 0, 1] = -far[:, 0]
        mv[:, -1, 1] = far[:, -1]
    elif kind == "extremes":
        mv = rng.choice(MV_EXTREMES, (n8r, n8c, 2)).astype(np.int64)
    elif kind == "nonpositive":
        ben[rng.random((n8r, n8c)) < 0.2] = -0.0
        ben[rng.random((n8r, n8c)) < 0.2] = -rng.random()
        if k == n_frames - 1:
            # a frame with no positive benefit at all
            ben = -np.abs(ben)
    elif kind == "pile":
        # every block clamps onto the same corner area, or near it
        mv[..., 0] = rng.choice([-32768, -4000], (n8r, n8c))
        mv[..., 1] = rng.choice([32767, 4000], (n8r, n8c))
        ben = rng.random((n8r, n8c)) * 1000.0 * (DECAY ** (k + 1))
    return ben, mv


def _case(kind, n_frames, size, seed=12):
    ph, pw = size
    rng = np.random.default_rng([seed, n_frames, ph, KINDS.index(kind)])
    frames = [_frame(kind, k, n_frames, ph // 16, pw // 16, rng)
              for k in range(n_frames)]
    return [f[0] for f in frames], [f[1] for f in frames], (ph // 2, pw // 2)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("n_frames", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_splat_equals_the_loop(kind, n_frames, size):
    bens, mvs, shape = _case(kind, n_frames, size)
    got = port_tpl._splat_credit(bens, mvs, shape)
    want = _loop_credit(bens, mvs, shape)
    assert got.dtype == np.float64 and got.shape == shape
    assert np.array_equal(got, want)
    if kind == "nonpositive" and n_frames == 1:
        assert not got.any()


def test_the_order_of_additions_shows():
    """The pile case is one the comparison can fail: the same terms added
    frame by frame in the other order give another plane."""
    bens, mvs, shape = _case("pile", 3, SIZES[1])
    want = _loop_credit(bens, mvs, shape)
    assert np.array_equal(port_tpl._splat_credit(bens, mvs, shape), want)
    assert not np.array_equal(
        port_tpl._splat_credit(bens[::-1], mvs[::-1], shape), want)


@pytest.mark.parametrize("frame", [(1080, 1920), (144, 176), (72, 112)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tpl_sb_offsets_with_designed_search_matches_jax(monkeypatch,
                                                         frame):
    """Both packages' tpl_sb_offsets over 3 lookahead frames, their
    hme_mv_sad replaced by one that hands out the same designed MVs
    (clamping at every edge, int16 extremes) and SADs (below and above
    the blocks' activity) call by call."""
    H, W = frame
    ph, pw = (H + 15) // 16 * 16, (W + 15) // 16 * 16
    rng = np.random.default_rng([7, H, W])
    ys = [rng.integers(0, 256, (H, W)).astype(np.uint8) for _ in range(4)]
    n16 = (ph // 16, pw // 16)
    answers = []
    for k in range(3):
        mv = rng.choice(MV_EXTREMES, n16 + (2,)).astype(np.int16)
        mv[0, :, 0], mv[-1, :, 0] = -200, 200
        mv[:, 0, 1], mv[:, -1, 1] = -200, 200
        # activity of random 8x8 half-res blocks is a few thousand
        sad = rng.integers(0, 9000, n16).astype(np.int32)
        answers.append((mv, sad))

    def stub(calls):
        def hme_mv_sad(src_p, ref_p, *device):
            assert src_p.shape == ref_p.shape == (ph, pw)
            calls.append(device)
            return answers[len(calls) - 1]
        return hme_mv_sad

    port_calls, ref_calls = [], []
    monkeypatch.setattr(port_fi, "hme_mv_sad", stub(port_calls))
    monkeypatch.setattr(ref_fi, "hme_mv_sad", stub(ref_calls))
    got = port_tpl.tpl_sb_offsets(ys[0], ys[1:], device="cpu")
    want = ref_tpl.tpl_sb_offsets(ys[0], ys[1:])
    assert port_calls == [("cpu",)] * 3 and ref_calls == [()] * 3
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert got.any()
