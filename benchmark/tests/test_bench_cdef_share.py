"""cdef_device_share on planted per-frame records: 100 where every frame
ran its CDEF on the card, 0 where every frame ran the C, the mean between,
and nothing where no frame holds the counter (an untraced run, or a
program that lacks it)."""

import types

import harness
import pytest


def _read(records):
    ctx = types.SimpleNamespace(records=records)
    return harness.load_module("metrics", "cdef_device_share").read(ctx)


def _frames(values):
    return [{"frame": i, "inter_commit_walk": 300.0, "cdef": 12.0,
             "cdef.device": v} for i, v in enumerate(values)]


@pytest.mark.parametrize("values,want", [([1.0] * 6, 100.0),
                                         ([0.0] * 6, 0.0),
                                         ([1.0, 0.0, 1.0, 1.0], 75.0)])
def test_share_of_planted_counters(values, want):
    assert _read(_frames(values)) == pytest.approx(want)


def test_frames_without_the_counter_are_left_out():
    recs = _frames([1.0, 1.0]) + [{"frame": 9, "gop_dispatch": 1200.0}]
    assert _read(recs) == pytest.approx(100.0)


@pytest.mark.parametrize("records", [None, [],
                                     [{"frame": 0, "cdef": 140.0}]],
                         ids=["untraced", "no-frames", "no-counter"])
def test_absent_without_the_counter(records):
    assert _read(records) is None
    assert harness.load_module("metrics", "cdef_device_share").read(
        types.SimpleNamespace()) is None
