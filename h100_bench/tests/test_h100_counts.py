"""The frozen work counts and the roofline arithmetic against shapes
worked out by hand."""

import os
import types

import pytest

from h100_bench import roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAKS = {"sms": 132, "sm_hz": 1.98e9}
ISSUE = 132 * 128 * 1.98e9          # lane-instructions a second


def record(counters, splint_len=200, by_name=None):
    rec = roofline.RunRecord(
        dict(reads=1000, t0=0.0, t1=1.0, stages={}, counters=counters),
        [], {"by_name": by_name or {}}, PEAKS,
        {"splints": [{"name": "Splint1", "length": splint_len}]}, HERE)
    return rec


def test_units_are_real_cells_and_columns():
    # 1000 real read columns over 2 combos, splint of 200
    rec = record({"locate_cells_real": 2000, "locate_cells_padded": 5000,
                  "align_cells": 7})
    assert rec.units("profile_cell") == 2000 * 200
    assert rec.units("read_column") == 1000
    assert rec.units("align_cell") == 7
    with pytest.raises(ValueError):
        rec.units("padded_cell")


def test_bounds_by_hand():
    rec = record({"locate_cells_real": 2000, "align_cells": 10 ** 9})
    c = rec.counts
    # profile: 400,000 cells x 2.5 instructions on 132 x 128 lanes at
    # 1.98 GHz; its 1000 code bytes at 3.35 TB/s are less
    assert roofline.bound_s(c["profile_kernel"], rec.units, PEAKS) == \
        pytest.approx(400_000 * 2.5 / ISSUE)
    # smoothing: 246 FP32 instructions a column against 8 bytes a column
    assert roofline.bound_s(c["smooth3_kernel"], rec.units, PEAKS) == \
        pytest.approx(max(1000 * 246 / ISSUE, 8000 / 3.35e12))
    # peaks: 4 bytes a column bound it
    assert roofline.bound_s(c["pk_kernel"], rec.units, PEAKS) == \
        pytest.approx(4000 / 3.35e12)
    # forward: 1e9 band cells x 6 instructions; 0.5 bytes a cell less
    assert roofline.bound_s(c["banded_fwd_kernel"], rec.units, PEAKS) == \
        pytest.approx(6e9 / ISSUE)


def test_roofline_share_from_device_time_by_name():
    name = ("void (anonymous namespace)::banded_fwd_kernel<4>(signed char "
            "const*, int)")
    rec = record({"locate_cells_real": 2000, "align_cells": 10 ** 9},
                 by_name={name: 6e9 / ISSUE * 4,
                          "banded_fwd_kernel_other(int)": 1.0})
    assert rec.roofline_pct(("banded_fwd_kernel",)) == pytest.approx(25.0)
    # a kernel with no device time reads nothing, never 0
    assert rec.roofline_pct(("profile_kernel",)) is None
    assert roofline.kernel_time({"xbanded_fwd_kernel(int)": 1.0},
                                "banded_fwd_kernel") == 0


def test_no_clock_reads_nothing():
    rec = record({"align_cells": 10})
    rec.peaks = types.MappingProxyType({"sms": 132, "sm_hz": None})
    assert rec.roofline_pct(("banded_fwd_kernel",)) is None
