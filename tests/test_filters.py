"""Filter-bank golden tests against the C reference."""

import subprocess

import numpy as np
import pytest

from art_jax.core.filters import (FixedRatioPlan, make_filter_bank,
                                  plan_fixed_ratio)
from art_jax.core.flags import (INCLUDE_LOWPASS, NO_FILTER_REDUCTION,
                                RESAMPLER_SNAP_OFFSET, SUBSAMPLE_INTERPOLATE)

CASES = [
    (380, 380, 1.0, 1), (48, 48, 1.0, 1), (380, 160, 0.9, 1),
    (156, 320, 0.85, 0), (16, 4, 1.0, 1), (988, 988, 0.97, 1),
    (1024, 1024, 1.0, 0), (4, 1, 1.0, 1),
]


@pytest.mark.parametrize("taps,filt,lp,bh", CASES)
def test_bank_matches_reference(golden_bin, taps, filt, lp, bh):
    raw = subprocess.run(
        [str(golden_bin), "bank", str(taps), str(filt), str(lp), str(bh), "1"],
        capture_output=True, check=True).stdout
    ref = np.frombuffer(raw, dtype=np.float32).reshape(filt + 1, taps)
    mine = make_filter_bank(taps, filt, lp if 0 < lp < 1 else 1.0, bool(bh),
                            np.float32)
    # tolerance covers libmvec-vs-libm trig ULP noise in the reference build
    # flipping the final f32 storage rounding of individual taps
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-9)


def test_bank_unity_dc_gain():
    bank = make_filter_bank(380, 380, 1.0, True, np.float32)
    sums = bank.astype(np.float64).sum(axis=1)
    assert np.abs(sums - 1.0).max() < 2e-7


def test_bank_f64():
    bank = make_filter_bank(48, 48, 1.0, True, np.float64)
    sums = bank.sum(axis=1)
    assert np.abs(sums - 1.0).max() < 1e-14


def test_rotated_last_filter():
    bank = make_filter_bank(48, 16, 1.0, True, np.float32)
    assert bank[16, 0] == 0.0 and bank[0, 47] == 0.0
    np.testing.assert_array_equal(bank[16, 2:], bank[0, 1:47])


def test_fixed_ratio_planner_reduction():
    # 44.1k -> 48k: gcd 300, factor 160 <= 380 -> reduced, snap (160 not 2^n)
    plan = plan_fixed_ratio(380, 380, 44100, 48000, 0,
                            SUBSAMPLE_INTERPOLATE | INCLUDE_LOWPASS)
    assert isinstance(plan, FixedRatioPlan)
    assert plan.num_filters == 160
    assert not (plan.flags & SUBSAMPLE_INTERPOLATE)
    assert plan.flags & RESAMPLER_SNAP_OFFSET
    # upsampling with no explicit freq: raw ratio 0 -> resolved to "no lowpass"
    assert not (0.0 < plan.lowpass_ratio < 1.0)


def test_fixed_ratio_planner_no_reduction():
    plan = plan_fixed_ratio(380, 380, 44100, 48000, 0,
                            SUBSAMPLE_INTERPOLATE | INCLUDE_LOWPASS
                            | NO_FILTER_REDUCTION)
    assert plan.num_filters == 380
    assert plan.flags & SUBSAMPLE_INTERPOLATE


def test_fixed_ratio_planner_auto_lowpass_downsample():
    plan = plan_fixed_ratio(380, 380, 96000, 44100, 0,
                            SUBSAMPLE_INTERPOLATE | INCLUDE_LOWPASS)
    ratio = 44100 / 96000
    expect = max(1.0 - 7.5 / 380 / ratio, 0.8, ratio) * ratio
    assert abs(plan.lowpass_ratio - expect) < 1e-15


def test_power_of_two_reduction_no_snap():
    # 24k -> 48k: factor 2 (power of two) -> no snap
    plan = plan_fixed_ratio(380, 380, 24000, 48000, 0, SUBSAMPLE_INTERPOLATE)
    assert plan.num_filters == 2
    assert not (plan.flags & RESAMPLER_SNAP_OFFSET)
