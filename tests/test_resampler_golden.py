"""Streaming resampler parity against the compiled C reference.

Every case streams chunked LCG noise through both implementations and asserts:
exact input_used/output_generated per call, exact final phase position, and
samples within the float32 rounding floor (bit-exact for passthrough paths).
"""

import numpy as np
import pytest

from art_jax.core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                                INCLUDE_LOWPASS, NO_FILTER_REDUCTION,
                                SUBSAMPLE_INTERPOLATE)
from helpers import compare_stream

I, B, L, X = (SUBSAMPLE_INTERPOLATE, BLACKMAN_HARRIS, INCLUDE_LOWPASS,
              EXTRAPOLATE_ENDPOINTS)
F32_ATOL = 1.2e-7      # one f32 ulp at |x| ~ 1

CASES = [
    # name, chans, taps, filters, flags, mode, src, dst, lowpass, ratio, block, nblocks, advance
    ("fixed_441_480_st", 2, 380, 380, I | B | L, 1, 44100, 48000, 0, 48000 / 44100, 1000, 4, 190.0),
    ("fixed_interp_forced", 2, 380, 380, I | B | L | NO_FILTER_REDUCTION, 1, 44100, 48000, 0, 48000 / 44100, 1000, 4, 190.0),
    ("legacy_asrc", 1, 48, 48, I | B, 0, 1, 1, 0.0, 1.003, 777, 5, 24.0),
    ("fixed_downsample", 2, 156, 320, I | B | L, 1, 96000, 44100, 0, 44100 / 96000, 2048, 3, 78.0),
    ("fixed_extrapolate", 1, 380, 380, I | B | L | X, 1, 44100, 48000, 0, 48000 / 44100, 1000, 3, 190.0),
    ("legacy_lowpass", 2, 64, 16, I | B, 0, 1, 1, 0.5, 0.6, 511, 4, 0.0),
    ("allpass_unity", 1, 48, 48, B, 0, 1, 1, 0.0, 1.0, 500, 3, 24.0),
    ("fixed_upsample_12x", 1, 48, 48, I | B | L, 1, 8000, 96000, 0, 12.0, 300, 3, 24.0),
    ("tiny_blocks", 2, 48, 48, I | B | L, 1, 44100, 48000, 0, 48000 / 44100, 64, 20, 24.0),
    ("hann_window", 1, 96, 64, I, 0, 1, 1, 0.8, 0.9, 900, 3, 48.0),
    ("many_channels", 6, 48, 48, I | B | L, 1, 48000, 44100, 0, 44100 / 48000, 512, 3, 24.0),
    ("phase_shift", 1, 48, 48, I | B | NO_FILTER_REDUCTION, 1, 44100, 48000, 0, 48000 / 44100, 512, 3, 24.25),
    ("long_stream_slides", 1, 48, 48, I | B | L, 1, 44100, 48000, 0, 48000 / 44100, 4096, 6, 24.0),
    # fuzz seed 5113: the emission boundary lands on a float64 rounding TIE
    # whose decision differs between entry and slid ring coordinates — the
    # reference re-rounds fl(outputOffset + offset2) after each mid-call
    # slide (resampler.c:500-501, 526), so the count must be evaluated in
    # ring coordinates (accounting._ring_floor); with an entry-coordinate
    # compare this config generated 1394 (not 1395) on block 1
    ("slide_tie_boundary", 2, 88, 67, I | B | L | NO_FILTER_REDUCTION, 1, 44100, 48000, 0, 48000 / 44100, 1281, 3, 26.25),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stream_parity_f32(golden_bin, case):
    (_, chans, taps, filters, flags, mode, src, dst, lowpass, ratio, block,
     nblocks, advance) = case
    compare_stream(golden_bin, chans=chans, taps=taps, filters=filters,
                   flags=flags, mode=mode, src=src, dst=dst, lowpass=lowpass,
                   ratio=ratio, block=block, nblocks=nblocks, advance=advance,
                   atol=F32_ATOL)


@pytest.mark.parametrize("case", CASES[:6], ids=[c[0] for c in CASES[:6]])
def test_stream_parity_f64(golden_bin64, case):
    (_, chans, taps, filters, flags, mode, src, dst, lowpass, ratio, block,
     nblocks, advance) = case
    compare_stream(golden_bin64, chans=chans, taps=taps, filters=filters,
                   flags=flags, mode=mode, src=src, dst=dst, lowpass=lowpass,
                   ratio=ratio, block=block, nblocks=nblocks, advance=advance,
                   atol=1e-12, dtype=np.float64)


@pytest.mark.parametrize("case", CASES[:6], ids=[c[0] for c in CASES[:6]])
def test_stream_parity_jax_backend(golden_bin, case):
    (_, chans, taps, filters, flags, mode, src, dst, lowpass, ratio, block,
     nblocks, advance) = case
    compare_stream(golden_bin, chans=chans, taps=taps, filters=filters,
                   flags=flags, mode=mode, src=src, dst=dst, lowpass=lowpass,
                   ratio=ratio, block=block, nblocks=nblocks, advance=advance,
                   atol=1e-6, backend="jax")


def test_varying_ratio_asrc(golden_bin):
    """Drifting-ratio ASRC: ratio changes per call (no in-repo C caller, but
    the API contract is per-call ratio; verify against C by driving the
    reference process with per-call ratios via repeated single-block dumps is
    impractical — instead assert internal consistency: position recurrence
    matches get_expected_output and round-trips sample counts."""
    from art_jax.engines.resampler import Resampler
    from art_jax.utils.testsig import NoiseLCG
    r = Resampler(2, 48, 64, 0.0, I | B)
    lcg = NoiseLCG()
    rng = np.random.default_rng(42)
    total_in = total_out = 0
    ratios = 1.0 + rng.uniform(-0.01, 0.01, size=50)
    for k in range(50):
        ratio = float(ratios[k])
        expected = r.get_expected_output(256, ratio)
        inp = lcg.fill(256 * 2).reshape(256, 2)
        out, res = r.process_interleaved(inp, 256, 4096, ratio)
        assert res.input_used == 256
        assert res.output_generated == expected
        pos = r.get_position()
        assert -2.0 < pos < 258.0
        total_in += res.input_used
        total_out += res.output_generated
    assert abs(total_out - total_in * float(ratios.mean())) < 300
