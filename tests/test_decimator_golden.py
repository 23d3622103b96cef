"""Decimator parity against the C reference — bit-exact packed bytes and
clipped-sample counts, for all dither types, shaping curves, bit depths and
both compute backends."""

import subprocess

import numpy as np
import pytest

from art_jax.core.flags import (DITHER_FLAT, DITHER_HIGHPASS, DITHER_LOWPASS,
                                SHAPING_1ST_ORDER, SHAPING_2ND_ORDER,
                                SHAPING_3RD_ORDER, SHAPING_ATH_CURVE)
from art_jax.engines.decimator import Decimator, float_integers
from art_jax.utils.testsig import NoiseLCG

D, S = DITHER_HIGHPASS, SHAPING_ATH_CURVE

CASES = [
    ("ath_hp_16_stereo", 2, 16, 2, 1.0, 44100, D | S, 1000, 3),
    ("flat_16", 2, 16, 2, 1.0, 44100, DITHER_FLAT, 1000, 3),
    ("lp_2nd_16", 1, 16, 2, 1.0, 48000, DITHER_LOWPASS | SHAPING_2ND_ORDER, 1000, 2),
    ("ath_8bit", 1, 8, 1, 1.0, 48000, D | S, 500, 2),
    ("hp_3rd_24_in_32", 2, 24, 4, 1.0, 96000, D | SHAPING_3RD_ORDER, 700, 2),
    ("noditer_1st_12b", 1, 12, 2, 0.9, 32000, SHAPING_1ST_ORDER, 600, 2),
    ("clipping_gain", 2, 16, 2, 2.5, 44100, D | S, 1000, 2),
    ("nonstandard_rate", 1, 16, 2, 1.0, 44101, D | S, 500, 2),
    ("four_bit", 1, 4, 1, 1.0, 44100, D | S, 300, 2),
    ("six_channel", 6, 16, 2, 1.0, 48000, D | S, 500, 2),
    ("ath_88k_20b", 2, 20, 3, 1.0, 88200, D | S, 800, 2),
]


def _golden(golden_bin, chans, bits, bytes_, gain, rate, flags, n, nblocks):
    raw = subprocess.run(
        [str(golden_bin), "decimate", str(chans), str(bits), str(bytes_),
         str(gain), str(rate), format(flags, "x"), str(n), str(nblocks)],
        capture_output=True, check=True).stdout
    nbytes = n * chans * bytes_ * nblocks
    ref = np.frombuffer(raw, dtype=np.uint8, count=nbytes)
    clip = int(np.frombuffer(raw, dtype=np.uint32, count=1, offset=nbytes)[0])
    return ref, clip


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_decimate_bit_exact(golden_bin, case, backend):
    _, chans, bits, bytes_, gain, rate, flags, n, nblocks = case
    ref, ref_clip = _golden(golden_bin, chans, bits, bytes_, gain, rate,
                            flags, n, nblocks)
    d = Decimator(chans, bits, bytes_, gain, rate, flags, backend=backend)
    lcg = NoiseLCG()
    mine, clip = [], 0
    for _ in range(nblocks):
        x = lcg.fill(n * chans).reshape(n, chans)
        pb, c = d.process_interleaved(x)
        mine.append(pb.reshape(-1))
        clip += c
    np.testing.assert_array_equal(np.concatenate(mine), ref)
    assert clip == ref_clip


def test_planar_vs_interleaved_identical():
    lcg = NoiseLCG()
    x = lcg.fill(500 * 2).reshape(500, 2)
    d1 = Decimator(2, 16, 2, 1.0, 44100, D | S)
    d2 = Decimator(2, 16, 2, 1.0, 44100, D | S)
    a, ca = d1.process_interleaved(x)
    b, cb = d2.process(np.ascontiguousarray(x.T))
    np.testing.assert_array_equal(a, b)
    assert ca == cb


def test_state_roundtrip_continues_stream():
    lcg = NoiseLCG()
    x = lcg.fill(2000).reshape(1000, 2)
    d1 = Decimator(2, 16, 2, 1.0, 44100, D | S)
    a1, _ = d1.process_interleaved(x[:500])
    st = d1.state_dict()
    a2, _ = d1.process_interleaved(x[500:])
    d2 = Decimator(2, 16, 2, 1.0, 44100, D | S)
    d2.load_state(st)
    b2, _ = d2.process_interleaved(x[500:])
    np.testing.assert_array_equal(a2, b2)


@pytest.mark.parametrize("bits,bytes_", [(8, 1), (16, 2), (24, 3)])
def test_float_integers_roundtrip(bits, bytes_):
    """Quantize then float_integers: recovered floats within one LSB."""
    lcg = NoiseLCG()
    x = lcg.fill(1000).reshape(1000, 1)
    d = Decimator(1, bits, bytes_, 1.0, 44100, 0)  # no dither/shaping
    packed, _ = d.process_interleaved(x)
    back = float_integers(packed.reshape(-1), 1.0, bits, bytes_)
    lsb = 2.0 / (1 << bits)
    assert np.abs(back - x[:, 0]).max() <= lsb


def test_float_integers_sign_extension():
    # 24-bit negative full-scale
    raw = np.array([0x00, 0x00, 0x80], dtype=np.uint8)
    v = float_integers(raw, 1.0, 24, 3)
    assert v[0] == np.float32(-1.0)
    raw = np.array([0xFF, 0xFF, 0x7F], dtype=np.uint8)
    v = float_integers(raw, 1.0, 24, 3)
    assert abs(v[0] - (8388607 / 8388608)) < 1e-7
