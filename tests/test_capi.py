"""C-name API surface smoke tests (the reference's 14 resampler entries plus
decimator/biquad/stretch/extrapolator names)."""

import numpy as np

from art_jax import capi


def test_resampler_c_names_roundtrip():
    cxt = capi.resampleFixedRatioInit(
        2, 48, 48, 44100, 48000, 0,
        capi.SUBSAMPLE_INTERPOLATE | capi.BLACKMAN_HARRIS
        | capi.INCLUDE_LOWPASS)
    assert capi.resampleGetNumFilters(cxt) == 48
    assert capi.resampleGetLowpassRatio(cxt) == 1.0
    capi.resampleAdvancePosition(cxt, 24.0)
    assert capi.resampleGetPosition(cxt) == 24.0
    x = np.zeros((2, 500), np.float32)
    need = capi.resampleGetRequiredSamples(cxt, 100, 0.0)
    expect = capi.resampleGetExpectedOutput(cxt, 500, 0.0)
    out, res = capi.resampleProcess(cxt, x, 500, 2000, 0.0)
    assert res.input_used == 500 and res.output_generated == expect
    assert need > 0
    out, res = capi.resampleProcessAndFlushInterleaved(
        cxt, np.zeros((100, 2), np.float32), 100, 2000, 0.0)
    assert res.output_generated > 0
    capi.resampleReset(cxt)
    capi.resampleFree(cxt)


def test_decimator_c_names():
    cxt = capi.decimateInit(2, 16, 2, 1.0, 44100,
                            capi.DITHER_HIGHPASS | capi.SHAPING_ATH_CURVE)
    packed, clipped = capi.decimateProcessInterleavedLE(
        cxt, np.zeros((64, 2), np.float32))
    assert packed.shape == (64, 4) and clipped == 0
    back = capi.floatIntegersLE(packed.reshape(-1), 1.0, 16, 2)
    assert back.shape == (128,)
    capi.decimateFree(cxt)


def test_biquad_and_stretch_c_names():
    coeffs = capi.biquad_lowpass_c(0.25)
    f = capi.biquad_init(coeffs, 1.0)
    y = capi.biquad_apply_buffer(f, np.ones(32, np.float32))
    assert y.shape == (32,)
    s = capi.stretchInit(30, 800, 1, 0)
    cap = capi.stretchGetOutputCapacity(s, 4096, 2.0)
    assert cap > 4096
    out = capi.stretchProcess(s, np.zeros(4096, np.float32), 4096, 1.0)
    rest = capi.stretchFlush(s)
    assert out.size + rest.size == 4096
    capi.stretchReset(s)
    capi.stretchFree(s)


def test_extrapolator_names():
    x = np.sin(np.arange(64) * 0.3).astype(np.float32)
    fwd = capi.extrapolate_forward(x, 16)
    rev = capi.extrapolate_reverse(x, 16)
    assert fwd.shape == (16,) and rev.shape == (16,)
    assert np.isfinite(fwd).all() and np.isfinite(rev).all()
