"""The batched ASRC step (parallel/asrc._asrc_step) in float32 and float64:
direct checks against a plain numpy oracle, and BatchedASRC against
per-stream host engines across bank geometries and ratio regimes."""

import numpy as np
import pytest
import jax.numpy as jnp

from art_jax.core.filters import make_filter_bank
from art_jax.core.flags import BLACKMAN_HARRIS, SUBSAMPLE_INTERPOLATE
from art_jax.engines.resampler import Resampler
from art_jax.parallel.asrc import BatchedASRC, _asrc_step
from art_jax.utils.testsig import NoiseLCG

DTYPES = [np.float32, np.float64]
# f32: the device dot and the host dot round differently at the f32 floor
# (PARITY.md); f64: identical positions, phases and fractions, so only the
# summation order over taps differs — a few ulps of |sum| < ~4
TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _host_engines(S, taps, filters, dtype):
    singles = []
    for _ in range(S):
        r = Resampler(1, taps, filters, 0.0,
                      SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS,
                      backend="numpy", dtype=dtype)
        r.advance_position(taps // 2)
        singles.append(r)
    return singles


def _run_vs_hosts(b, singles, x, ratios, cap):
    """One call on the batched engine and on every host engine; counts and
    positions exact.  Returns the max sample deviation."""
    S, n = x.shape
    out, Ks = b.process(jnp.asarray(x), ratios)
    out = np.asarray(out)
    md = 0.0
    for s in range(S):
        ho, res = singles[s].process(x[s:s + 1], n, cap, float(ratios[s]))
        assert res.output_generated == Ks[s]
        assert b.get_position()[s] == singles[s].get_position()
        if Ks[s]:
            md = max(md, float(np.abs(ho[0] - out[s, :Ks[s]]).max()))
    assert not out[:, Ks.max():].any()
    return md


def _numpy_step(buf, bank, offsets, ratios, Ks, shift, T, F, k_max):
    """Plain float64 loop over every (stream, output) of the step."""
    S = buf.shape[0]
    half = T // 2
    out = np.zeros((S, k_max), np.float64)
    for s in range(S):
        for k in range(int(Ks[s])):
            pos = offsets[s] + k / ratios[s]
            ipos = np.floor(pos)
            ff = (pos - ipos) * F
            fi = min(int(np.floor(ff)), F - 1)
            frac = ff - fi
            b0 = int(ipos) - half + 1 + shift
            win = buf[s, b0:b0 + T].astype(np.float64)
            w = (bank[fi].astype(np.float64) * (1.0 - frac)
                 + bank[fi + 1].astype(np.float64) * frac)
            out[s, k] = (win * w).sum()
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,n,T,F", [(8, 256, 48, 64), (16, 512, 156, 320)])
def test_asrc_step_matches_numpy_oracle(S, n, T, F, dtype):
    bank = make_filter_bank(T, F, 1.0, True, dtype)
    H = T * 16
    rng = np.random.default_rng(T + F)
    hist = rng.standard_normal((S, H)).astype(dtype)
    x = rng.standard_normal((S, n)).astype(dtype)
    buf = np.concatenate([hist, x], axis=1)
    ratios = 1.0 + rng.uniform(-0.05, 0.05, S)
    offsets = H - n // 2 + rng.uniform(0.0, 4.0, S) - float(H)
    shift = H                       # linear coordinate 0 = buffer column H
    Ks = np.full(S, n // 3, np.int32)
    k_max = 2 * n // 3
    new_hist, out = _asrc_step(
        jnp.asarray(hist), jnp.asarray(x), jnp.asarray(bank),
        jnp.asarray(offsets), jnp.asarray(ratios), jnp.asarray(Ks),
        jnp.int32(shift), num_taps=T, num_filters=F, k_max=k_max,
        hist_len=H)
    ref = _numpy_step(buf, bank, offsets, ratios, Ks, shift, T, F, k_max)
    assert out.dtype == dtype and out.shape == (S, k_max)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=TOL[dtype])
    np.testing.assert_array_equal(np.asarray(new_hist), buf[:, -H:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_asrc_engine_matches_per_stream_engines(dtype):
    """Counts, samples and positions vs per-stream host engines over
    drifting ratios near 1, with one call of widely spread ratios."""
    S, taps, filters = 8, 48, 64
    rng = np.random.default_rng(1)
    lcg = NoiseLCG()
    b = BatchedASRC(S, taps, filters, dtype=dtype)
    b.advance_position(taps // 2)
    singles = _host_engines(S, taps, filters, dtype)
    md = 0.0
    for it in range(4):
        x = lcg.fill(S * 384).reshape(S, 384).astype(dtype)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        if it == 2:
            ratios = rng.uniform(0.3, 2.7, S)
        md = max(md, _run_vs_hosts(b, singles, x, ratios, 2000))
    assert md < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_asrc_large_taps_config(dtype):
    """Preset-4-class bank (988 taps x 988 filters) vs per-stream hosts."""
    S, taps, filters = 8, 988, 988
    lcg = NoiseLCG()
    b = BatchedASRC(S, taps, filters, dtype=dtype)
    b.advance_position(taps // 2)
    singles = _host_engines(S, taps, filters, dtype)
    rng = np.random.default_rng(2)
    md = 0.0
    for _ in range(2):
        x = lcg.fill(S * 1024).reshape(S, 1024).astype(dtype)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        md = max(md, _run_vs_hosts(b, singles, x, ratios, 2000))
    assert md < TOL[dtype]


GEOMETRIES_WIDE = [
    (16, 127),    # odd filter count
    (16, 126),
    (48, 1),      # degenerate single-filter bank
    (100, 200),   # taps not a power of two
    (156, 320),   # preset-2 shape
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("taps,filters", GEOMETRIES_WIDE)
def test_asrc_fuzz_configs_wide_ratios(taps, filters, dtype):
    """Bank geometries (odd and degenerate filter counts, odd tap counts)
    under ratios spread over 0.6-1.8."""
    S = 8
    lcg = NoiseLCG()
    rng = np.random.default_rng(taps * 1000 + filters)
    b = BatchedASRC(S, taps, filters, dtype=dtype)
    b.advance_position(taps // 2)
    singles = _host_engines(S, taps, filters, dtype)
    md = 0.0
    for _ in range(2):
        x = lcg.fill(S * 300).reshape(S, 300).astype(dtype)
        ratios = rng.uniform(0.6, 1.8, S)
        md = max(md, _run_vs_hosts(b, singles, x, ratios, 1200))
    assert md < TOL[dtype], (taps, filters, md)


GEOMETRIES_NEAR1 = [(48, 64), (128, 380), (380, 380), (256, 129),
                    (1024, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("taps,filters", GEOMETRIES_NEAR1)
def test_asrc_fuzz_configs_near_unity(taps, filters, dtype):
    """The ASRC home regime: ratios within +-3.15% of 1 (|1/r - 1| up to
    4/127 exactly on both sides, then random inside), where successive
    outputs mostly advance one input and the phase index sweeps every
    filter; the fi clamp edge is reached."""
    S = 8
    lcg = NoiseLCG()
    rng = np.random.default_rng(taps * 7 + filters)
    b = BatchedASRC(S, taps, filters, dtype=dtype)
    b.advance_position(taps // 2)
    bound = 4 / 127
    singles = _host_engines(S, taps, filters, dtype)
    md = 0.0
    for it in range(3):
        x = lcg.fill(S * 300).reshape(S, 300).astype(dtype)
        if it == 0:
            q = 1.0 + bound * np.where(np.arange(S) % 2 == 0, 1.0, -1.0)
            ratios = 1.0 / q
        else:
            ratios = 1.0 + rng.uniform(-0.8 * bound, 0.8 * bound, S)
        md = max(md, _run_vs_hosts(b, singles, x, ratios, 1200))
    assert md < TOL[dtype], (taps, filters, md)
