"""Vectorized dry-run query parity vs the per-sample reference loops.

get_required_samples / get_expected_output mirror the reference's
accumulated ``offset += 1/ratio`` stepping (resampler.c:853-918), which the
vectorized versions reproduce exactly: np.cumsum applies the same strict
left-to-right float64 additions, and ring slides subtract exact integers.
"""

import time

import numpy as np
import pytest

from art_jax.core import accounting as acc
from art_jax.core.flags import RESAMPLE_FIXED_RATIO, RESAMPLER_FLUSHED


def _fuzz_states(n):
    rng = np.random.default_rng(7)
    for _ in range(n):
        taps = int(rng.choice([4, 16, 48, 380]))
        num_samples = taps * 16
        idx = int(rng.integers(taps, num_samples + 1))
        offset = float(rng.uniform(0, idx))
        ratio = float(rng.choice([
            rng.uniform(0.05, 0.3), rng.uniform(0.3, 1.1),
            rng.uniform(0.9, 1.1), rng.uniform(1.0, 20.0)]))
        yield taps, num_samples, idx, offset, ratio


@pytest.mark.parametrize("case", range(40))
def test_required_samples_matches_loop(case):
    gen = list(_fuzz_states(40))[case]
    taps, num_samples, idx, offset, ratio = gen
    rng = np.random.default_rng(case)
    for n_out in [0, 1, int(rng.integers(2, 5000)),
                  int(rng.integers(5000, 40000))]:
        kw = dict(output_offset=offset, input_index=idx,
                  num_samples=num_samples, num_taps=taps,
                  n_out=n_out, ratio=ratio)
        assert acc.simulate_required_samples(**kw) \
            == acc._simulate_required_samples_loop(**kw), (gen, n_out)


@pytest.mark.parametrize("case", range(40))
def test_expected_output_matches_loop(case):
    gen = list(_fuzz_states(40))[case]
    taps, num_samples, idx, offset, ratio = gen
    rng = np.random.default_rng(100 + case)
    flags = [0, RESAMPLE_FIXED_RATIO, RESAMPLER_FLUSHED][case % 3]
    for n_in in [-1, 0, 1, int(rng.integers(2, 5000)),
                 int(rng.integers(5000, 40000))]:
        kw = dict(output_offset=offset, input_index=idx, flags=flags,
                  num_samples=num_samples, num_taps=taps, n_in=n_in,
                  ratio=ratio, fixed_ratio=ratio * 1.01)
        assert acc.simulate_expected_output(**kw) \
            == acc._simulate_expected_output_loop(**kw), (gen, n_in, flags)


def test_dry_run_queries_scale_to_millions():
    """A 1e7-output sizing query completes in well under a second
    (the round-1 per-sample loop took minutes)."""
    t0 = time.perf_counter()
    used = acc.simulate_required_samples(
        output_offset=190.0, input_index=380, num_samples=6080,
        num_taps=380, n_out=10_000_000, ratio=48000 / 44100)
    exp = acc.simulate_expected_output(
        output_offset=190.0, input_index=380, flags=0, num_samples=6080,
        num_taps=380, n_in=10_000_000, ratio=48000 / 44100,
        fixed_ratio=0.0)
    dt = time.perf_counter() - t0
    assert abs(used - 10_000_000 * 44100 / 48000) < 10
    assert abs(exp - 10_000_000 * 48000 / 44100) < 10
    assert dt < 5.0


@pytest.mark.parametrize("cfg", [
    # chans, taps, filters, flags(hex), mode, src, dst, lowpass, ratio, block, advance
    (2, 380, 380, 0x7, 1, 44100, 48000, 0, 48000 / 44100, 1000, 190.0),
    (1, 48, 48, 0x3, 0, 1, 1, 0.0, 1.003, 777, 24.0),
    (2, 88, 67, 0x17, 1, 44100, 48000, 0, 48000 / 44100, 1281, 26.25),
    (2, 156, 320, 0x7, 1, 96000, 44100, 0, 44100 / 96000, 2048, 78.0),
    (1, 64, 16, 0x3, 0, 1, 1, 0.5, 0.6, 511, 0.0),
])
def test_dryrun_queries_vs_reference_binary(golden_bin, cfg):
    """GetRequiredSamples / GetExpectedOutput (incl. the flush simulation)
    directly against the LIVE C functions across streamed states — the
    queries accumulate offset += 1/ratio (a different float64 sequence
    from the process loop, reference resampler.c:853-918), so they need
    their own golden rather than the loop-oracle mirrors alone."""
    import subprocess

    from art_jax.engines.resampler import Resampler
    from art_jax.utils.testsig import NoiseLCG

    (chans, taps, filters, flags, mode, src, dst, lowpass, ratio, block,
     advance) = cfg
    nblocks, nq = 3, 8
    args = [str(golden_bin), "query", str(chans), str(taps), str(filters),
            format(flags, "x"), str(mode), str(src), str(dst), str(lowpass),
            repr(ratio), str(block), str(nblocks), repr(advance), str(nq)]
    raw = subprocess.run(args, capture_output=True, check=True).stdout
    vals = np.frombuffer(raw, dtype=np.uint32)
    assert len(vals) == nblocks * (2 + 2 * nq + 1)

    if mode:
        r = Resampler.fixed_ratio(chans, taps, filters, src, dst,
                                  int(lowpass), flags)
    else:
        r = Resampler(chans, taps, filters, lowpass, flags)
    if advance:
        r.advance_position(advance)
    lcg = NoiseLCG()
    outcap = int((block + taps) * max(ratio, 1.0)
                 * max(dst / src if src else 1.0, 1.0)) + taps + 64
    off = 0
    for b in range(nblocks):
        inp = lcg.fill(block * chans).reshape(block, chans)
        out, res = r.process_interleaved(inp, block, outcap, ratio)
        assert (res.input_used, res.output_generated) == \
            (int(vals[off]), int(vals[off + 1])), b
        off += 2
        for i in range(nq):
            assert r.get_required_samples(1 + i * 7, ratio) == \
                int(vals[off]), (b, i)
            assert r.get_expected_output(1 + i * 11, ratio) == \
                int(vals[off + 1]), (b, i)
            off += 2
        assert r.get_expected_output(-1, ratio) == int(vals[off]), b
        off += 1
