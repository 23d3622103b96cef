"""Biquad parity against the C reference (cascaded lowpass over noise)."""

import subprocess

import numpy as np
import pytest

from art_jax.engines.biquad import (Biquad, biquad_highpass, biquad_lowpass)
from art_jax.utils.testsig import NoiseLCG


@pytest.mark.parametrize("mode,freq", [("lowpass", 0.2), ("lowpass", 0.45),
                                       ("highpass", 0.1)])
def test_cascaded_biquad_bit_exact(golden_bin, mode, freq):
    n = 4000
    raw = subprocess.run([str(golden_bin), "biquad", mode, str(freq), str(n)],
                         capture_output=True, check=True).stdout
    ref = np.frombuffer(raw, dtype=np.float32)
    coeffs = biquad_lowpass(freq) if mode == "lowpass" else biquad_highpass(freq)
    f1 = Biquad.init(coeffs, 1.0, channels=1, dtype=np.float32)
    f2 = Biquad.init(coeffs, 1.0, channels=1, dtype=np.float32)
    x = NoiseLCG().fill(n)
    y = f2.apply_buffer(f1.apply_buffer(x))
    np.testing.assert_array_equal(y, ref)


def test_apply_sample_matches_buffer_order_differs_only_in_association():
    """Sample and buffer paths use different sum associations; outputs agree
    within float noise (and exactly for order-1)."""
    coeffs = biquad_lowpass(0.3)
    f1 = Biquad.init(coeffs, 1.0, channels=1)
    f2 = Biquad.init(coeffs, 1.0, channels=1)
    x = NoiseLCG().fill(500)
    ys = np.array([f1.apply_sample(np.array([v], np.float32))[0] for v in x])
    yb = f2.apply_buffer(x)
    assert np.abs(ys - yb).max() < 1e-5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ch", [1, 6])
def test_fused_cascade_bit_exact(dtype, ch):
    """The fused native cascade (one buffer pass, both stages per sample)
    is bit-identical to chaining apply_buffer per stage, including streaming
    state across chunk boundaries and mixed designs/orders."""
    from art_jax.engines.biquad import apply_cascade
    designs = [biquad_lowpass(0.41), biquad_highpass(0.07)]
    fa = [Biquad.init(c, 1.0, channels=ch, dtype=dtype) for c in designs]
    fb = [Biquad.init(c, 1.0, channels=ch, dtype=dtype) for c in designs]
    x = NoiseLCG().fill(700 * ch).astype(dtype).reshape(-1, ch)
    if ch == 1:
        x = x[:, 0]
    for lo, hi in [(0, 250), (250, 251), (251, 700)]:   # uneven chunks
        chunk = x[lo:hi]
        y_fused = apply_cascade(fa, chunk)
        y_seq = chunk
        for bq in fb:
            y_seq = bq.apply_buffer(y_seq, use_native=False)
        np.testing.assert_array_equal(y_fused, y_seq)
    for qa, qb in zip(fa, fb):                          # state carried equal
        np.testing.assert_array_equal(qa.xh, qb.xh)
        np.testing.assert_array_equal(qa.yh, qb.yh)


def test_multichannel_lanes_independent():
    coeffs = biquad_lowpass(0.25)
    f = Biquad.init(coeffs, 1.0, channels=3)
    x = NoiseLCG().fill(300 * 3).reshape(300, 3)
    y = f.apply_buffer(x)
    for c in range(3):
        fc = Biquad.init(coeffs, 1.0, channels=1)
        yc = fc.apply_buffer(x[:, c])
        np.testing.assert_array_equal(y[:, c], yc)


def test_associative_scan_matches_sequential():
    """The device parallel-scan biquad (O(log n) depth) agrees with the
    sequential reference path within the f32 floor, including carried state
    across blocks."""
    from art_jax.ops.biquad_kernel import biquad_apply_buffer_assoc
    x = NoiseLCG().fill(8000).reshape(4000, 2)
    coeffs = biquad_lowpass(0.23)
    f1 = Biquad.init(coeffs, 1.0, 2)
    f2 = Biquad.init(coeffs, 1.0, 2)
    for _ in range(2):
        y_seq = f1.apply_buffer(x.copy(), use_native=False)
        y_dev = biquad_apply_buffer_assoc(f2, x.copy())
        assert np.abs(y_seq - y_dev).max() < 3e-7
    # 4th-order (ATH-like) coefficients stay stable through the scan
    from art_jax.engines.biquad import BiquadCoefficients
    c4 = BiquadCoefficients(a0=2.2061, a1=0.606, a2=-0.2524, a3=-0.0737,
                            b1=1.0587, b2=0.0676, b3=-0.6054, b4=-0.2738)
    g1 = Biquad.init(c4, 1.0, 1)
    g2 = Biquad.init(c4, 1.0, 1)
    z = NoiseLCG().fill(2000)
    ya = g1.apply_buffer(z.copy(), use_native=False)
    yb = biquad_apply_buffer_assoc(g2, z.copy())
    assert np.abs(ya - yb).max() < 2e-5


def test_gain_folding():
    coeffs = biquad_lowpass(0.2)
    f1 = Biquad.init(coeffs, 2.0, channels=1)
    f2 = Biquad.init(coeffs, 1.0, channels=1)
    x = NoiseLCG().fill(64)
    y1 = f1.apply_buffer(x.copy())
    y2 = f2.apply_buffer(x.copy())
    # gain applies to the feed-forward side only: same shape, scaled drive
    assert np.abs(y1).max() > np.abs(y2).max()


def test_masked_block_iir_ragged_K_and_tables():
    """assoc_core_masked across block-boundary K values (the block-IIR
    form computes in B=256 blocks): y below K matches a sequential host
    filter fed exactly K samples, state advances by exactly K, and the
    precomputed-tables path is bitwise equal to the in-graph build."""
    import jax.numpy as jnp

    from art_jax.ops.biquad_kernel import assoc_core_masked, iir_tables

    coeffs = biquad_lowpass(0.23)
    n, S = 700, 3
    x = NoiseLCG().fill(n * S).reshape(n, S)
    tabs = iir_tables(np.asarray(Biquad.init(coeffs, 1.0, 1).b))
    for K in (0, 1, 3, 255, 256, 257, 699, 700):
        host = Biquad.init(coeffs, 1.0, S)
        ref = host.apply_buffer(x[:K].copy(), use_native=False) \
            if K else np.zeros((0, S), np.float32)
        dev = Biquad.init(coeffs, 1.0, S)
        a = jnp.asarray(np.asarray(dev.a, np.float64))
        b = jnp.asarray(np.asarray(dev.b, np.float64))
        xh = jnp.zeros((4, S), jnp.float64)
        yh = jnp.zeros((4, S), jnp.float64)
        y1, xh1, yh1 = assoc_core_masked(jnp.asarray(x), a, b, xh, yh,
                                         jnp.int32(K))
        y2, xh2, yh2 = assoc_core_masked(jnp.asarray(x), a, b, xh, yh,
                                         jnp.int32(K), tabs)
        # tables are host-numpy-built, the in-graph build uses XLA f64
        # dots: 1-ulp table differences are expected, so equality holds
        # at the f64 ulp class, not bitwise
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                   rtol=1e-12, atol=1e-14)
        assert np.asarray(xh1).tobytes() == np.asarray(xh2).tobytes()
        np.testing.assert_allclose(np.asarray(yh1), np.asarray(yh2),
                                   rtol=1e-12, atol=1e-14)
        y1 = np.asarray(y1)
        if K:
            assert np.abs(y1[:K] - ref).max() < 3e-7
        assert not np.any(y1[K:])
        # state == the host filter's streaming state after K samples
        np.testing.assert_allclose(np.asarray(xh1),
                                   np.asarray(host.xh, np.float64),
                                   atol=1e-7)
        np.testing.assert_allclose(np.asarray(yh1),
                                   np.asarray(host.yh, np.float64),
                                   atol=3e-7)


def test_assoc_core_full_matches_masked_bitwise():
    """assoc_core_full (the maskless whole-chunk streaming shape) is
    bitwise-identical to assoc_core_masked at K == n, outputs and state,
    f32 and f64."""
    import jax.numpy as jnp

    from art_jax.ops.biquad_kernel import (assoc_core_full,
                                           assoc_core_masked, iir_tables)
    coeffs = biquad_lowpass(0.31)
    for dt in (np.float32, np.float64):
        bq = Biquad.init(coeffs, 1.0, channels=3, dtype=dt)
        x = NoiseLCG().fill(3 * 1000, dt).reshape(1000, 3)
        t = iir_tables(np.asarray(bq.b, np.float64))
        a = jnp.asarray(np.asarray(bq.a, np.float64))
        b = jnp.asarray(np.asarray(bq.b, np.float64))
        xh = jnp.asarray(np.random.default_rng(0).standard_normal((4, 3)))
        yh = jnp.asarray(np.random.default_rng(1).standard_normal((4, 3)))
        y1, xh1, yh1 = assoc_core_masked(jnp.asarray(x), a, b, xh, yh,
                                         jnp.int32(1000), t)
        y2, xh2, yh2 = assoc_core_full(jnp.asarray(x), a, b, xh, yh, t)
        np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
        np.testing.assert_array_equal(np.asarray(xh1), np.asarray(xh2))
        np.testing.assert_array_equal(np.asarray(yh1), np.asarray(yh2))


def test_combined_order4_matches_cascade():
    """DeviceBiquadCascade(combined=True): the two-section -p cascade as
    ONE order-4 section (combine_biquads — half the Toeplitz/FIR work).
    Streaming over ragged chunks: outputs within the documented ~1e-12
    f64 reassociation class of the sequential cascade form, state
    advance consistent, pull_to refused (no internal section-1
    history)."""
    import jax.numpy as jnp

    from art_jax.engines.biquad import Biquad, biquad_lowpass
    from art_jax.ops.biquad_kernel import DeviceBiquadCascade

    coeffs = biquad_lowpass(0.45 * 44100 / 48000)
    ch = 6

    def pair():
        return (Biquad.init(coeffs, 1.0, ch, np.float64),
                Biquad.init(coeffs, 1.0, ch, np.float64))

    casc = DeviceBiquadCascade(*pair())
    comb = DeviceBiquadCascade(*pair(), combined=True)
    casc.push_from(*pair())
    comb.push_from(*pair())

    rng = np.random.default_rng(7)
    md = 0.0
    for n, K in ((4096, 4096), (1000, 700), (2048, 2048)):
        x = jnp.asarray(rng.standard_normal((ch, n)) * 0.5)
        ya = np.asarray(casc.process(x, K))
        yb = np.asarray(comb.process(x, K))
        md = max(md, float(np.abs(ya - yb)[:, :K].max()))
    assert md < 1e-11, md
    # combined state: input history equals the cascade's section-1 input
    # history; output history equals the cascade's section-2 output
    np.testing.assert_allclose(np.asarray(comb._state[0]),
                               np.asarray(casc._state[0]), atol=1e-11)
    np.testing.assert_allclose(np.asarray(comb._state[1]),
                               np.asarray(casc._state[3]), atol=1e-11)
    with pytest.raises(NotImplementedError, match="combined"):
        comb.pull_to(*pair())


@pytest.mark.parametrize("combined", [False, True])
def test_refined_solve_matches_exact(combined):
    """DeviceBiquadCascade(refine=True): the mixed-precision iterative
    refinement solve (f32 block solves + f64 pointwise residuals,
    _iir_y_refined) stays in the exact emulated-f64 solve's own accuracy
    class over streaming ragged chunks (~5e-15 vs a sequential oracle
    with 2 passes; one pass reaches ~3e-12)."""
    import jax.numpy as jnp

    from art_jax.engines.biquad import Biquad, biquad_lowpass
    from art_jax.ops.biquad_kernel import DeviceBiquadCascade

    coeffs = biquad_lowpass(0.45 * 44100 / 48000)
    ch = 6

    def pair():
        return (Biquad.init(coeffs, 1.0, ch, np.float64),
                Biquad.init(coeffs, 1.0, ch, np.float64))

    # refine defaults True — the exact engine must opt OUT or this
    # test compares the refined solve against itself (caught in review)
    exact = DeviceBiquadCascade(*pair(), combined=combined, refine=False)
    refd = DeviceBiquadCascade(*pair(), combined=combined, refine=True)
    exact.push_from(*pair())
    refd.push_from(*pair())

    rng = np.random.default_rng(13)
    md, scale = 0.0, 0.0
    for n, K in ((4096, 4096), (1000, 700), (2048, 2048), (4096, 4096)):
        x = jnp.asarray(rng.standard_normal((ch, n)) * 0.5)
        ya = np.asarray(exact.process(x, K))
        yb = np.asarray(refd.process(x, K))
        md = max(md, float(np.abs(ya - yb)[:, :K].max()))
        scale = max(scale, float(np.abs(ya).max()))
    assert md / scale < 1e-12, (md, scale)
    for sa, sb in zip(exact._state, refd._state):
        np.testing.assert_allclose(np.asarray(sb), np.asarray(sa),
                                   atol=1e-12)


def test_masked_T_matches_masked_bitwise():
    """assoc_core_masked_T (channel-major F2-native masked path, the CLI
    device chain's per-chunk shape) is bitwise-identical to
    assoc_core_masked — outputs AND state — across K edge cases incl.
    K < 4 (boundary-history picks) and block-boundary K."""
    import jax.numpy as jnp

    from art_jax.engines.biquad import Biquad, biquad_lowpass
    from art_jax.ops.biquad_kernel import (assoc_core_masked,
                                           assoc_core_masked_T,
                                           combine_biquads, iir_tables)

    coeffs = biquad_lowpass(0.45 * 44100 / 48000)
    b1 = Biquad.init(coeffs, 1.0, 6, np.float64)
    ac, bc = combine_biquads(b1, Biquad.init(coeffs, 1.0, 6, np.float64))
    aj, bj = jnp.asarray(ac), jnp.asarray(bc)
    t64 = iir_tables(bc)
    rng = np.random.default_rng(3)
    n = 1500
    x = rng.standard_normal((6, n)) * 0.5
    xh = rng.standard_normal((4, 6)) * 0.1
    yh = rng.standard_normal((4, 6)) * 0.1
    for K in (0, 3, 4, 255, 256, 257, 1499, 1500):
        ya, xa, yha = assoc_core_masked(jnp.asarray(x.T), aj, bj,
                                        jnp.asarray(xh), jnp.asarray(yh),
                                        jnp.int32(K), t64, 6)
        yb, xb, yhb = assoc_core_masked_T(jnp.asarray(x), aj, bj,
                                          jnp.asarray(xh),
                                          jnp.asarray(yh),
                                          jnp.int32(K), t64, 6)
        np.testing.assert_array_equal(np.asarray(ya).T, np.asarray(yb))
        np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))
        np.testing.assert_array_equal(np.asarray(yha), np.asarray(yhb))
