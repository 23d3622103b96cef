"""LPC extrapolator parity — bit-exact against the reference's coordinate
descent, PARCOR clamping, fallbacks, and prediction loops."""

import subprocess

import numpy as np
import pytest

from art_jax.engines import extrapolator as ex
from art_jax.utils.testsig import NoiseLCG

CASES = [
    ("fwd", 190, 190, "sine"), ("fwd", 64, 32, "noise"),
    ("fwd", 190, 190, "noise"), ("rev", 190, 190, "sine"),
    ("rev", 100, 64, "noise"), ("rev", 64, 32, "noise"),
    ("fwd", 16, 16, "sine"), ("fwd", 512, 64, "sine"),
    # spike windows (CLI fuzz seed 168): [0]*189+[v] — whether the fit
    # keeps a bare +/-3/16 coefficient or degenerates to the zero filter
    # depends on the f32 rounding DIRECTION of v*v in values_rms, so the
    # rms products must round through the data type exactly like the C
    ("fwd", 190, 190, "spike:0.98969173"),
    ("fwd", 190, 190, "spike:-0.04588555"),
    ("fwd", 190, 190, "spike:0.7071067"),
    ("rev", 190, 64, "spike:0.98969173"),
]


def _signal(nvalues, sig, freq=0.05):
    if sig == "sine":
        i = np.arange(nvalues)
        return (0.4 * np.sin(i * freq)
                + 0.1 * np.sin(i * freq * 3.1)).astype(np.float32)
    if sig.startswith("spike"):
        x = np.zeros(nvalues, np.float32)
        x[-1] = np.float32(float(sig.split(":")[1]))
        return x
    return NoiseLCG().fill(nvalues)


@pytest.mark.parametrize("mode,nvalues,nx,sig", CASES)
def test_extrapolation_bit_exact(golden_bin, mode, nvalues, nx, sig):
    kind, _, param = sig.partition(":")
    raw = subprocess.run(
        [str(golden_bin), "extrap", mode, str(nvalues), str(nx), kind,
         param or "0.05"], capture_output=True, check=True).stdout
    ref = np.frombuffer(raw, dtype=np.float32)
    x = _signal(nvalues, sig)
    mine = (ex.extrapolate_forward(x, nx) if mode == "fwd"
            else ex.extrapolate_reverse(x, nx))
    np.testing.assert_array_equal(mine, ref)


def test_silence_returns_zero_filter():
    coeffs, quality = ex.calc_lpc_coeffs(np.zeros(64, np.float32))
    np.testing.assert_array_equal(coeffs, np.zeros(4, np.float32))
    assert quality == 20.0


def test_quality_bounds():
    x = _signal(128, "sine")
    _, q = ex.calc_lpc_coeffs(x)
    assert 0.0 <= q <= 20.0


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_native_matches_host_bitexact(dt):
    """The native-runtime descent (art_extrapolate_*) is bit-identical to
    the numpy host path on every signal class, including the signed-zero
    prediction tail on silence (the strict cumsum seeds from element 0)."""
    from art_jax import native
    if not native.available():
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(5)
    sigs = [
        rng.standard_normal(317),
        np.cumsum(rng.standard_normal(190)) * 0.3,
        np.sin(np.arange(600) * 0.002),          # near-unstable slow sine
        np.zeros(97),
        np.full(64, 0.7),
        rng.standard_normal(3),                  # shorter than NCOEFFS
    ]
    for v in sigs:
        v = v.astype(dt)
        nx = 64
        a = ex.extrapolate_forward_host(v, nx)
        b = native.extrapolate(v, nx, ex.MAXLOOPS)
        assert a.tobytes() == b.tobytes()


def test_native_fit_matches_host():
    from art_jax import native
    if not native.available():
        pytest.skip("native runtime unavailable")
    x = _signal(256, "sine")
    c_host, q_host = ex.calc_lpc_coeffs(x)
    c_nat, q_nat = native.extrap_fit(x, ex.MAXLOOPS)
    np.testing.assert_array_equal(c_host, c_nat)
    assert q_host == q_nat
