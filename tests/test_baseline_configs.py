"""End-to-end coverage of the five BASELINE.json configs."""

import io
import subprocess
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest

from art_jax.io import wavfile
from art_jax.utils.testsig import NoiseLCG

REF = Path("/root/reference")


@pytest.fixture(scope="session")
def art64_ref():
    if not REF.exists():
        pytest.skip("reference unavailable")
    out = Path("/tmp/art_golden/art64_ref")
    if not out.exists():
        out.parent.mkdir(exist_ok=True)
        srcs = [REF / s for s in ["art.c", "stretch.c", "resampler.c",
                                  "extrapolator.c", "decimator.c",
                                  "workers.c", "biquad.c"]]
        subprocess.run(["gcc", "-DPATH_WIDTH=64", "-O2", "-ffp-contract=off",
                        "-DENABLE_THREADS", "-DENABLE_EXTRAPOLATION",
                        f"-I{REF}", *map(str, srcs), "-lm", "-pthread",
                        "-o", str(out)], check=True, capture_output=True)
    return out


def _write_wav(path, frames, bits, rate, mask=None):
    n, ch = frames.shape
    ints = np.clip(np.round(frames.astype(np.float64) * (1 << (bits - 1))),
                   -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    with open(path, "wb") as f:
        wavfile.write_wav_header(
            f, bits=bits, num_channels=ch, num_frames=n, sample_rate=rate,
            channel_mask=mask if mask is not None else 0x5 - ch
            if ch <= 2 else (1 << ch) - 1)
        f.write(ints.astype("<i2").tobytes())


def _artest(args):
    from art_jax.cli import artest as at
    buf = io.StringIO()
    with redirect_stderr(buf):
        at.main(args)
    return buf.getvalue()


def test_config1_mono_preset1_nearest():
    """mono 44.1k->48k preset -1 nearest-filter no lowpass."""
    out = _artest(["-1", "-s44.1k", "-d48k", "-c1", "-n2", "-e", "-i"])
    line = next(l for l in out.splitlines() if "diff (-w5)" in l)
    rms = float(line.split("RMS =")[1].split("dB")[0])
    assert rms < -40.0   # preset -1 fidelity class (C measures ~ -46 dB)


def test_config2_stereo_upsample_96k():
    out = _artest(["-3", "-s44.1k", "-d96k", "-c2", "-n2", "-e", "-i"])
    line = next(l for l in out.splitlines() if "diff (-w5)" in l)
    rms = float(line.split("RMS =")[1].split("dB")[0])
    assert rms < -115.0


def test_config3_downsample_decimate_16bit():
    out = _artest(["-2", "-s96k", "-d44.1k", "-c2", "-n2", "-e", "-o16"])
    assert "decimate (-w3)" in out
    line = next(l for l in out.splitlines() if "decimate (-w3)" in l)
    assert "clipped samples" in line


def test_config4_5_1ch_art64_biquad(art64_ref, tmp_path):
    """5.1-channel 48k->44.1k with -p cascaded biquads on the 64-bit path,
    against the reference ART64 build."""
    n = 24000
    x = NoiseLCG().fill(n * 6).reshape(n, 6)
    wav_in = tmp_path / "in.wav"
    _write_wav(wav_in, x, 16, 48000, mask=0x3F)
    ref_out = tmp_path / "ref.wav"
    my_out = tmp_path / "mine.wav"
    subprocess.run([str(art64_ref), "-r44.1k", "-p", "-y", "-q",
                    str(wav_in), str(ref_out)], check=True,
                   capture_output=True)
    from art_jax.cli import art as artcli
    rc = artcli.main(["--f64", "-r44.1k", "-p", "-y", "-q", str(wav_in),
                      str(my_out)])
    assert rc == 0
    with open(ref_out, "rb") as f:
        ia = wavfile.read_wav_header(f)
        da = f.read(ia.num_frames * 12)
    with open(my_out, "rb") as f:
        ib = wavfile.read_wav_header(f)
        db = f.read(ib.num_frames * 12)
    assert ia.num_frames == ib.num_frames
    assert ia.channel_mask == ib.channel_mask == 0x3F
    # the full float64 chain (resampler + cascaded biquads + ATH-shaped
    # dithered decimation) reproduces the ART64 reference bit-for-bit
    np.testing.assert_array_equal(np.frombuffer(da, "<i2"),
                                  np.frombuffer(db, "<i2"))


def test_config5_batched_asrc_drifting():
    """256 concurrent streams, drifting ratio ~1.0, exact phase query."""
    import jax.numpy as jnp
    from art_jax.parallel.asrc import BatchedASRC
    S = 256
    b = BatchedASRC(S, 48, 64)
    b.advance_position(24.0)
    rng = np.random.default_rng(1)
    lcg = NoiseLCG()
    drift = np.zeros(S)
    for step in range(4):
        ratios = 1.0 + 0.002 * np.sin(0.1 * step + np.arange(S))
        x = lcg.fill(S * 256).reshape(S, 256)
        out, Ks = b.process(jnp.asarray(x), ratios)
        drift += Ks / ratios - 256
    pos = b.get_position()
    # position must equal the analytic phase recurrence per stream
    np.testing.assert_allclose(pos, 24.0 + drift, atol=1e-9)
