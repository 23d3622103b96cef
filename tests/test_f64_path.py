"""64-bit data path (the reference's ART64 build) coverage."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from art_jax.core.flags import (BLACKMAN_HARRIS, DITHER_HIGHPASS,
                                INCLUDE_LOWPASS, SHAPING_ATH_CURVE,
                                SUBSAMPLE_INTERPOLATE)
from art_jax.engines.decimator import Decimator
from art_jax.utils.testsig import NoiseLCG

IBL = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_decimator_f64_bit_exact(golden_bin64, backend):
    flags = DITHER_HIGHPASS | SHAPING_ATH_CURVE
    n, chans, nblocks = 800, 2, 2
    raw = subprocess.run(
        [str(golden_bin64), "decimate", str(chans), "16", "2", "1.0",
         "44100", format(flags, "x"), str(n), str(nblocks)],
        capture_output=True, check=True).stdout
    nbytes = n * chans * 2 * nblocks
    ref = np.frombuffer(raw, dtype=np.uint8, count=nbytes)
    ref_clip = int(np.frombuffer(raw, dtype=np.uint32, count=1,
                                 offset=nbytes)[0])

    d = Decimator(chans, 16, 2, 1.0, 44100, flags, dtype=np.float64,
                  backend=backend)
    lcg = NoiseLCG()
    mine, clip = [], 0
    for _ in range(nblocks):
        x = lcg.fill(n * chans, np.float64).reshape(n, chans)
        pb, c = d.process_interleaved(x)
        mine.append(pb.reshape(-1))
        clip += c
    np.testing.assert_array_equal(np.concatenate(mine), ref)
    assert clip == ref_clip


def test_art_cli_f64_output(tmp_path):
    """--f64 writes a valid 64-bit float WAV readable back."""
    from art_jax.cli import art as artcli
    from art_jax.io import wavfile
    n = 8000
    x = NoiseLCG().fill(n * 2).reshape(n, 2)
    ints = np.clip(np.round(x.astype(np.float64) * 32768.0),
                   -32768, 32767).astype("<i2")
    wav_in = tmp_path / "in.wav"
    with open(wav_in, "wb") as f:
        wavfile.write_wav_header(f, bits=16, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=3)
        f.write(ints.tobytes())
    wav_out = tmp_path / "out.wav"
    rc = artcli.main(["--f64", "-o64", "-r48k", "-q", "-y", str(wav_in),
                      str(wav_out)])
    assert rc == 0
    with open(wav_out, "rb") as f:
        info = wavfile.read_wav_header(f)
        assert info.bits_per_sample == 64 and info.is_float
        data = np.frombuffer(f.read(info.num_frames * 16), "<f8")
    assert np.isfinite(data).all() and np.abs(data).max() < 2.0
    assert abs(info.num_frames - round(n * 48000 / 44100)) <= 1
