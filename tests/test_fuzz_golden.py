"""Randomized golden sweeps against the C reference.

Seeded fuzzing over (taps, filters, channels, rates/ratios, block sizes,
advances, flags), asserting the same contract as the targeted goldens:
exact counts and phase position, f32-floor sample agreement.  Also exercises
the output-limited partial-consumption path (tiny output buffers), which the
targeted tests never hit.
"""

import subprocess

import numpy as np
import pytest

from art_jax.core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                                INCLUDE_LOWPASS, NO_FILTER_REDUCTION,
                                SUBSAMPLE_INTERPOLATE)
from art_jax.engines.resampler import Resampler
from art_jax.utils.testsig import NoiseLCG

from helpers import compare_stream

RATE_PAIRS = [(44100, 48000), (48000, 44100), (96000, 44100), (8000, 32000),
              (22050, 24000), (44100, 44101)]


@pytest.mark.parametrize("seed", list(range(12)) + [500, 507, 513])
def test_fuzz_decimator_bit_exact(golden_bin, seed):
    from art_jax.core.flags import (DITHER_FLAT, DITHER_HIGHPASS,
                                    DITHER_LOWPASS, SHAPING_1ST_ORDER,
                                    SHAPING_2ND_ORDER, SHAPING_3RD_ORDER,
                                    SHAPING_ATH_CURVE)
    from art_jax.engines.decimator import Decimator
    rng = np.random.default_rng(2000 + seed)
    chans = int(rng.integers(1, 9))
    bits = int(rng.integers(4, 25))
    nbytes = (bits + 7) // 8 + (1 if rng.random() < 0.2 else 0)
    gain = float(rng.uniform(0.5, 2.0))
    rate = [32000, 44100, 48000, 88200, 96000, 37800][
        int(rng.integers(0, 6))]
    dither = [0, DITHER_HIGHPASS, DITHER_FLAT, DITHER_LOWPASS][
        int(rng.integers(0, 4))]
    shaping = [0, SHAPING_1ST_ORDER, SHAPING_2ND_ORDER, SHAPING_3RD_ORDER,
               SHAPING_ATH_CURVE][int(rng.integers(0, 5))]
    flags = dither | shaping
    n, nblocks = int(rng.integers(100, 1500)), int(rng.integers(1, 4))

    raw = subprocess.run(
        [str(golden_bin), "decimate", str(chans), str(bits), str(nbytes),
         repr(gain), str(rate), format(flags, "x"), str(n), str(nblocks)],
        capture_output=True, check=True).stdout
    total = n * chans * nbytes * nblocks
    ref = np.frombuffer(raw, dtype=np.uint8, count=total)
    ref_clip = int(np.frombuffer(raw, dtype=np.uint32, count=1,
                                 offset=total)[0])
    backend = ["numpy", "native", "jax"][seed % 3]
    d = Decimator(chans, bits, nbytes, gain, rate, flags, backend=backend)
    lcg = NoiseLCG()
    mine, clip = [], 0
    for _ in range(nblocks):
        x = lcg.fill(n * chans).reshape(n, chans)
        pb, c = d.process_interleaved(x)
        mine.append(pb.reshape(-1))
        clip += c
    np.testing.assert_array_equal(np.concatenate(mine), ref)
    assert clip == ref_clip


@pytest.mark.parametrize("seed", list(range(32)) + [700, 708, 715])
def test_fuzz_stream_parity(golden_bin, seed):
    rng = np.random.default_rng(1000 + seed)
    taps = int(rng.integers(1, 40)) * 4
    filters = int(rng.integers(1, 200))
    chans = int(rng.integers(1, 5))
    mode = int(rng.integers(0, 2))
    flags = BLACKMAN_HARRIS if rng.random() < 0.7 else 0
    if rng.random() < 0.8:
        flags |= SUBSAMPLE_INTERPOLATE
    if rng.random() < 0.3:
        flags |= NO_FILTER_REDUCTION
    if rng.random() < 0.3:
        flags |= EXTRAPOLATE_ENDPOINTS
    block = int(rng.integers(64, 3000))
    nblocks = int(rng.integers(2, 5))
    if mode:
        src, dst = RATE_PAIRS[int(rng.integers(0, len(RATE_PAIRS)))]
        lowpass, ratio = 0, dst / src
        flags |= INCLUDE_LOWPASS
    else:
        src = dst = 1
        ratio = float(rng.uniform(0.3, 3.0))
        lowpass = float(rng.uniform(0.3, 0.95)) if rng.random() < 0.5 else 0.0
    advance = float(rng.integers(0, taps))
    if flags & SUBSAMPLE_INTERPOLATE and rng.random() < 0.5:
        # fractional advance is only legal when the final config keeps
        # interpolation (a successful fixed-ratio reduction disables it)
        from art_jax.core.filters import plan_fixed_ratio
        keeps_interp = (mode == 0) or bool(
            plan_fixed_ratio(taps, filters, src, dst, lowpass, flags).flags
            & SUBSAMPLE_INTERPOLATE)
        if keeps_interp:
            advance += 0.25

    # extrapolated endpoint samples can overshoot the noise amplitude, so
    # the reference's float32 convolution noise is larger in the prefill
    # region; scale the tolerance accordingly (still ~10 float32 ulps)
    atol = 8e-7 if flags & EXTRAPOLATE_ENDPOINTS else 2e-7
    compare_stream(golden_bin, chans=chans, taps=taps, filters=filters,
                   flags=flags, mode=mode, src=src, dst=dst,
                   lowpass=lowpass, ratio=ratio, block=block,
                   nblocks=nblocks, advance=advance, atol=atol)


@pytest.mark.parametrize("outcap,block", [(37, 700), (128, 1000), (5, 260)])
def test_output_limited_partial_consumption(golden_bin, outcap, block):
    """Tiny output buffers force the reference to consume input partially
    (the break at resampler.c:512-513); counts and values must track."""
    chans, taps, filters = 2, 48, 48
    flags = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
    nblocks = 3
    args = [str(golden_bin), "resample_small", str(chans), str(taps),
            str(filters), format(flags, "x"), "1", "44100", "48000", "0",
            repr(48000 / 44100), str(block), str(nblocks), "24.0",
            str(outcap)]
    raw = subprocess.run(args, capture_output=True, check=True).stdout

    r = Resampler.fixed_ratio(chans, taps, filters, 44100, 48000, 0, flags)
    r.advance_position(24.0)
    lcg = NoiseLCG()
    off = 0
    maxdiff = 0.0
    for b in range(nblocks):
        data = lcg.fill(block * chans).reshape(block, chans)
        avail = data
        while avail.shape[0] > 0:
            iu, og = np.frombuffer(raw, dtype=np.uint32, count=2, offset=off)
            off += 8
            ref = np.frombuffer(raw, dtype=np.float32, count=int(og) * chans,
                                offset=off).reshape(int(og), chans)
            off += int(og) * chans * 4
            out, res = r.process_interleaved(avail, avail.shape[0], outcap,
                                             0.0)
            assert (res.input_used, res.output_generated) == \
                (int(iu), int(og))
            if og:
                maxdiff = max(maxdiff, float(np.abs(out - ref).max()))
            avail = avail[res.input_used:]
            if not res.input_used and not res.output_generated:
                break
    ref_pos = float(np.frombuffer(raw, dtype=np.float64, count=1,
                                  offset=off)[0])
    assert r.get_position() == ref_pos
    assert maxdiff < 2e-7


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_stretch_bit_exact(seed, tmp_path):
    """Randomized tempo-only conversions (mono/stereo, tonal + noise mixes,
    tempi across the single and dual-cascade ranges) must be byte-identical
    to the reference `art` binary (reference stretch.c:161-326)."""
    import math
    import shutil
    from pathlib import Path

    from art_jax.io import wavfile

    art_bin = Path("/tmp/art_golden/art_ref")
    ref = Path("/root/reference")
    if not art_bin.exists():
        if not ref.exists() or not shutil.which("gcc"):
            pytest.skip("reference art not buildable")
        srcs = [ref / c for c in ["art.c", "stretch.c", "resampler.c",
                                  "extrapolator.c", "decimator.c",
                                  "workers.c", "biquad.c"]]
        art_bin.parent.mkdir(exist_ok=True)
        subprocess.run(["gcc", "-O2", "-ffp-contract=off",
                        "-DENABLE_THREADS", "-DENABLE_EXTRAPOLATION",
                        f"-I{ref}", *map(str, srcs), "-lm", "-pthread",
                        "-o", str(art_bin)], check=True, capture_output=True)

    rng = np.random.default_rng(3000 + seed)
    ch = int(rng.integers(1, 3))
    rate = [16000, 32000, 44100, 48000][int(rng.integers(0, 4))]
    n = int(rng.integers(rate // 2, rate))          # 0.5 - 1 s
    tempo = float(rng.uniform(0.25, 4.0))
    # tonal content provokes the period-search tie cases
    t = np.arange(n) / rate
    f0 = float(rng.uniform(60, 900))
    sig = 0.5 * np.sin(2 * math.pi * f0 * t)
    sig = sig[:, None] + 0.2 * rng.standard_normal((n, ch))
    ints = np.clip(np.round(sig * 16384.0), -32768, 32767).astype("<i2")

    wav_in = tmp_path / "in.wav"
    with open(wav_in, "wb") as f:
        wavfile.write_wav_header(f, bits=16, num_channels=ch, num_frames=n,
                                 sample_rate=rate,
                                 channel_mask=3 if ch == 2 else 4)
        f.write(ints.tobytes())

    ref_out = tmp_path / "ref.wav"
    my_out = tmp_path / "mine.wav"
    r = subprocess.run([str(art_bin), f"--tempo={tempo!r}", "-y", "-q",
                        str(wav_in), str(ref_out)], capture_output=True)
    assert r.returncode == 0, r.stderr.decode()
    from art_jax.cli import art as art_cli
    rc = art_cli.main([f"--tempo={tempo!r}", "-y", "-q", str(wav_in),
                       str(my_out)])
    assert not rc
    assert ref_out.read_bytes() == my_out.read_bytes(), \
        (ch, rate, n, tempo, f0)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_biquad_bit_exact(golden_bin, seed):
    """Random cutoff/length cascaded biquads, bit-exact vs the reference
    (reference biquad.c:106-163)."""
    from art_jax.engines.biquad import (Biquad, biquad_highpass,
                                        biquad_lowpass)
    rng = np.random.default_rng(4000 + seed)
    mode = "highpass" if rng.random() < 0.5 else "lowpass"
    freq = float(rng.uniform(0.01, 0.49))
    n = int(rng.integers(16, 5000))
    raw = subprocess.run([str(golden_bin), "biquad", mode, repr(freq),
                          str(n)], capture_output=True, check=True).stdout
    ref = np.frombuffer(raw, dtype=np.float32, count=n)

    coeffs = (biquad_highpass if mode == "highpass" else biquad_lowpass)(freq)
    buf = NoiseLCG().fill(n).astype(np.float32)
    for _ in range(2):
        f = Biquad.init(coeffs, 1.0, channels=1, dtype=np.float32)
        buf = f.apply_buffer(buf)
    np.testing.assert_array_equal(buf, ref, err_msg=f"{mode} {freq} {n}")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_extrapolator_bit_exact(golden_bin, seed):
    """Random LPC endpoint extrapolations (direction, history length,
    extrapolation length, signal class), bit-exact vs the reference
    coordinate descent (reference extrapolator.c:85-230)."""
    from art_jax.engines.extrapolator import (extrapolate_forward,
                                              extrapolate_reverse)
    rng = np.random.default_rng(5000 + seed)
    mode = "rev" if rng.random() < 0.5 else "fwd"
    nvalues = int(rng.integers(8, 3000))
    nx = int(rng.integers(1, 400))
    signal = "sine" if rng.random() < 0.5 else "noise"
    freq = float(rng.uniform(0.005, 0.8))
    raw = subprocess.run([str(golden_bin), "extrap", mode, str(nvalues),
                          str(nx), signal, repr(freq)],
                         capture_output=True, check=True).stdout
    ref = np.frombuffer(raw, dtype=np.float32, count=nx)

    if signal == "sine":
        i = np.arange(nvalues, dtype=np.float64)
        buf = (0.4 * np.sin(i * freq) + 0.1 * np.sin(i * freq * 3.1)
               ).astype(np.float32)
    else:
        buf = NoiseLCG().fill(nvalues).astype(np.float32)
    if mode == "rev":
        mine = extrapolate_reverse(buf, nx)
    else:
        mine = extrapolate_forward(buf, nx)
    np.testing.assert_array_equal(mine, ref,
                                  err_msg=f"{mode} {nvalues} {nx} {signal}")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_stream_parity_f64(golden_bin64, seed):
    """f64 data-path (ART64) randomized stream parity — exact counts and
    position, samples at the f64 floor."""
    rng = np.random.default_rng(6000 + seed)
    taps = int(rng.integers(1, 30)) * 4
    filters = int(rng.integers(1, 150))
    chans = int(rng.integers(1, 4))
    mode = int(rng.integers(0, 2))
    flags = BLACKMAN_HARRIS | SUBSAMPLE_INTERPOLATE
    if rng.random() < 0.3:
        flags |= EXTRAPOLATE_ENDPOINTS
    block = int(rng.integers(64, 2000))
    nblocks = int(rng.integers(2, 4))
    if mode:
        src, dst = RATE_PAIRS[int(rng.integers(0, len(RATE_PAIRS)))]
        lowpass, ratio = 0, dst / src
        flags |= INCLUDE_LOWPASS
    else:
        src = dst = 1
        ratio = float(rng.uniform(0.4, 2.5))
        lowpass = 0.0
    advance = float(rng.integers(0, taps))

    atol = 8e-12 if flags & EXTRAPOLATE_ENDPOINTS else 1e-12
    compare_stream(golden_bin64, chans=chans, taps=taps, filters=filters,
                   flags=flags, mode=mode, src=src, dst=dst,
                   lowpass=lowpass, ratio=ratio, block=block,
                   nblocks=nblocks, advance=advance, atol=atol,
                   dtype=np.float64)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_checkpoint_resume(seed):
    """Checkpoint/resume: saving state_dict at a random mid-stream point and
    resuming in a fresh engine must reproduce the unsplit stream bit-exactly
    (resampler AND decimator)."""
    from art_jax.core.flags import (DITHER_HIGHPASS, SHAPING_ATH_CURVE)
    from art_jax.engines.decimator import Decimator

    rng = np.random.default_rng(7000 + seed)
    taps = int(rng.integers(2, 20)) * 4
    filters = int(rng.integers(4, 200))
    chans = int(rng.integers(1, 4))
    flags = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
    n = int(rng.integers(2000, 12000))
    cut = int(rng.integers(1, n - 1))
    x = (rng.standard_normal((chans, n)) * 0.4).astype(np.float32)

    a = Resampler.fixed_ratio(chans, taps, filters, 44100, 48000, 0, flags)
    out_full, res = a.process(x, n, 3 * n, 0.0)

    b = Resampler.fixed_ratio(chans, taps, filters, 44100, 48000, 0, flags)
    o1, r1 = b.process(x[:, :cut], cut, 3 * n, 0.0)
    state = b.state_dict()
    c = Resampler.fixed_ratio(chans, taps, filters, 44100, 48000, 0, flags)
    c.load_state(state)
    o2, r2 = c.process(x[:, cut:], n - cut, 3 * n, 0.0)
    got = np.concatenate([o1[:, :r1.output_generated],
                          o2[:, :r2.output_generated]], axis=1)
    assert r1.output_generated + r2.output_generated == res.output_generated
    # the phase accumulator regroups float64 sums per call, so positions
    # (and thus interpolation fractions) agree only to f64 accumulation
    # noise across different call patterns — exactly like calling the C
    # API with different block sizes; counts stay exact
    np.testing.assert_allclose(got, out_full[:, :res.output_generated],
                               atol=1e-9)
    assert abs(c.get_position() - a.get_position()) < 1e-9

    # decimator: bytes across a state_dict/load split must be identical
    bits = int(rng.integers(8, 25))
    d1 = Decimator(chans, bits, (bits + 7) // 8, 1.0, 44100,
                   DITHER_HIGHPASS | SHAPING_ATH_CURVE, backend="numpy")
    full, _ = d1.process(x)
    d2 = Decimator(chans, bits, (bits + 7) // 8, 1.0, 44100,
                   DITHER_HIGHPASS | SHAPING_ATH_CURVE, backend="numpy")
    p1, _ = d2.process(x[:, :cut])
    st = d2.state_dict()
    d3 = Decimator(chans, bits, (bits + 7) // 8, 1.0, 44100,
                   DITHER_HIGHPASS | SHAPING_ATH_CURVE, backend="numpy")
    d3.load_state(st)
    p2, _ = d3.process(x[:, cut:])
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(p1).reshape(-1),
                        np.asarray(p2).reshape(-1)]),
        np.asarray(full).reshape(-1))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_decimator_f64_bit_exact(golden_bin64, seed):
    """Randomized float64 data-path decimation, bit-exact vs the strict
    ART64 reference build across all three backends."""
    from art_jax.core.flags import (DITHER_FLAT, DITHER_HIGHPASS,
                                    DITHER_LOWPASS, SHAPING_1ST_ORDER,
                                    SHAPING_2ND_ORDER, SHAPING_3RD_ORDER,
                                    SHAPING_ATH_CURVE)
    from art_jax.engines.decimator import Decimator
    rng = np.random.default_rng(8000 + seed)
    chans = int(rng.integers(1, 9))
    bits = int(rng.integers(4, 25))
    nbytes = (bits + 7) // 8 + (1 if rng.random() < 0.2 else 0)
    gain = float(rng.uniform(0.5, 2.0))
    rate = [32000, 44100, 48000, 88200, 96000, 37800][
        int(rng.integers(0, 6))]
    dither = [0, DITHER_HIGHPASS, DITHER_FLAT, DITHER_LOWPASS][
        int(rng.integers(0, 4))]
    shaping = [0, SHAPING_1ST_ORDER, SHAPING_2ND_ORDER, SHAPING_3RD_ORDER,
               SHAPING_ATH_CURVE][int(rng.integers(0, 5))]
    flags = dither | shaping
    n, nblocks = int(rng.integers(100, 1200)), int(rng.integers(1, 4))
    raw = subprocess.run(
        [str(golden_bin64), "decimate", str(chans), str(bits), str(nbytes),
         repr(gain), str(rate), format(flags, "x"), str(n), str(nblocks)],
        capture_output=True, check=True).stdout
    total = n * chans * nbytes * nblocks
    ref = np.frombuffer(raw, dtype=np.uint8, count=total)
    ref_clip = int(np.frombuffer(raw, dtype=np.uint32, count=1,
                                 offset=total)[0])
    backend = ["numpy", "native", "jax"][seed % 3]
    d = Decimator(chans, bits, nbytes, gain, rate, flags, backend=backend,
                  dtype=np.float64)
    lcg = NoiseLCG()
    mine, clip = [], 0
    for _ in range(nblocks):
        x = lcg.fill(n * chans, np.float64).reshape(n, chans)
        pb, c = d.process_interleaved(x)
        mine.append(pb.reshape(-1))
        clip += c
    np.testing.assert_array_equal(np.concatenate(mine), ref)
    assert clip == ref_clip
