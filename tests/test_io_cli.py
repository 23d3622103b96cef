"""WAV container, native runtime, stretch, and CLI end-to-end tests."""

import io
import math
import subprocess
from pathlib import Path

import numpy as np
import pytest

from art_jax.io import wavfile
from art_jax.utils.testsig import NoiseLCG

REF = Path("/root/reference")


@pytest.fixture(scope="session")
def art_ref(tmp_path_factory):
    """Reference `art` binary built strict-IEEE out-of-tree."""
    if not REF.exists():
        pytest.skip("reference unavailable")
    out = Path("/tmp/art_golden/art_ref")
    if not out.exists():
        srcs = [REF / s for s in ["art.c", "stretch.c", "resampler.c",
                                  "extrapolator.c", "decimator.c",
                                  "workers.c", "biquad.c"]]
        out.parent.mkdir(exist_ok=True)
        subprocess.run(["gcc", "-O2", "-ffp-contract=off",
                        "-DENABLE_THREADS", "-DENABLE_EXTRAPOLATION",
                        f"-I{REF}", *map(str, srcs), "-lm", "-pthread",
                        "-o", str(out)], check=True, capture_output=True)
    return out


@pytest.fixture()
def test_wav(tmp_path):
    n = 44100
    x = NoiseLCG().fill(n * 2).reshape(n, 2)
    ints = np.clip(np.round(x.astype(np.float64) * 32768.0),
                   -32768, 32767).astype("<i2")
    p = tmp_path / "in.wav"
    with open(p, "wb") as f:
        wavfile.write_wav_header(f, bits=16, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=3)
        f.write(ints.tobytes())
    return p, ints


# ------------------------------------------------------------------ wavfile
def test_wav_header_roundtrip():
    for bits, ch, mask in [(16, 2, 3), (24, 6, 0x3F), (32, 1, 4), (8, 3, 7)]:
        buf = io.BytesIO()
        wavfile.write_wav_header(buf, bits=bits, num_channels=ch,
                                 num_frames=1000, sample_rate=48000,
                                 channel_mask=mask)
        buf.write(b"\x00" * (1000 * ch * ((bits + 7) // 8)))
        buf.seek(0)
        info = wavfile.read_wav_header(buf)
        assert (info.num_channels, info.sample_rate, info.bits_per_sample,
                info.num_frames) == (ch, 48000, bits, 1000)
        assert info.channel_mask == mask
        assert info.is_float == (bits >= 32)


def test_wav_rejects_garbage():
    with pytest.raises(wavfile.WavFormatError):
        wavfile.read_wav_header(io.BytesIO(b"RIFXxxxxWAVE"))
    with pytest.raises(wavfile.WavFormatError):
        wavfile.read_wav_header(io.BytesIO(b"RIFF\x00\x00\x00\x00WAVE"))


def test_wav_skips_unknown_chunks():
    buf = io.BytesIO()
    wavfile.write_wav_header(buf, bits=16, num_channels=1, num_frames=4,
                             sample_rate=8000, channel_mask=4)
    hdr = buf.getvalue()
    # splice a junk chunk between fmt and data
    data_at = hdr.index(b"data")
    junk = b"JUNK" + (7).to_bytes(4, "little") + b"1234567\x00"
    spliced = hdr[:data_at] + junk + hdr[data_at:] + b"\x00" * 8
    info = wavfile.read_wav_header(io.BytesIO(spliced))
    assert info.num_frames == 4


# ------------------------------------------------------------------- native
def test_native_runtime_available_and_bit_exact():
    from art_jax import native
    if not native.available():
        pytest.skip("no compiler for native runtime")
    from art_jax.core.flags import DITHER_HIGHPASS, SHAPING_ATH_CURVE
    from art_jax.engines.decimator import Decimator
    x = NoiseLCG().fill(4000).reshape(2000, 2)
    flags = DITHER_HIGHPASS | SHAPING_ATH_CURVE
    pn, cn = Decimator(2, 16, 2, 2.5, 44100, flags,
                       backend="numpy").process_interleaved(x)
    pv, cv = Decimator(2, 16, 2, 2.5, 44100, flags,
                       backend="native").process_interleaved(x)
    np.testing.assert_array_equal(pn, pv)
    assert cn == cv


def test_native_biquad_bit_exact():
    from art_jax import native
    if not native.available():
        pytest.skip("no compiler for native runtime")
    from art_jax.engines.biquad import Biquad, biquad_lowpass
    x = NoiseLCG().fill(3000).reshape(1500, 2)
    c = biquad_lowpass(0.3)
    f1, f2 = Biquad.init(c, 1.0, 2), Biquad.init(c, 1.0, 2)
    np.testing.assert_array_equal(f1.apply_buffer(x.copy()),
                                  f2.apply_buffer(x.copy(),
                                                  use_native=False))


# ------------------------------------------------------------------ stretch
def test_stretch_ratio_accuracy():
    from art_jax.engines.stretch import Stretcher
    x = NoiseLCG().fill(44100 * 2).reshape(-1, 2)
    for ratio in (0.5, 0.8, 1.25, 2.0):
        s = Stretcher(44100 // 350, 44100 // 50, 2, 0)
        out = s.process(x.reshape(-1), x.shape[0], ratio)
        out2 = s.flush()
        got = (out.size + out2.size) / x.size
        assert abs(got - ratio) < 0.06, (ratio, got)


def test_stretch_dual_extends_range():
    from art_jax.core.flags import STRETCH_DUAL_FLAG
    from art_jax.engines.stretch import Stretcher
    x = NoiseLCG().fill(44100).reshape(-1, 1)
    s = Stretcher(44100 // 350, 44100 // 50, 1, STRETCH_DUAL_FLAG)
    out = s.process(x.reshape(-1), x.shape[0], 3.0)
    total = out.size
    for _ in range(3):
        total += s.flush().size
    assert abs(total / x.size - 3.0) < 0.15


def test_stretch_unity_passthrough_exact():
    from art_jax.engines.stretch import Stretcher
    x = NoiseLCG().fill(20000).reshape(-1, 2)
    s = Stretcher(44100 // 350, 44100 // 50, 2, 0)
    out = s.process(x.reshape(-1), x.shape[0], 1.0)
    out2 = s.flush()
    full = np.concatenate([out, out2])
    np.testing.assert_array_equal(full, x.reshape(-1))


# ---------------------------------------------------------------------- CLI
def _run_art_cli(args):
    from art_jax.cli import art as artcli
    return artcli.main(args)


def _read_wav(path):
    with open(path, "rb") as f:
        info = wavfile.read_wav_header(f)
        data = f.read(info.num_frames * info.num_channels
                      * info.bytes_per_sample)
    return info, data


@pytest.mark.parametrize("args,max_db", [
    (["-3", "-r48k"], -70.0),
    (["-1", "-r48k"], -70.0),
    (["-2", "-r22.05k"], -70.0),
    (["-3", "-r48k", "-o32"], -140.0),
    (["-3", "-r48k", "-p"], -70.0),
])
def test_art_cli_matches_reference(art_ref, test_wav, tmp_path, args,
                                   max_db):
    wav_in, _ = test_wav
    ref_out = tmp_path / "ref.wav"
    my_out = tmp_path / "mine.wav"
    subprocess.run([str(art_ref), *args, "-y", "-q", str(wav_in),
                    str(ref_out)], check=True, capture_output=True)
    assert _run_art_cli([*args, "-y", "-q", str(wav_in), str(my_out)]) == 0
    ia, da = _read_wav(ref_out)
    ib, db = _read_wav(my_out)
    assert ia.num_frames == ib.num_frames
    if ia.bits_per_sample == 16:
        va = np.frombuffer(da, "<i2").astype(np.float64) / 32768
        vb = np.frombuffer(db, "<i2").astype(np.float64) / 32768
    else:
        va = np.frombuffer(da, "<f4").astype(np.float64)
        vb = np.frombuffer(db, "<f4").astype(np.float64)
    d = va - vb
    rms = math.sqrt(float((d ** 2).mean()))
    sig = math.sqrt(float((va ** 2).mean()))
    rel_db = 20 * math.log10(rms / sig) if rms > 0 else -999.0
    assert rel_db < max_db, rel_db


def test_art_cli_stretch_bit_identical(art_ref, test_wav, tmp_path):
    """Stretch-only paths (no resampler, no decimator randomness coupling)
    are bit-identical to the reference."""
    wav_in, _ = test_wav
    for args in (["--tempo=1.5"], ["--duration=0.7"]):
        ref_out = tmp_path / "ref.wav"
        my_out = tmp_path / "mine.wav"
        subprocess.run([str(art_ref), *args, "-y", "-q", str(wav_in),
                        str(ref_out)], check=True, capture_output=True)
        _run_art_cli([*args, "-y", "-q", str(wav_in), str(my_out)])
        assert ref_out.read_bytes() == my_out.read_bytes(), args


def test_art_cli_prefilter_with_stretch_matches_reference(art_ref, test_wav,
                                                          tmp_path):
    """-p combined with a stretcher: the reference filters a buffer the
    resampler never consumes, so output equals the unfiltered stretch —
    byte-identical here too."""
    wav_in, _ = test_wav
    ref_out = tmp_path / "ref.wav"
    my_out = tmp_path / "mine.wav"
    args = ["--tempo=1.5", "-p"]
    subprocess.run([str(art_ref), *args, "-y", "-q", str(wav_in),
                    str(ref_out)], check=True, capture_output=True)
    _run_art_cli([*args, "-y", "-q", str(wav_in), str(my_out)])
    assert ref_out.read_bytes() == my_out.read_bytes()


def test_art_cli_float_wav_input(art_ref, tmp_path):
    """32-bit float WAV input through the pipeline matches the reference."""
    n = 44100
    x = NoiseLCG().fill(n * 2).reshape(n, 2)
    wav_in = tmp_path / "in32.wav"
    with open(wav_in, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=3)
        f.write(x.astype("<f4").tobytes())
    ref_out = tmp_path / "ref.wav"
    my_out = tmp_path / "mine.wav"
    subprocess.run([str(art_ref), "-3", "-r48k", "-o32", "-y", "-q",
                    str(wav_in), str(ref_out)], check=True,
                   capture_output=True)
    _run_art_cli(["-3", "-r48k", "-o32", "-y", "-q", str(wav_in),
                  str(my_out)])
    ia, da = _read_wav(ref_out)
    ib, db = _read_wav(my_out)
    assert ia.num_frames == ib.num_frames
    va = np.frombuffer(da, "<f4")
    vb = np.frombuffer(db, "<f4")
    assert np.abs(va - vb).max() < 2e-7


def test_artest_cli_input_stats_bit_identical(art_ref):
    """ARTEST input-stream stats (count/checksum/range/RMS) must match the C
    binary exactly — the noise source and stats are bit-exact ports."""
    import io as _io
    from contextlib import redirect_stderr
    from art_jax.cli import artest as at
    artest_bin = Path("/tmp/refbuild/artest")
    if not artest_bin.exists():
        pytest.skip("reference artest not built")
    args = ["-3", "-s44.1k", "-d48k", "-c2", "-n5", "-e"]
    ref = subprocess.run([str(artest_bin), *args], capture_output=True,
                         text=True).stderr
    buf = _io.StringIO()
    with redirect_stderr(buf):
        at.main(args)
    ref_line = next(l for l in ref.splitlines() if "input (-w1)" in l)
    my_line = next(l for l in buf.getvalue().splitlines()
                   if "input (-w1)" in l)
    assert ref_line.strip() == my_line.strip()


def test_artest_planar_vs_interleaved_identical():
    """The -v equivalence oracle (reference artest.c:658-740): planar and
    interleaved paths must produce identical stats/checksums."""
    import io as _io
    from contextlib import redirect_stderr
    from art_jax.cli import artest as at

    def run(args):
        buf = _io.StringIO()
        with redirect_stderr(buf):
            at.main(args)
        return [l.strip() for l in buf.getvalue().splitlines()
                if "(-w" in l]

    base = ["-1", "-s44.1k", "-d48k", "-c2", "-n2", "-e", "-i", "-o16"]
    assert run(base) == run(base + ["-v"])


@pytest.mark.parametrize("args", [
    ["-3", "-s44.1k", "-d48k", "-c2", "-n3", "-e", "-h1k"],
    ["-3", "-s44.1k", "-d48k", "-c6", "-n2", "-e", "-h440"],
])
def test_artest_tone_input_bit_identical(art_ref, args):
    """Tone generator (accumulated phase, per-channel offsets, libm trig)
    matches the C harness bit-for-bit, including the fade windows."""
    import io as _io
    from contextlib import redirect_stderr
    from art_jax.cli import artest as at
    artest_bin = Path("/tmp/refbuild/artest")
    if not artest_bin.exists():
        pytest.skip("reference artest not built")
    ref = subprocess.run([str(artest_bin), *args], capture_output=True,
                         text=True).stderr
    buf = _io.StringIO()
    with redirect_stderr(buf):
        at.main(args)
    ref_line = next(l for l in ref.splitlines() if "input (-w1)" in l)
    my_line = next(l for l in buf.getvalue().splitlines()
                   if "input (-w1)" in l)
    assert ref_line.strip() == my_line.strip()


def test_art_cli_error_paths_match_reference(art_ref, tmp_path):
    """Malformed inputs: same exit classification and reference-style
    one-line message (no traceback) — reference art.c:521-571 behaviors."""
    import struct

    from art_jax.cli import art as art_cli

    cases = {}
    p = tmp_path / "notriff.wav"
    p.write_bytes(b"JUNKJUNKJUNKJUNK" * 4)
    cases[p] = "is not a valid .WAV file!"
    p = tmp_path / "badbits.wav"
    fmt = struct.pack("<HHIIHH", 1, 2, 44100, 44100 * 8, 8, 28)
    data = b"\x00" * 400
    p.write_bytes(b"RIFF" + struct.pack("<I", 20 + len(fmt) + len(data))
                  + b"WAVEfmt " + struct.pack("<I", len(fmt)) + fmt
                  + b"data" + struct.pack("<I", len(data)) + data)
    cases[p] = "is an unsupported .WAV format!"
    p = tmp_path / "nosamples.wav"
    fmt = struct.pack("<HHIIHH", 1, 2, 44100, 44100 * 4, 4, 16)
    p.write_bytes(b"RIFF" + struct.pack("<I", 20 + len(fmt))
                  + b"WAVEfmt " + struct.pack("<I", len(fmt)) + fmt
                  + b"data" + struct.pack("<I", 0))
    # a verbatim reference line WITHOUT the filename (art.c:608)
    cases[p] = "this .WAV file has no audio samples, probably is corrupt!"
    p = tmp_path / "misaligned.wav"
    data = b"\x00" * 401                 # not a multiple of block_align 4
    p.write_bytes(b"RIFF" + struct.pack("<I", 20 + len(fmt) + len(data))
                  + b"WAVEfmt " + struct.pack("<I", len(fmt)) + fmt
                  + b"data" + struct.pack("<I", len(data)) + data)
    cases[p] = "is not a valid .WAV file!"

    for path, expect in cases.items():
        ref = subprocess.run([str(art_ref), "-r48000", "-y", "-q", str(path),
                              str(tmp_path / "o1.wav")], capture_output=True,
                             text=True)
        assert ref.returncode != 0
        import io as _io
        from contextlib import redirect_stderr
        buf = _io.StringIO()
        with redirect_stderr(buf):
            rc = art_cli.main(["-r48000", "-y", "-q", str(path),
                               str(tmp_path / "o2.wav")])
        assert rc != 0
        assert expect in buf.getvalue()
        assert "Traceback" not in buf.getvalue()
        assert expect in ref.stderr

    # nonexistent input
    buf = _io.StringIO()
    with redirect_stderr(buf):
        rc = art_cli.main(["-y", "-q", str(tmp_path / "nope.wav"),
                           str(tmp_path / "o3.wav")])
    assert rc != 0 and "can't open file" in buf.getvalue()

    # stretch on >2 channels: message includes the channel count
    # (art.c:778)
    p = tmp_path / "three.wav"
    with open(p, "wb") as f:
        wavfile.write_wav_header(f, bits=16, num_channels=3, num_frames=64,
                                 sample_rate=44100, channel_mask=0x7)
        f.write(b"\x00" * (64 * 3 * 2))
    ref = subprocess.run([str(art_ref), "--tempo=2", "-y", "-q", str(p),
                          str(tmp_path / "o4.wav")], capture_output=True,
                         text=True)
    # in-process, sys.exit("msg") surfaces as SystemExit(str) — the
    # real CLI prints the string to stderr and exits 1
    with pytest.raises(SystemExit) as exc:
        art_cli.main(["--tempo=2", "-y", "-q", str(p),
                      str(tmp_path / "o5.wav")])
    expect = "error: audio stretch only works with mono or stereo, " \
             "not 3-channel"
    assert ref.returncode != 0 and expect in ref.stderr
    assert expect in str(exc.value)


def test_cli_device_pipeline_resample_decimate(tmp_path):
    """--backend=device runs resample AND decimate on device (only packed
    bytes fetched): counts + clip totals exactly match the numpy backend;
    samples agree to the documented f32-conv shaped-noise floor; and with
    no resample stage the bytes are identical."""
    import io as _io
    from contextlib import redirect_stderr

    import numpy as np

    from art_jax.cli import art
    from art_jax.io import wavfile

    rng = np.random.default_rng(5)
    n = 44100
    x = (rng.standard_normal((n, 2)) * 0.4).astype(np.float32)
    src = tmp_path / "in.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=0x3)
        f.write(x.astype("<f4").tobytes())

    def convert(be, args):
        dst = tmp_path / f"out_{be}_{len(args)}.wav"
        buf = _io.StringIO()
        with redirect_stderr(buf):
            rc = art.main(["-q", "-y", f"--backend={be}", *args,
                           str(src), str(dst)])
        assert not rc
        return dst.read_bytes(), buf.getvalue()

    # resample + decimate: counts/clips exact, samples at the shaped-noise
    # floor (the verify contract: judge counts + clip totals + noise level)
    an, wn = convert("numpy", ["-r48k", "-o16"])
    ad, wd = convert("device", ["-r48k", "-o16"])
    assert len(an) == len(ad)
    assert wn == wd                      # identical clip-count warnings
    da = np.frombuffer(an[-96000 * 4:], "<i2").astype(np.int32)
    db = np.frombuffer(ad[-96000 * 4:], "<i2").astype(np.int32)
    diff = np.abs(da - db)
    assert diff.max() <= 12 and diff.mean() < 2.0

    # decimate-only: decimator inputs are bit-identical -> identical bytes
    bn, _ = convert("numpy", ["-o16"])
    bd, _ = convert("device", ["-o16"])
    assert bn == bd

    # non-shaped modes route through the fused DeviceDecimator (shaped
    # modes stay host-side: the error-feedback scan is serial); inputs to
    # the decimator are bit-identical here, so bytes must match exactly
    cn, _ = convert("numpy", ["-o16", "-n0"])
    cd, _ = convert("device", ["-o16", "-n0"])
    assert cn == cd
    dn, swn = convert("numpy", ["-r48k", "-o16", "-n0", "-m"])
    dd, swd = convert("device", ["-r48k", "-o16", "-n0", "-m"])
    assert len(dn) == len(dd) and swn == swd


def test_cli_f64_device_backend_byte_identical(tmp_path):
    """--f64 --backend=device: the float64 device data path (~1e-15 vs
    host) quantizes to byte-identical output."""
    import io as _io
    from contextlib import redirect_stderr

    import numpy as np

    from art_jax.cli import art
    from art_jax.io import wavfile

    rng = np.random.default_rng(11)
    n = 44100
    x = (rng.standard_normal((n, 2)) * 0.4).astype(np.float32)
    src = tmp_path / "in.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=0x3)
        f.write(x.astype("<f4").tobytes())
    outs = []
    for be in ("numpy", "device"):
        dst = tmp_path / f"o_{be}.wav"
        with redirect_stderr(_io.StringIO()):
            rc = art.main(["-q", "-y", "--f64", f"--backend={be}", "-r48k",
                           "-o16", str(src), str(dst)])
        assert not rc
        outs.append(dst.read_bytes())
    assert outs[0] == outs[1]


def test_cli_device_post_filter_stays_on_device(tmp_path):
    """-p with --backend=device on an upsampling conversion: the post
    filter runs as the device associative-scan cascade between the device
    resample and decimate stages (the conversion no longer falls off the
    device pipeline).  Counts and clip warnings match the numpy backend
    exactly; 16-bit codes at the documented f32 resample+filter floor.
    Downsampling (-p pre-filter) keeps the device decimate stage too."""
    import io as _io
    from contextlib import redirect_stderr

    import numpy as np

    from art_jax.cli import art
    from art_jax.io import wavfile

    rng = np.random.default_rng(9)
    n = 44100
    x = (rng.standard_normal((n, 2)) * 0.4).astype(np.float32)
    src = tmp_path / "in.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=0x3)
        f.write(x.astype("<f4").tobytes())

    def convert(be, args):
        dst = tmp_path / f"out_{be}_{''.join(args)}.wav".replace("/", "")
        buf = _io.StringIO()
        with redirect_stderr(buf):
            rc = art.main(["-q", "-y", f"--backend={be}", *args,
                           str(src), str(dst)])
        assert not rc
        return dst.read_bytes(), buf.getvalue()

    # upsample + -p (post filter) + 16-bit unshaped: device pipeline end
    # to end (resample -> biquad cascade -> decimate all device-resident)
    an, wn = convert("numpy", ["-r48k", "-o16", "-n0", "-p"])
    ad, wd = convert("device", ["-r48k", "-o16", "-n0", "-p"])
    assert len(an) == len(ad)
    assert wn == wd
    da = np.frombuffer(an[-96000 * 4:], "<i2").astype(np.int32)
    db = np.frombuffer(ad[-96000 * 4:], "<i2").astype(np.int32)
    diff = np.abs(da - db)
    assert diff.max() <= 12 and diff.mean() < 2.0

    # downsample + -p (pre filter): host pre-filter feeds the device
    # resample+decimate; parity bar identical
    bn, _ = convert("numpy", ["-r22050", "-o16", "-n0", "-p"])
    bd, _ = convert("device", ["-r22050", "-o16", "-n0", "-p"])
    assert len(bn) == len(bd)
    ca = np.frombuffer(bn[-44100:], "<i2").astype(np.int32)
    cb = np.frombuffer(bd[-44100:], "<i2").astype(np.int32)
    diff2 = np.abs(ca - cb)
    assert diff2.max() <= 12 and diff2.mean() < 2.0


@pytest.mark.parametrize("nc,flags,dtype", [
    (2, 0, np.float32), (1, 0, np.float32),
    (2, 4, np.float32),                      # STRETCH_FAST_FLAG
    (2, 0, np.float64),
    (2, 2, np.float32),                      # STRETCH_DUAL_FLAG (cascade)
])
def test_stretch_native_block_loop_matches_python(nc, flags, dtype):
    """The native TDHS block loop (art_stretch_run) is bit-identical to
    the Python per-block engine across modes, channel counts, dtypes and
    ratios (the Python loop is the parity oracle; the CLI byte-identity
    tests anchor both to the reference build)."""
    import unittest.mock as um

    from art_jax import native
    from art_jax.engines.stretch import Stretcher

    if not native.available():
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(17)
    n = 30000
    x = (rng.standard_normal(n * nc) * 0.5).astype(dtype)
    ratio = 0.3 if flags & 2 else 0.8

    a = Stretcher(100, 300, nc, flags, dtype=dtype)
    out_a = [a.process(x, n, ratio), a.flush()]

    def no_native(self):
        return None

    with um.patch.object(Stretcher, "_native_runner", no_native):
        b = Stretcher(100, 300, nc, flags, dtype=dtype)
        out_b = [b.process(x, n, ratio), b.flush()]
    for ca, cb in zip(out_a, out_b):
        assert ca.dtype == cb.dtype and ca.shape == cb.shape
        assert np.array_equal(ca, cb)
    assert a.outsamples_error == b.outsamples_error
    assert a.tail == b.tail and a.head == b.head


def test_cli_device_mesh_postfilter_iooverlap_compose(tmp_path):
    """All round-3 CLI features in ONE conversion: --backend=device
    --mesh=4x2 (streams x taps sharding) + -p (device biquad cascade) +
    -m (IO-overlap pools) + unshaped 16-bit device decimate.  Counts and
    warnings match the plain numpy backend; codes at the documented
    device floor."""
    import io as _io
    from contextlib import redirect_stderr

    import numpy as np

    from art_jax.cli import art
    from art_jax.io import wavfile

    rng = np.random.default_rng(23)
    n = 30000
    x = (rng.standard_normal((n, 2)) * 0.4).astype(np.float32)
    src = tmp_path / "in.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=0x3)
        f.write(x.astype("<f4").tobytes())

    def convert(args, tag):
        dst = tmp_path / f"out_{tag}.wav"
        buf = _io.StringIO()
        with redirect_stderr(buf):
            rc = art.main(["-q", "-y", *args, str(src), str(dst)])
        assert not rc
        return dst.read_bytes(), buf.getvalue()

    base_args = ["-r48k", "-o16", "-n0", "-p"]
    an, wn = convert(["--backend=numpy", *base_args], "numpy")
    ad, wd = convert(["--backend=device", "--mesh=4x2", "-m", *base_args],
                     "devmesh")
    assert len(an) == len(ad)
    assert wn == wd
    da = np.frombuffer(an[-40000:], "<i2").astype(np.int32)
    db = np.frombuffer(ad[-40000:], "<i2").astype(np.int32)
    diff = np.abs(da - db)
    assert diff.max() <= 12 and diff.mean() < 2.0


def test_cli_device_oversize_engine_chunk_single_shape(tmp_path, monkeypatch):
    """-t16 -f1024 makes the device engine's padded chunk (nb*L = 18432
    rows) exceed the CLI's decimator row bucket (ceil(outcap/256)*256 =
    18176): the oversize rows are invalid padding and must be sliced off
    so the fused DeviceDecimator still compiles exactly ONE shape (on a
    compile-per-shape deployment every extra shape is a fresh compile).
    Output parity vs the numpy backend at the documented conv floor."""
    import io as _io
    from contextlib import redirect_stderr

    import numpy as np

    from art_jax.cli import art
    from art_jax.engines.decimator import DeviceDecimator
    from art_jax.io import wavfile

    rng = np.random.default_rng(11)
    n = 44100
    x = (rng.standard_normal((n, 2)) * 0.4).astype(np.float32)
    src = tmp_path / "in.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=44100, channel_mask=0x3)
        f.write(x.astype("<f4").tobytes())

    rows_seen = set()
    orig = DeviceDecimator.process_chunk_async

    def spy(self, srcarr, generated):
        rows_seen.add(int(srcarr.shape[0]))
        return orig(self, srcarr, generated)

    monkeypatch.setattr(DeviceDecimator, "process_chunk_async", spy)

    def convert(be, tag):
        dst = tmp_path / f"out_{tag}.wav"
        buf = _io.StringIO()
        with redirect_stderr(buf):
            rc = art.main(["-q", "-y", f"--backend={be}", "-t16", "-f1024",
                           "-r48k", "-o16", "-n0", str(src), str(dst)])
        assert not rc
        return dst.read_bytes(), buf.getvalue()

    ad, wd = convert("device", "device")
    assert len(rows_seen) == 1          # one compiled decimator shape
    an, wn = convert("numpy", "numpy")
    assert len(an) == len(ad)
    assert wn == wd
    da = np.frombuffer(an[-80000:], "<i2").astype(np.int32)
    db = np.frombuffer(ad[-80000:], "<i2").astype(np.int32)
    diff = np.abs(da - db)
    assert diff.max() <= 12 and diff.mean() < 2.0


def test_cli_mesh_requires_device_backend(tmp_path):
    """--mesh with a non-device backend must error, not silently run
    single-device."""
    import pytest

    from art_jax.cli import art

    with pytest.raises(SystemExit, match="--mesh requires"):
        art.parse_args(["--mesh=8", "-r48k", "in.wav", "out.wav"],
                       art.Options())


def test_cli_numeric_args_strtod_semantics(art_ref, tmp_path):
    """Bare/malformed numeric option arguments follow the reference's
    strtod/strtol prefix semantics (bare -g = 0 dB, -o24.5 = 24,
    --pitch=abc = 0 cents) instead of crashing with a traceback, and
    invalid configurations produce the reference's clean one-liners."""
    import io as _io
    from contextlib import redirect_stderr

    import numpy as np

    from art_jax.cli import art as art_cli
    from art_jax.io import wavfile

    rng = np.random.default_rng(3)
    n = 5000
    x = (rng.standard_normal((n, 1)) * 0.3).astype(np.float32)
    src = tmp_path / "in.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=1, num_frames=n,
                                 sample_rate=44100, channel_mask=0x4)
        f.write(x.astype("<f4").tobytes())

    def run(args, tag):
        dst = tmp_path / f"o_{tag}.wav"
        buf = _io.StringIO()
        with redirect_stderr(buf):
            try:
                rc = art_cli.main(["-q", "-y", *args, str(src), str(dst)])
            except SystemExit as e:
                rc, msg = 255, str(e)
                print(msg, file=sys.stderr)
                return rc, msg
        return rc, buf.getvalue()

    # bare -g == -g0 (strtod("") = 0): identical output bytes
    rc0, _ = run(["-g"], "gbare")
    rc1, _ = run(["-g0"], "g0")
    assert rc0 == 0 and rc1 == 0
    assert (tmp_path / "o_gbare.wav").read_bytes() == \
        (tmp_path / "o_g0.wav").read_bytes()

    # -o24.5 parses as 24 (atoi prefix)
    rc, _ = run(["-o24.5"], "o245")
    assert rc == 0

    # --pitch=abc parses as 0 cents (no-op pitch)
    rc, _ = run(["--pitch=abc", "-r48k"], "pabc")
    assert rc == 0

    # combined flag after a bare numeric option: -gv == -g -v
    rc, _ = run(["-gv"], "gv")
    assert rc == 0

    # lowpass above destination Nyquist: clean reference-style failure
    rc, msg = run(["-l30k"], "l30k")
    assert rc != 0
    assert "lowpass frequency must be lower than destination Nyquist!" in msg
    assert "error: resampler initialization failed!" in msg
    assert "Traceback" not in msg
    ref = subprocess.run([str(art_ref), "-q", "-y", "-l30k", str(src),
                          str(tmp_path / "oref.wav")], capture_output=True,
                         text=True)
    assert ref.returncode != 0
    assert "lowpass frequency must be lower than destination Nyquist!" \
        in ref.stderr

    # unknown backend: clean error
    with pytest.raises(SystemExit, match="--backend must be"):
        art_cli.parse_args(["--backend=Device", "a", "b"],
                           art_cli.Options())


def test_cli_f64_input_implies_f64_path(tmp_path):
    """A 64-bit float input WAV engages the f64 data path automatically
    (the -o64 rule): output bytes match an explicit --f64 run instead of
    silently downcasting through float32."""
    import io as _io
    from contextlib import redirect_stderr

    import numpy as np

    from art_jax.cli import art as art_cli
    from art_jax.io import wavfile

    rng = np.random.default_rng(9)
    n = 5000
    x = rng.standard_normal((n, 1)) * 0.3
    src = tmp_path / "in64.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=64, num_channels=1, num_frames=n,
                                 sample_rate=44100, channel_mask=0x4)
        f.write(x.astype("<f8").tobytes())

    def run(args, tag):
        dst = tmp_path / f"o_{tag}.wav"
        buf = _io.StringIO()
        with redirect_stderr(buf):
            rc = art_cli.main(["-q", "-y", *args, str(src), str(dst)])
        assert rc == 0
        return dst.read_bytes()

    auto = run(["-r48k"], "auto")
    explicit = run(["--f64", "-r48k"], "explicit")
    assert auto == explicit
    # and the data survives at f64 precision (not an f32 round trip)
    hdr = 80  # generous header skip; compare the tail samples
    vals = np.frombuffer(auto[-n // 2 * 8:], "<f8")
    assert np.abs(vals).max() > 0
    assert (vals != vals.astype(np.float32).astype(np.float64)).any()


def test_art_cli_low_rate_stretch_clean_error(tmp_path):
    """rate//350 < MIN_PERIOD (rates under ~8.4k): the reference prints
    'stretchInit(): invalid periods!' and then SEGFAULTS on the NULL
    context (stretch.c:62, art.c:786) — we print the same line and exit
    cleanly (CLI fuzz seed 149)."""
    import io as _io
    from contextlib import redirect_stderr

    from art_jax.cli import art as art_cli

    p = tmp_path / "low.wav"
    with open(p, "wb") as f:
        wavfile.write_wav_header(f, bits=16, num_channels=1, num_frames=64,
                                 sample_rate=8000, channel_mask=0x4)
        f.write(b"\x00" * 128)
    buf = _io.StringIO()
    with redirect_stderr(buf):
        rc = art_cli.main(["--tempo=1.5", "-y", "-q", str(p),
                           str(tmp_path / "o.wav")])
    assert rc != 0
    assert "stretchInit(): invalid periods!" in buf.getvalue()
    assert "Traceback" not in buf.getvalue()


def test_art_cli_allpass_integer_downsample_bit_exact(art_ref, tmp_path):
    """Integer-factor allpass downsample (48k->8k -a): every output is the
    passthrough shortcut (resampler.c:1141-1142), Lp == 1 in the periodic
    fast path — previously an empty reduction crash (CLI fuzz seed 141);
    must be byte-identical to the reference."""
    lcg = NoiseLCG()
    n = 20000
    frames = lcg.fill(n * 2).reshape(n, 2) * 0.4
    p = tmp_path / "in.wav"
    with open(p, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2, num_frames=n,
                                 sample_rate=48000, channel_mask=0x3)
        f.write(frames.astype("<f4").tobytes())
    ref_out, my_out = tmp_path / "r.wav", tmp_path / "m.wav"
    subprocess.run([str(art_ref), "-3", "-r8000", "-a", "-o32", "-y", "-q",
                    str(p), str(ref_out)], check=True, capture_output=True)
    assert _run_art_cli(["-3", "-r8000", "-a", "-o32", "-y", "-q", str(p),
                         str(my_out)]) == 0
    assert ref_out.read_bytes() == my_out.read_bytes()
