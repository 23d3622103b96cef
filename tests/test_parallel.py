"""Device-resident streaming engine and multi-chip sharding tests (run on a
virtual 8-device CPU mesh; see conftest)."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from art_jax.core.flags import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                                SUBSAMPLE_INTERPOLATE)
from art_jax.engines.resampler import Resampler
from art_jax.parallel.streams import DeviceStreamResampler
from art_jax.utils.testsig import NoiseLCG

IBL = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS


def test_device_stream_matches_host_engine():
    lcg = NoiseLCG()
    chunks = [lcg.fill(20000 * 2).reshape(20000, 2).T.copy()
              for _ in range(4)]
    r = Resampler.fixed_ratio(2, 380, 380, 44100, 48000, 0, IBL,
                              backend="numpy")
    r.advance_position(190)
    d = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IBL)
    d.advance_position(190)
    md = 0.0
    for c in chunks:
        ho, res = r.process(c, c.shape[1], 30000, 0.0)
        do, K = d.process(jnp.asarray(c), c.shape[1])
        assert K == res.output_generated
        md = max(md, float(np.abs(ho - np.asarray(do)[:, :K]).max()))
    ho, res = r.process(None, -1, 30000, 0.0)
    do, K = d.flush()
    assert K == res.output_generated
    md = max(md, float(np.abs(ho - np.asarray(do)[:, :K]).max()))
    assert md < 2e-6
    assert abs(r.get_position() - d.get_position()) < 1e-9


def test_device_stream_downsample():
    lcg = NoiseLCG()
    r = Resampler.fixed_ratio(1, 156, 320, 96000, 44100, 0, IBL,
                              backend="numpy")
    d = DeviceStreamResampler(1, 156, 320, 96000, 44100, 0, IBL)
    md = 0.0
    for _ in range(3):
        c = lcg.fill(8192).reshape(1, 8192)
        ho, res = r.process(c, 8192, 8192, 0.0)
        do, K = d.process(jnp.asarray(c), 8192)
        assert K == res.output_generated
        md = max(md, float(np.abs(ho - np.asarray(do)[:, :K]).max()))
    assert md < 2e-6


def test_device_stream_long_run_no_drift():
    """2000 odd-sized chunks (~660k samples): emission counts and the phase
    position stay exactly equal to the host engine — the device engine uses
    the plan's C-exact ring-slide state advance, so float-tie comparisons
    can never diverge over long streams."""
    r = Resampler.fixed_ratio(1, 48, 380, 44100, 48000, 0, IBL,
                              backend="numpy")
    d = DeviceStreamResampler(1, 48, 380, 44100, 48000, 0, IBL)
    r.advance_position(24)
    d.advance_position(24)
    lcg = NoiseLCG()
    for i in range(2000):
        x = lcg.fill(331).reshape(1, 331)
        _, res = r.process(x, 331, 1000, 0.0)
        _, K = d.process(jnp.asarray(x), 331)
        assert K == res.output_generated, i
        assert r.get_position() == d.get_position(), i


def test_device_stream_accepts_interpolated_rational_config():
    # interpolated configs with an exact rational ratio are supported
    # (two banked matmuls + phase lerp); see
    # test_device_interpolated_matches_host for the parity check
    from art_jax.core.flags import NO_FILTER_REDUCTION
    eng = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0,
                                IBL | NO_FILTER_REDUCTION)
    assert eng.interp and (eng.L, eng.M) == (160, 147)


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_dryrun_multichip(n_devices):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as g
    g.dryrun_multichip(n_devices)


def _clean_env(repo):
    import os
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_dryrun_multichip_standalone_like_driver():
    """The hook must bootstrap its own virtual 8-device mesh in a fresh
    process with NO pre-forced device flags."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('ok')"],
        env=_clean_env(repo), cwd=str(repo), capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ok" in r.stdout


def test_dryrun_multichip_after_jax_initialized():
    """When jax is already bound to a too-small backend (the driver may
    compile-check entry() on the single real chip first), the hook must
    still succeed via its clean-subprocess fallback."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    script = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert len(jax.devices()) < 8\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", script],
                       env=_clean_env(repo), cwd=str(repo),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ok" in r.stdout


def test_sharded_pipeline_matches_single_device():
    """Sharded (streams x taps) result must equal the unsharded math — the
    multi-device analog of the reference's threaded-vs-unthreaded A/B."""
    from art_jax.parallel.sharding import (batched_pipeline_step,
                                           example_batch, make_mesh)
    # scaler chosen so some samples genuinely clip (guards the clip-count
    # collective against double reduction over the taps axis)
    kw = dict(M=3, L=2, nb=4, qn=4, hist_len=32, scaler=3e5,
              highclip=32767, lowclip=-32768)
    mesh = make_mesh(4, 2)
    step = batched_pipeline_step(mesh, **kw)
    x, hist, Pmat, start = example_batch(mesh, n_streams=8)
    out, nh, clips, power = step(x, hist, Pmat, start)

    mesh1 = make_mesh(1, 1)
    step1 = batched_pipeline_step(mesh1, **kw)
    out1, nh1, clips1, power1 = step1(x, hist, Pmat, start)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out1), atol=1e-6)
    assert int(clips1) > 0
    assert int(clips) == int(clips1)
    assert abs(float(power) - float(power1)) < 1e-3


def test_entry_compiles():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] == 2 and np.isfinite(np.asarray(out)).all()


def test_hybrid_cli_backend_matches_numpy(tmp_path):
    """`art --backend=device` (device steady state + host edges) produces
    the same counts as the numpy backend and samples at the f32 floor."""
    import struct
    import subprocess  # noqa: F401  (parity with other CLI tests)

    import numpy as np

    from art_jax.cli import art as art_cli

    sr, n, ch = 44100, 60000, 2
    rng = np.random.default_rng(13)
    sig = np.clip(rng.standard_normal((n, ch)) * 0.4, -1, 1).astype("<f4")
    wav_in = tmp_path / "in.wav"
    with open(wav_in, "wb") as f:
        fmt = struct.pack("<HHIIHH", 3, ch, sr, sr * ch * 4, ch * 4, 32)
        data = sig.tobytes()
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data))
                + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)

    outs = {}
    for be in ("numpy", "device"):
        out = tmp_path / f"out_{be}.wav"
        rc = art_cli.main([f"--backend={be}", "-r48000", "-y", "-q",
                           str(wav_in), str(out)])
        assert not rc
        d = out.read_bytes()
        i = d.index(b"data")
        cnt = int.from_bytes(d[i + 4:i + 8], "little")
        outs[be] = np.frombuffer(d[i + 8:i + 8 + cnt], "<f4")
    assert len(outs["numpy"]) == len(outs["device"])
    # f32 floor class: the banded-wide contraction reassociates the K sum
    # vs the host's sequential loop (~5e-7 abs at 0.5 scale, proportional
    # to signal scale); this clipped-to-1.0
    # signal sits at ~1.6e-6
    assert np.abs(outs["numpy"] - outs["device"]).max() < 3e-6


def test_device_interpolated_matches_host():
    """Interpolated fixed-rational device mode (two banked matmuls + phase
    lerp): counts and positions exact vs the host engine, samples at the
    f32 matmul floor, across several chunks and a 48-filter preset-1
    config."""
    import jax.numpy as jnp

    from art_jax.core import flags as F
    from art_jax.engines.resampler import Resampler
    from art_jax.parallel.streams import DeviceStreamResampler

    rng = np.random.default_rng(3)
    for ch, taps, filt, fl in [
            (2, 380, 380, F.SUBSAMPLE_INTERPOLATE | F.BLACKMAN_HARRIS
             | F.INCLUDE_LOWPASS | F.NO_FILTER_REDUCTION),
            (1, 48, 48, F.SUBSAMPLE_INTERPOLATE | F.BLACKMAN_HARRIS
             | F.INCLUDE_LOWPASS)]:
        dev = DeviceStreamResampler(ch, taps, filt, 44100, 48000, 0, fl)
        host = Resampler.fixed_ratio(ch, taps, filt, 44100, 48000, 0, fl)
        dev.advance_position(taps // 2)
        host.advance_position(taps // 2)
        for _ in range(4):
            n = 9000
            x = (rng.standard_normal((ch, n)) * 0.3).astype(np.float32)
            out_d, K = dev.process(jnp.asarray(x), n)
            out_h, res = host.process(x, n, n * 2, 0.0)
            assert K == res.output_generated
            assert abs(dev.get_position() - host.get_position()) < 1e-12
            np.testing.assert_allclose(np.asarray(out_d)[:, :K],
                                       out_h[:, :K], atol=2e-6)


def test_device_interpolated_rejects_irrational():
    from art_jax.core import flags as F
    from art_jax.parallel.streams import DeviceStreamResampler
    with pytest.raises(ValueError):
        DeviceStreamResampler(2, 380, 380, 44100.5, 48000, 0,
                              F.SUBSAMPLE_INTERPOLATE | F.BLACKMAN_HARRIS
                              | F.INCLUDE_LOWPASS | F.NO_FILTER_REDUCTION)


def test_interp_device_exact_fi_selection_10M_outputs():
    """Exact-fi verification (round-1 weak #5): over >=1e7 streamed outputs
    the interpolated device mode's tiled per-chunk pattern reads the same
    continuous phase position as the host oracle (ring-exact rounding,
    reference resampler.c:526 + 1147-1157) to within PATTERN_TOL, and the
    engine's _pattern_safe guard agrees with an independently computed
    ground truth chunk by chunk.

    Note the criterion is phase-equivalence, not bitwise (window, filter)
    equality: rational-ratio positions sit exactly on the float64 phase
    grid, so fi flips with compensating fractions (value-continuous via the
    rotated extra filter) are systematic — both sides of each tie denote
    the same continuous read position."""
    import numpy as np

    from art_jax.core import accounting
    from art_jax.core.flags import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                                    SUBSAMPLE_INTERPOLATE)
    from art_jax.parallel.streams import DeviceStreamResampler

    eng = DeviceStreamResampler(
        1, 48, 48, 44100, 48000, 0,
        SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS)
    assert eng.interp
    eng.advance_position(24)
    total = 0
    worst = 0.0
    n_in = 14700
    while total < 10_500_000:
        K, start, j0, pos0, plan = eng._plan_compute(n_in)
        nb = -(-K // eng.L) if K else 1
        _, _, d, fi, frac = eng._interp_matrix(pos0)
        ipos0 = math.floor(pos0)
        safe = eng._pattern_safe(plan, n_in, K, nb, ipos0, d, fi, frac)
        # independent oracle (the host engine's exact position pipeline)
        ip, frac0 = accounting.ring_positions(
            first_position=plan.first_position,
            flush_shift=plan.flush_shift, ratio=eng.fixed_ratio, K=K,
            input_index=eng.input_index, input_used=plan.input_used,
            num_samples=eng.num_samples, num_taps=eng.num_taps,
            flush=plan.flush)
        pidx = np.arange(K, dtype=np.int64)
        pos_pat = (ipos0 + np.tile(d, nb)[:K]
                   + (pidx // eng.L).astype(np.float64) * eng.M
                   + np.tile((fi.astype(np.float64) + frac)
                             / eng.num_filters, nb)[:K])
        dev = np.abs((ip.astype(np.float64) + frac0) - pos_pat).max()
        worst = max(worst, float(dev))
        assert safe, f"phase deviation {dev} at output {total}"
        # exercise the full-scan verification path too (the analytic ulp
        # bound normally short-circuits it): with a tolerance below the
        # bound, the verdict must track the measured deviation exactly
        eng.PATTERN_TOL = 1e-13
        eng._pattern_safe_cache.clear()
        scanned = eng._pattern_safe(plan, n_in, K, nb, ipos0, d, fi, frac)
        assert scanned == bool(dev <= 1e-13)
        eng.PATTERN_TOL = type(eng).PATTERN_TOL
        total += K
        eng.output_offset = plan.new_output_offset
        eng.input_index = plan.new_input_index
    assert total >= 10_000_000
    assert worst <= type(eng).PATTERN_TOL


def test_interp_device_split_path_matches_host():
    """When a chunk's tiled pattern is flagged unsafe, the engine splits it
    into provably-exact sub-chunks with unchanged results."""
    import jax.numpy as jnp
    import numpy as np

    from art_jax.core.flags import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                                    SUBSAMPLE_INTERPOLATE)
    from art_jax.engines.resampler import Resampler
    from art_jax.parallel.streams import DeviceStreamResampler
    from art_jax.utils.testsig import NoiseLCG

    FLAGS = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
    eng = DeviceStreamResampler(1, 48, 48, 44100, 48000, 0, FLAGS)
    host = Resampler.fixed_ratio(1, 48, 48, 44100, 48000, 0, FLAGS,
                                 backend="numpy")
    eng.advance_position(24)
    host.advance_position(24)
    lcg = NoiseLCG()
    md = 0.0
    for it in range(4):
        x = lcg.fill(1470).reshape(1, -1)
        if it == 2:       # force the split path for one chunk (a truly
            # deviating pattern also fails the steady-state reuse
            # compare, so clearing the reuse state models it faithfully)
            eng._last_interp = None
            orig = eng._pattern_safe
            tripped = []

            def fake(plan, n_in, K, nb, *a):
                if nb > 1 and not tripped:
                    tripped.append(1)
                    return False
                return orig(plan, n_in, K, nb, *a)

            eng._pattern_safe = fake
        out, K = eng.process(jnp.asarray(x), 1470)
        if it == 2:
            assert tripped
            eng._pattern_safe = orig
        ho, res = host.process(x, 1470, 3000, 0.0)
        assert res.output_generated == K
        md = max(md, float(np.abs(np.asarray(out)[0, :K] - ho[0]).max()))
        assert abs(eng.get_position() - host.get_position()) < 1e-12
    assert md < 1e-6


@pytest.mark.parametrize("meshspec", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("config", ["reduced", "interp"])
def test_device_stream_mesh_matches_single_device(meshspec, config):
    """The SHIPPED streaming engine over a mesh (streams data-parallel,
    taps tensor-parallel with one psum): emission counts are exact and
    samples sit at the f32 matmul floor of the single-device step.  True
    bitwise equality across partitionings is not a meaningful target: XLA
    compiles each local shape separately and reassociates fp (the reference
    itself is not bit-stable across compilers, -fassociative-math); the
    reference's threaded==unthreaded bitwise guarantee maps to counts +
    positions exact and samples within the documented floor."""
    from art_jax.core.flags import NO_FILTER_REDUCTION
    from art_jax.parallel.sharding import make_mesh

    if config == "reduced":
        ctor = (2, 380, 380, 44100, 48000, 0, IBL)
    else:
        ctor = (2, 48, 48, 44100, 48000, 0,
                SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
                | NO_FILTER_REDUCTION)
    e1 = DeviceStreamResampler(*ctor)
    e2 = DeviceStreamResampler(*ctor, mesh=make_mesh(*meshspec))
    assert e2.interp == (config == "interp")
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 4096)).astype(np.float32) * 0.25)
    a1 = jnp.zeros((), jnp.float32)
    a2 = jnp.zeros((), jnp.float32)
    for _ in range(3):
        o1, K1, a1 = e1.process(x, 4096, a1)
        o2, K2, a2 = e2.process(x, 4096, a2)
        assert K1 == K2
        assert e1.output_offset == e2.output_offset
        assert e1.input_index == e2.input_index
        v1 = np.asarray(o1)[:, :K1]
        v2 = np.asarray(o2)[:2, :K1]
        assert np.abs(v1 - v2).max() <= 2e-6 * max(1.0, np.abs(v1).max())
    assert np.isclose(float(a1), float(a2), rtol=1e-4)


def test_hybrid_mesh_cli_reachable(tmp_path):
    """A CLI-driven file conversion sharded over the virtual 8-device mesh
    (--backend=device --mesh=8): output frame counts and file sizes match
    the unsharded device backend exactly; decoded samples at the f32 floor
    (the -o32 float container makes the comparison exact at sample level)."""
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

    outs = {}
    for tag, extra in (("plain", []), ("mesh8", ["--mesh=8"]),
                       ("mesh42", ["--mesh=4x2"])):
        dst = tmp_path / f"out_{tag}.wav"
        rc = art.main(["-q", "-y", "--backend=device", "-r48k", *extra,
                       str(src), str(dst)])
        assert not rc
        outs[tag] = dst.read_bytes()

    assert len(outs["plain"]) == len(outs["mesh8"]) == len(outs["mesh42"])
    ref = np.frombuffer(outs["plain"][-n * 8:], "<f4")
    for tag in ("mesh8", "mesh42"):
        got = np.frombuffer(outs[tag][-n * 8:], "<f4")
        assert np.abs(ref - got).max() <= 2e-6 * max(1.0, np.abs(ref).max())


def test_preset4_bank_taps_sharded_through_shipped_engine():
    """SURVEY §5 'filter too large for one core': the preset-4
    988-tap bank sharded 2-way on the taps axis through the SHIPPED
    DeviceStreamResampler (the same class art --backend=device --mesh=4x2
    constructs) — counts exact, samples at the f32 floor of the
    single-device engine."""
    from art_jax.parallel.sharding import make_mesh

    ctor = (2, 988, 988, 44100, 48000, 0, IBL)
    e1 = DeviceStreamResampler(*ctor)
    e2 = DeviceStreamResampler(*ctor, mesh=make_mesh(4, 2))
    assert e2._qn_pad % 2 == 0
    rng = np.random.default_rng(21)
    x = jnp.asarray(rng.standard_normal((2, 2048)).astype(np.float32) * 0.25)
    for _ in range(2):
        o1, K1 = e1.process(x, 2048)
        o2, K2 = e2.process(x, 2048)
        assert K1 == K2
        v1 = np.asarray(o1)[:, :K1]
        v2 = np.asarray(o2)[:2, :K1]
        assert np.abs(v1 - v2).max() <= 2e-6 * max(1.0, np.abs(v1).max())


def test_sharded_hot_path_has_no_data_collectives():
    """The communication-avoidance design claim, pinned on the compiled
    HLO: streams-axis sharding of the shipped engine moves NO tensor data
    between devices (streams are independent; the only collectives are
    the scalar stats psums), and taps-axis sharding adds exactly the one
    partial-dot reduction.  No all-gather / all-to-all / collective-
    permute may ever appear in the hot path."""
    import re

    from art_jax.parallel.sharding import make_mesh

    def hlo_for(meshspec):
        eng = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IBL,
                                    mesh=make_mesh(*meshspec))
        nb = 29          # steady-state block count for a 4096-frame chunk
        step = eng._sharded_step(nb)
        args = (eng.hist,
                jnp.zeros((eng._rows, 4096), jnp.float32),
                eng._matrix(0), jnp.int32(0), jnp.int32(nb * eng.L),
                jnp.zeros((), jnp.float32))
        return step.lower(*args).compile().as_text()

    for meshspec in [(8, 1), (4, 2)]:
        txt = hlo_for(meshspec)
        assert "all-gather" not in txt, meshspec
        assert "all-to-all" not in txt, meshspec
        assert "collective-permute" not in txt, meshspec
        # all-reduces: scalar stats psum(s) always; the taps-parallel
        # contraction adds reductions over [S_local, nb, L] tiles.  Bound
        # the count and, for streams-only sharding, require every
        # all-reduce operand to be scalar-shaped (f32[] — no tensor data
        # crosses devices)
        ars = [l for l in txt.splitlines() if "all-reduce(" in l]
        assert len(ars) <= (2 if meshspec[1] == 1 else 6), (meshspec, ars)
        if meshspec[1] == 1:
            for line in ars:
                # scalar operand, or singleton replica groups (= the
                # partitioner proved no cross-device movement at all)
                assert re.search(r"f32\[\]", line) \
                    or "{{0},{1}" in line.replace(" ", ""), (meshspec, line)


def test_device_stream_process_scan_matches_sequential():
    """process_scan (G chunks per dispatch via lax.scan) produces the
    sequential process() stream exactly: same counts, samples, history,
    power, position."""
    lcg = NoiseLCG()
    G, n = 5, 2000
    xs = jnp.asarray(lcg.fill(G * 2 * n).reshape(G, 2, n))
    a = DeviceStreamResampler(2, 64, 380, 44100, 48000, 0, IBL)
    b = DeviceStreamResampler(2, 64, 380, 44100, 48000, 0, IBL)
    a.advance_position(32)
    b.advance_position(32)
    acc = jnp.zeros((), jnp.float32)
    outs_seq, Ks_seq = [], []
    for g in range(G):
        o, K, acc = a.process(xs[g], n, acc)
        outs_seq.append(np.asarray(o))
        Ks_seq.append(K)
    accb = jnp.zeros((), jnp.float32)
    outs, Ks, accb = b.process_scan(xs, n, accb)
    assert list(Ks) == Ks_seq
    for g in range(G):
        K = Ks_seq[g]
        np.testing.assert_array_equal(np.asarray(outs[g])[:, :K],
                                      outs_seq[g][:, :K])
    np.testing.assert_array_equal(np.asarray(b.hist), np.asarray(a.hist))
    assert np.isclose(float(accb), float(acc), rtol=1e-6)
    assert a.get_position() == b.get_position()
    # a second scan call continues the stream (jit cache reuse, state carry)
    o2, K2, acc = a.process(xs[0], n, acc)
    outs2, Ks2, accb = b.process_scan(xs[:1], n, accb)
    assert Ks2[0] == K2
    np.testing.assert_array_equal(np.asarray(outs2[0])[:, :K2],
                                  np.asarray(o2)[:, :K2])


@pytest.mark.parametrize("ctor,n", [
    # reduced mode, M-multiple chunk -> static-plan scan
    ((2, 64, 380, 44100, 48000, 0, IBL), None),
    # reduced mode, non-periodic chunk -> dynamic-meta scan
    ((2, 64, 380, 44100, 48000, 0, IBL), 2000),
    # interpolated mode (no lowpass keeps 380 filters un-reduced)
    ((1, 48, 48, 44100, 48000, 0, IB), 1470),
    # interpolated mode, non-periodic chunk -> dynamic-meta interp scan
    ((1, 48, 48, 44100, 48000, 0, IB), 1000),
])
def test_process_scan_stats_matches_stacked(ctor, n):
    """stats=True (outputs consumed in-graph by the power accumulator,
    never materialized) advances acc/hist/Ks bitwise-identically to the
    stacked form — the headline-bench contract (reference artest.c:491
    update_stats as the output consumer)."""
    lcg = NoiseLCG()
    G = 5
    a = DeviceStreamResampler(*ctor)
    b = DeviceStreamResampler(*ctor)
    if n is None:
        n = 4 * a.M
    ch = ctor[0]
    xs = jnp.asarray(lcg.fill(G * ch * n).reshape(G, ch, n))
    a.advance_position(ctor[1] // 2)
    b.advance_position(ctor[1] // 2)
    acc_a = jnp.zeros((), jnp.float32)
    outs, Ks_a, acc_a = a.process_scan(xs, n, acc_a)
    acc_b = jnp.zeros((), jnp.float32)
    none_out, Ks_b, acc_b = b.process_scan(xs, n, acc_b, stats=True)
    assert none_out is None
    assert list(Ks_a) == list(Ks_b)
    np.testing.assert_array_equal(np.asarray(b.hist), np.asarray(a.hist))
    assert float(acc_a) == float(acc_b)
    assert a.get_position() == b.get_position()
    with pytest.raises(ValueError, match="stats=True"):
        b.process_scan(xs, n, stats=True)


@pytest.mark.parametrize("ctor", [
    # reduced mode
    (2, 64, 380, 44100, 48000, 0, IBL),
    # interpolated mode, dyadic period (positions exact in f64 -> the
    # phase pattern repeats bitwise and the flat path engages)
    (1, 48, 48, 5000, 256000, 0, IB),
    # interpolated mode, non-dyadic period (pattern cache identity breaks
    # at f64 rounding -> clean rejection + process_scan fallback)
    (1, 48, 48, 44100, 48000, 0, IB),
])
def test_process_flat_matches_sequential(ctor):
    """process_flat (fully-static unrolled group over one flat buffer,
    outputs consumed in-graph) advances acc/hist/Ks/position
    bitwise-identically to sequential process() on the periodic steady
    state, and rejects non-periodic chunk sizes with no state consumed."""
    lcg = NoiseLCG()
    a = DeviceStreamResampler(*ctor)
    b = DeviceStreamResampler(*ctor)
    ch = ctor[0]
    a.advance_position(ctor[1] // 2)
    b.advance_position(ctor[1] // 2)
    G = 5
    # chunks must be M-multiples and the group must cover the history
    # (with one chunk of slack: the rejection sub-check below shrinks
    # every chunk by one sample)
    n = max(8, -(-a.num_samples // (G * a.M)) + 1) * a.M
    xs = jnp.asarray(lcg.fill(G * ch * n).reshape(G, ch, n))
    # absorb the non-periodic first chunk on both engines
    first = jnp.asarray(lcg.fill(ch * n).reshape(ch, n))
    acc_a = jnp.zeros((), jnp.float32)
    _o, _k, acc_a = a.process(first, n, acc_a)
    acc_b = jnp.zeros((), jnp.float32)
    _o, _k, acc_b = b.process(first, n, acc_b)
    Ks_a = []
    for g in range(G):
        _o, K, acc_a = a.process(xs[g], n, acc_a)
        Ks_a.append(K)
    flat = jnp.concatenate([xs[g] for g in range(G)], axis=1)
    state_b0 = (b.output_offset, b.input_index)
    try:
        Ks_b, acc_b = b.process_flat(flat, n, acc_b)
    except ValueError:
        # non-repeating interp pattern: clean rejection + scan fallback
        assert (b.output_offset, b.input_index) == state_b0
        _none, Ks_b, acc_b = b.process_scan(xs, n, acc_b, stats=True)
    assert list(Ks_b) == Ks_a
    np.testing.assert_array_equal(np.asarray(b.hist), np.asarray(a.hist))
    assert float(acc_a) == float(acc_b)
    assert a.get_position() == b.get_position()
    # a second group continues the stream.  The interpolated mode may
    # legitimately reject it (the phase pattern's cache identity can
    # break at f64 rounding magnitudes); the contract is then a CLEAN
    # rejection (no state consumed) and process_scan continues the
    # stream bit-identically.
    Ks_a2 = []
    for g in range(G):
        _o, K, acc_a = a.process(xs[g], n, acc_a)
        Ks_a2.append(K)
    state_b = (b.output_offset, b.input_index)
    try:
        Ks_b2, acc_b = b.process_flat(flat, n, acc_b)
    except ValueError:
        assert (b.output_offset, b.input_index) == state_b
        _none, Ks_b2, acc_b = b.process_scan(xs, n, acc_b, stats=True)
    assert list(Ks_b2) == Ks_a2
    assert float(acc_a) == float(acc_b)
    # non-periodic chunk size: clean rejection, no state consumed
    state = (b.output_offset, b.input_index)
    with pytest.raises(ValueError, match="periodic"):
        b.process_flat(flat[:, : G * (n - 1)], n - 1, acc_b)
    assert (b.output_offset, b.input_index) == state


@pytest.mark.parametrize("ctor", [
    # reduced mode
    (2, 64, 380, 44100, 48000, 0, IBL),
    # interpolated mode, dyadic period (flat path engages)
    (1, 48, 48, 5000, 256000, 0, IB),
])
def test_process_flat_out_and_packed_match_sequential(ctor):
    """process_flat_out delivers [ch, G*K] output samples bitwise equal
    to sequential process()'s valid prefixes (the audio-materializing
    flat form: static-slice instead of mask, concat fused into the dot
    epilogues), and process_flat_packed's bytes equal the device
    quantizer (quantize_flat_dev with no dither) + pack on those
    samples, with matching clip counts.  State (hist/position/Ks)
    advances identically across all three engines."""
    from art_jax.ops import decimate_device as dd

    lcg = NoiseLCG()
    ch = ctor[0]
    a = DeviceStreamResampler(*ctor)                  # sequential oracle
    b = DeviceStreamResampler(*ctor)                  # flat_out
    c = DeviceStreamResampler(*ctor)                  # flat_packed
    for e in (a, b, c):
        e.advance_position(ctor[1] // 2)
    G = 5
    n = max(8, -(-a.num_samples // (G * a.M)) + 1) * a.M
    xs = jnp.asarray(lcg.fill(G * ch * n).reshape(G, ch, n))
    first = jnp.asarray(lcg.fill(ch * n).reshape(ch, n))
    for e in (a, b, c):
        e.process(first, n)
    outs_a, Ks_a = [], []
    for g in range(G):
        o, K = a.process(xs[g], n)
        outs_a.append(np.asarray(o)[:, :K])
        Ks_a.append(K)
    flat = jnp.concatenate([xs[g] for g in range(G)], axis=1)
    out_b, Ks_b = b.process_flat_out(flat, n)
    assert list(Ks_b) == Ks_a
    np.testing.assert_array_equal(np.asarray(out_b),
                                  np.concatenate(outs_a, axis=1))
    np.testing.assert_array_equal(np.asarray(b.hist), np.asarray(a.hist))
    assert a.get_position() == b.get_position()

    # packed: 16-bit, gain 1.5 (drives a few clips on the LCG noise)
    scaler, hi, lo = 32768.0 * 1.5, 32767, -32768
    clips0 = jnp.zeros((), jnp.int32)
    packed, Ks_c, clips = c.process_flat_packed(
        flat, n, clips0, scaler=scaler, highclip=hi, lowclip=lo)
    assert list(Ks_c) == Ks_a
    np.testing.assert_array_equal(np.asarray(c.hist), np.asarray(a.hist))
    # oracle: the shipped device quantizer + packer on the exact samples
    samples = jnp.asarray(np.concatenate(outs_a, axis=1).T)   # [nK, ch]
    ov, clipf = dd.quantize_flat_dev(samples, None, scaler,
                                     jnp.zeros((ch,), samples.dtype),
                                     hi, lo)
    want = np.asarray(dd.pack_bytes_dev(ov, 16, 2))           # [nK, ch*2]
    # packed is the lane-dense u16 container [ch, nK]; its LE byte view
    # is the packed stream (process_flat_packed docstring)
    assert packed.dtype == jnp.uint16
    got = np.asarray(packed).view(np.uint8)                   # [ch, nK*2]
    nK = samples.shape[0]
    got_il = got.reshape(ch, nK, 2).transpose(1, 0, 2).reshape(nK, ch * 2)
    np.testing.assert_array_equal(got_il, want)
    assert int(clips) == int(jnp.sum(clipf))
    assert int(clips) > 0  # the gain choice actually exercises clipping

    # FLUSHED latch: no audio, no state advance
    b._flushed = True
    out0, Ks0 = b.process_flat_out(flat, n)
    assert out0.shape == (ch, 0) and list(Ks0) == [0] * G


def test_process_flat_packed_pow2_scaler_matches_f64_route():
    """The power-of-two-scaler fast path (plain f32 multiply — exact
    exponent shift) is bit-identical to the quantizer oracle's
    f64-route-and-round product (_mul_for): gain 1.0 configs always
    have scaler = 2^(bits-1), and the delivery path drops the
    f64 pointwise chain there."""
    from art_jax.ops import decimate_device as dd

    lcg = NoiseLCG()
    ctor = (2, 64, 380, 44100, 48000, 0, IBL)
    a = DeviceStreamResampler(*ctor)                  # sequential oracle
    c = DeviceStreamResampler(*ctor)                  # flat_packed
    for e in (a, c):
        e.advance_position(ctor[1] // 2)
    G = 4
    ch = ctor[0]
    n = max(8, -(-a.num_samples // (G * a.M)) + 1) * a.M
    xs = jnp.asarray(3.0 * lcg.fill(G * ch * n).reshape(G, ch, n))
    first = jnp.asarray(lcg.fill(ch * n).reshape(ch, n))
    for e in (a, c):
        e.process(first, n)
    outs_a = []
    for g in range(G):
        o, K = a.process(xs[g], n)
        outs_a.append(np.asarray(o)[:, :K])
    flat = jnp.concatenate([xs[g] for g in range(G)], axis=1)
    scaler, hi, lo = 32768.0, 32767, -32768           # 2^15: fast path
    packed, Ks_c, clips = c.process_flat_packed(
        flat, n, jnp.zeros((), jnp.int32), scaler=scaler, highclip=hi,
        lowclip=lo)
    samples = jnp.asarray(np.concatenate(outs_a, axis=1).T)   # [nK, ch]
    ov, clipf = dd.quantize_flat_dev(samples, None, scaler,
                                     jnp.zeros((ch,), samples.dtype),
                                     hi, lo)           # f64-route oracle
    want = np.asarray(dd.pack_bytes_dev(ov, 16, 2))
    got = np.asarray(packed).view(np.uint8)
    nK = samples.shape[0]
    got_il = got.reshape(ch, nK, 2).transpose(1, 0, 2).reshape(nK, ch * 2)
    np.testing.assert_array_equal(got_il, want)
    assert int(clips) == int(jnp.sum(clipf))
    assert int(clips) > 0  # the 3x input gain drives real clipping


def test_process_scan_rejects_mesh_mode():
    from art_jax.parallel.sharding import make_mesh
    eng = DeviceStreamResampler(2, 64, 380, 44100, 48000, 0, IBL,
                                mesh=make_mesh(8, 1))
    with pytest.raises(NotImplementedError):
        eng.process_scan(jnp.zeros((2, 2, 256), jnp.float32), 256)


def test_device_stream_process_scan_interp_matches_sequential():
    """Interpolated-mode scan batching: the stacked per-chunk banked
    matrices + lerp fractions produce the sequential stream exactly."""
    lcg = NoiseLCG()
    G, n = 4, 2000
    xs = jnp.asarray(lcg.fill(G * 2 * n).reshape(G, 2, n))
    ctor = (2, 64, 64, 44100, 48000, 0, IBL)   # 160 > 64: interpolated
    a = DeviceStreamResampler(*ctor)
    b = DeviceStreamResampler(*ctor)
    assert a.interp
    a.advance_position(32)
    b.advance_position(32)
    acc = jnp.zeros((), jnp.float32)
    outs_seq, Ks_seq = [], []
    for g in range(G):
        o, K, acc = a.process(xs[g], n, acc)
        outs_seq.append(np.asarray(o))
        Ks_seq.append(K)
    accb = jnp.zeros((), jnp.float32)
    outs, Ks, accb = b.process_scan(xs, n, accb)
    assert list(Ks) == Ks_seq
    for g in range(G):
        K = Ks_seq[g]
        np.testing.assert_array_equal(np.asarray(outs[g])[:, :K],
                                      outs_seq[g][:, :K])
    np.testing.assert_array_equal(np.asarray(b.hist), np.asarray(a.hist))
    assert np.isclose(float(accb), float(acc), rtol=1e-6)
    assert a.get_position() == b.get_position()


def test_process_scan_interp_pattern_fallback(monkeypatch):
    """When any chunk's tiled pattern fails the float64-tie oracle, the
    interp scan falls back to sequential process() for the whole group —
    same outputs, counts, state."""
    lcg = NoiseLCG()
    G, n = 3, 1500
    xs = jnp.asarray(lcg.fill(G * 2 * n).reshape(G, 2, n))
    ctor = (2, 64, 64, 44100, 48000, 0, IBL)
    a = DeviceStreamResampler(*ctor)
    b = DeviceStreamResampler(*ctor)
    a.advance_position(32)
    b.advance_position(32)
    # fail the oracle exactly once — on the scan's first planned chunk —
    # so the sequential fallback path itself plans normally
    orig = DeviceStreamResampler._pattern_safe
    fired = []

    def flaky(self, *args, **kw):
        if self is b and not fired:
            fired.append(True)
            return False
        return orig(self, *args, **kw)

    monkeypatch.setattr(DeviceStreamResampler, "_pattern_safe", flaky)
    outs_seq, Ks_seq = [], []
    for g in range(G):
        o, K = a.process(xs[g], n)
        outs_seq.append(np.asarray(o))
        Ks_seq.append(K)
    outs, Ks = b.process_scan(xs, n)
    assert list(Ks) == Ks_seq
    for g in range(G):
        K = Ks_seq[g]
        np.testing.assert_array_equal(np.asarray(outs[g])[:, :K],
                                      outs_seq[g][:, :K])
    np.testing.assert_array_equal(np.asarray(b.hist), np.asarray(a.hist))
    assert a.get_position() == b.get_position()


def test_process_scan_rejects_oversized_anchor_bank():
    """Configs whose stacked anchor bank would exceed the documented cap
    raise instead of silently allocating gigabytes (L=1024 reduced bank:
    ~8.6 GB)."""
    eng = DeviceStreamResampler(1, 380, 1024, 51150, 51200, 0, IBL)
    assert not eng.interp and eng.L == 1024
    # two chunks whose size is NOT a multiple of M so the plans differ:
    # an all-equal-plan group runs the static path, which legitimately
    # never builds the stacked bank
    assert 4096 % eng.M != 0
    with pytest.raises(ValueError, match="stacked anchor bank"):
        eng.process_scan(jnp.zeros((2, 1, 4096), jnp.float32), 4096)
    # and the failed dispatch must have rolled the plan state back
    assert eng.output_offset == 190.0 and eng.input_index == eng.num_taps


def test_sharded_step_perdevice_flops_scale():
    """The weak-scaling claim for the shipped engine, pinned on XLA's own
    cost model: per-device FLOPs of the compiled streams-sharded step
    halve with each doubling of the streams axis (8 channels over 1/2/4/8
    devices), and taps sharding composes ((4,2) ~ (8,1)).  Complements the
    no-data-collectives HLO test: together they prove the mesh path does
    1/N of the work per device and moves no tensor data for it."""
    from art_jax.parallel.sharding import make_mesh

    def per_device_flops(meshspec):
        eng = DeviceStreamResampler(8, 380, 380, 44100, 48000, 0, IBL,
                                    mesh=make_mesh(*meshspec))
        nb = 29
        step = eng._sharded_step(nb)
        args = (eng.hist, jnp.zeros((eng._rows, 4096), jnp.float32),
                eng._matrix(0), jnp.int32(0), jnp.int32(nb * eng.L),
                jnp.zeros((), jnp.float32))
        ca = step.lower(*args).compile().cost_analysis()
        if isinstance(ca, list):        # older jax returns [dict]
            ca = ca[0]
        return float(ca["flops"])

    f = {ms: per_device_flops(ms) for ms in [(1, 1), (2, 1), (4, 1),
                                             (8, 1), (4, 2)]}
    for a, b in [((1, 1), (2, 1)), ((2, 1), (4, 1)), ((4, 1), (8, 1))]:
        ratio = f[a] / f[b]
        assert 1.85 < ratio < 2.15, (a, b, f)
    # taps axis: splitting the contraction 2-way on top of 4-way streams
    # runs the per-anchor dots (qn_local < qn_pad gates the banded-wide
    # form off), so its flops are 1/banded_factor of 8-way streams'
    # banded dot (structural zeros: KW/KQ = (2*qn-1)/qn); corrected, it
    # lands within 10% (psum epilogue adds a little)
    eng = DeviceStreamResampler(8, 380, 380, 44100, 48000, 0, IBL)
    banded_factor = (2 * eng.qn - 1) / eng.qn
    assert abs(f[(4, 2)] * banded_factor / f[(8, 1)] - 1.0) < 0.10, f


def test_process_scan_size_rejection_preserves_state(monkeypatch):
    """A stacked-bank size rejection must fire BEFORE the per-chunk
    planning loop: _plan mutates consume/emit state, so raising after it
    would silently desync the engine from the audio."""
    eng = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IBL)
    eng.advance_position(190)
    state = (eng.output_offset, eng.input_index)

    def boom(self):
        raise ValueError("stacked anchor bank would need too much")

    monkeypatch.setattr(DeviceStreamResampler, "_stacked_matrices", boom)
    xs = jnp.zeros((3, 2, 1024), jnp.float32)
    with pytest.raises(ValueError):
        eng.process_scan(xs, 1024)
    assert (eng.output_offset, eng.input_index) == state


def test_device_engine_guards_and_flush_latch():
    """Round-3 review fixes: the device engine rejects
    EXTRAPOLATE_ENDPOINTS at init (it does not model endpoint
    extrapolation), slices capacity buffers wider than n_in (the invalid
    tail must not enter the history), and latches FLUSHED like the
    reference (input after flush ignored, second flush emits nothing)."""
    from art_jax.core.flags import EXTRAPOLATE_ENDPOINTS

    with pytest.raises(ValueError, match="EXTRAPOLATE_ENDPOINTS"):
        DeviceStreamResampler(2, 380, 380, 44100, 48000, 0,
                              IBL | EXTRAPOLATE_ENDPOINTS)

    a = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IBL)
    b = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IBL)
    a.advance_position(190)
    b.advance_position(190)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    # b gets a capacity buffer with garbage past n_in: results must equal
    # a's exact-width call
    xb = np.concatenate([x, np.full((2, 64), 1e9, np.float32)], axis=1)
    oa, Ka = a.process(jnp.asarray(x), 1000)
    ob, Kb = b.process(jnp.asarray(xb), 1000)
    assert Ka == Kb
    np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob))
    np.testing.assert_array_equal(np.asarray(a.hist), np.asarray(b.hist))

    # flush latch: second flush and post-flush process emit nothing and
    # do not advance state
    of1, Kf1 = a.flush()
    pos = a.get_position()
    of2, Kf2 = a.flush()
    assert Kf1 > 0 and Kf2 == 0
    op, Kp = a.process(jnp.asarray(x), 1000)
    assert Kp == 0 and not np.asarray(op).any()
    assert a.get_position() == pos


def test_hybrid_advance_midstream_and_scalar_query(tmp_path):
    """A mid-stream advance_position reaches the live device state (the
    host copy is stale while steady blocks run on device), and
    get_expected_output answers from the scalar mirrors without pulling
    the device history."""
    from art_jax.parallel.streams import HybridStreamResampler

    flags = IBL
    hyb = HybridStreamResampler(2, 48, 48, 44100, 48000, 0, flags)
    ref = HybridStreamResampler(2, 48, 48, 44100, 48000, 0, flags)
    hyb.advance_position(24)
    ref.advance_position(24)
    rng = np.random.default_rng(1)
    blocks = [rng.standard_normal((1000, 2)).astype(np.float32)
              for _ in range(4)]
    for blk in blocks[:2]:           # reach device steady state
        hyb.process_interleaved(blk, 1000, 4000)
        ref.process_interleaved(blk, 1000, 4000)
    assert hyb._on_device and ref._on_device

    # scalar dry-run query must not leave device residency
    exp = hyb.get_expected_output(1000)
    assert hyb._on_device
    # and must agree with the host-side answer after an explicit pull
    ref._pull()
    assert exp == ref.host.get_expected_output(1000, 0.0)
    ref._push()

    # mid-stream advance: both engines advance; outputs equal thereafter
    hyb.advance_position(3)
    ref._pull()
    ref.host.advance_position(3)
    for blk in blocks[2:]:
        oh, rh = hyb.process_interleaved(blk, 1000, 4000)
        orf, rr = ref.process_interleaved(blk, 1000, 4000)
        assert rh.output_generated == rr.output_generated
        np.testing.assert_allclose(oh, orf, atol=2e-7)
    assert hyb.get_position() == ref.get_position()


@pytest.mark.parametrize("ctor", [
    # reduced mode (the headline config class)
    (2, 64, 380, 44100, 48000, 0, IBL),
    # interpolated mode
    (1, 48, 48, 44100, 48000, 0, IB),
])
def test_precise_mode_semantics_and_consistency(ctor):
    """precise=True (f64-accumulated contraction dots, rounded once to
    f32 — the within-0.1-dB-of-C operating point, residue_window_dots
    docstring): counts/positions identical to the default engine, outputs
    at the f32 rounding floor of it, and sequential process() ==
    process_scan bitwise.  For the reduced mode the output is checked
    against an independent numpy float64 dot of the same f32 operands."""
    lcg = NoiseLCG()
    ch = ctor[0]
    G, n = 4, 4 * DeviceStreamResampler(*ctor).M
    xs = jnp.asarray(lcg.fill(G * ch * n).reshape(G, ch, n))
    a = DeviceStreamResampler(*ctor)                     # default
    p = DeviceStreamResampler(*ctor, precise=True)       # sequential
    q = DeviceStreamResampler(*ctor, precise=True)       # scanned
    for e in (a, p, q):
        e.advance_position(ctor[1] // 2)

    if not a.interp:
        # independent numpy f64 oracle for the first chunk's samples
        K, start, j0, _pos0, _plan = p._plan_compute(n)
        nb = -(-K // p.L)
        nb_rs = -(-nb // p.qn) * p.qn
        xlen = (nb_rs + p.qn) * p.M
        buf = np.concatenate([np.asarray(p.hist),
                              np.asarray(xs[0], np.float32)], axis=1)
        buf = np.concatenate(
            [buf, np.zeros((ch, xlen), np.float32)], axis=1)
        win = buf[:, start:start + xlen].astype(np.float64)
        P64 = np.asarray(p._matrix(j0)).astype(np.float64)
        KQ = p.qn * p.M
        cols = []
        for r in range(p.qn):
            Vr = win[:, r * p.M:r * p.M + (nb_rs // p.qn) * KQ] \
                .reshape(ch, nb_rs // p.qn, KQ)
            cols.append((Vr @ P64).astype(np.float32))
        oracle = np.stack(cols, axis=2).reshape(ch, nb_rs, p.L)
        oracle = oracle[:, :nb, :].reshape(ch, nb * p.L)[:, :K]

    outs_seq, Ks_seq = [], []
    for g in range(G):
        o, K = p.process(xs[g], n)
        outs_seq.append(np.asarray(o))
        Ks_seq.append(K)
        oa, Ka = a.process(xs[g], n)
        assert Ka == K
        # precise vs default: same products, wider accumulate — f32 floor
        assert float(jnp.max(jnp.abs(o - oa))) < 2e-6
    assert a.get_position() == p.get_position()

    if not a.interp:
        np.testing.assert_array_equal(outs_seq[0][:, :Ks_seq[0]], oracle)

    outs, Ks = q.process_scan(xs, n)
    assert list(Ks) == Ks_seq
    for g in range(G):
        K = Ks_seq[g]
        np.testing.assert_array_equal(np.asarray(outs[g])[:, :K],
                                      outs_seq[g][:, :K])
    np.testing.assert_array_equal(np.asarray(q.hist), np.asarray(p.hist))


@pytest.mark.parametrize("ctor", [
    # reduced mode (the headline config class)
    (2, 64, 380, 44100, 48000, 0, IBL),
    # interpolated mode, dyadic period (flat path engages)
    (1, 48, 48, 5000, 256000, 0, IB),
])
def test_int8_mode_accuracy_and_invariance(ctor):
    """precise='int8' (int8 fixed-point / Ozaki-split dots,
    ozaki_window_dots docstring): counts/positions identical to the
    default engine; outputs within ~1-2 f32 ulp of the f64-accumulate
    mode (both are single-rounding-floor schemes); and the
    flat/scan/flat_out group forms advance bitwise-identically to
    sequential process().  (The mode's round-trip accuracy is checked on
    the accelerator by chip_smoke.py; CPU agreement here is an invariance
    check of the shipped graphs, not the accuracy claim — CLAUDE.md
    EFT-on-CPU caveat.)"""
    lcg = NoiseLCG()
    ch = ctor[0]
    a = DeviceStreamResampler(*ctor)                      # default
    p = DeviceStreamResampler(*ctor, precise=True)        # f64acc
    q = DeviceStreamResampler(*ctor, precise="int8")      # sequential
    r = DeviceStreamResampler(*ctor, precise="int8")      # flat
    s = DeviceStreamResampler(*ctor, precise="int8")      # scan
    engs = (a, p, q, r, s)
    for e in engs:
        e.advance_position(ctor[1] // 2)
    G = 5
    n = max(8, -(-a.num_samples // (G * a.M)) + 1) * a.M
    xs = jnp.asarray(lcg.fill(G * ch * n).reshape(G, ch, n))
    first = jnp.asarray(lcg.fill(ch * n).reshape(ch, n))
    for e in engs:
        e.process(first, n)
    outs_q, Ks_q = [], []
    acc_q = jnp.zeros((), jnp.float32)
    for g in range(G):
        oa, Ka = a.process(xs[g], n)
        op, Kp = p.process(xs[g], n)
        oq, Kq, acc_q = q.process(xs[g], n, acc_q)
        assert Ka == Kp == Kq
        outs_q.append(np.asarray(oq)[:, :Kq])
        Ks_q.append(Kq)
        # single-rounding-floor schemes agree to ~1-2 ulp; both sit at
        # the f32 rounding floor of the default engine
        assert float(jnp.max(jnp.abs(oq - op))) < 3e-7
        assert float(jnp.max(jnp.abs(oq - oa))) < 2e-6
    assert a.get_position() == q.get_position()

    flat = jnp.concatenate([xs[g] for g in range(G)], axis=1)
    acc_r = jnp.zeros((), jnp.float32)
    Ks_r, acc_r = r.process_flat(flat, n, acc_r)
    assert list(Ks_r) == Ks_q
    np.testing.assert_array_equal(np.asarray(r.hist), np.asarray(q.hist))
    assert float(acc_r) == float(acc_q)

    acc_s = jnp.zeros((), jnp.float32)
    outs_s, Ks_s, acc_s = s.process_scan(xs, n, acc_s)
    assert list(Ks_s) == Ks_q
    for g in range(G):
        np.testing.assert_array_equal(
            np.asarray(outs_s[g])[:, :Ks_q[g]], outs_q[g])
    assert float(acc_s) == float(acc_q)

    # flat_out (the audio-delivering form the bench fidelity leg rides,
    # _stream_flat_out with precise="int8"): bitwise the sequential
    # engine's valid prefixes
    t = DeviceStreamResampler(*ctor, precise="int8")
    t.advance_position(ctor[1] // 2)
    t.process(first, n)
    out_t, Ks_t = t.process_flat_out(flat, n)
    assert list(Ks_t) == Ks_q
    np.testing.assert_array_equal(np.asarray(out_t),
                                  np.concatenate(outs_q, axis=1))
    np.testing.assert_array_equal(np.asarray(t.hist), np.asarray(q.hist))


def test_batched_stream_rows_bitwise_equal_single():
    """Serving N independent mono streams as engine ROWS (the
    small-config serving form, the bench's 'serving aggregate' record):
    each row's outputs are bitwise the 1-row engine's on the same
    stream — rows are independent in the block-Toeplitz contraction, so
    batching changes throughput, never samples."""
    ctor_n = (4, 48, 48, 44100, 48000, 0, IB)
    lcg = NoiseLCG()
    multi = DeviceStreamResampler(*ctor_n)
    singles = [DeviceStreamResampler(1, *ctor_n[1:]) for _ in range(4)]
    multi.advance_position(24)
    for s in singles:
        s.advance_position(24)
    n = 4 * multi.M
    for _ in range(3):
        x = jnp.asarray(lcg.fill(4 * n).reshape(4, n))
        om, Km = multi.process(x, n)
        for i, s in enumerate(singles):
            oi, Ki = s.process(x[i:i + 1], n)
            assert Ki == Km
            np.testing.assert_array_equal(np.asarray(oi)[0],
                                          np.asarray(om)[i])


def test_int8_mode_guards():
    from art_jax.parallel.sharding import make_mesh
    with pytest.raises(ValueError, match="f32"):
        DeviceStreamResampler(2, 64, 380, 44100, 48000, 0, IBL,
                              precise="int8", dtype=np.float64)
    with pytest.raises(NotImplementedError, match="single-shard"):
        DeviceStreamResampler(2, 64, 380, 44100, 48000, 0, IBL,
                              precise="int8", mesh=make_mesh(2, 1))


def test_int8_mode_mixed_plan_scan_fallback():
    """Non-periodic chunk sizes make per-chunk plans differ; the int8
    mode cannot ride the stacked-operand scans, so process_scan must
    fall back to sequential chunks with identical results and state."""
    ctor = (2, 64, 380, 44100, 48000, 0, IBL)
    lcg = NoiseLCG()
    a = DeviceStreamResampler(*ctor, precise="int8")
    b = DeviceStreamResampler(*ctor, precise="int8")
    a.advance_position(32)
    b.advance_position(32)
    G, n = 4, 1000                     # NOT an M-multiple: mixed plans
    xs = jnp.asarray(lcg.fill(G * 2 * n).reshape(G, 2, n))
    outs_a, Ks_a = [], []
    for g in range(G):
        o, K = a.process(xs[g], n)
        outs_a.append(np.asarray(o))
        Ks_a.append(K)
    outs_b, Ks_b = b.process_scan(xs, n)
    assert list(Ks_b) == Ks_a
    for g in range(G):
        K = Ks_a[g]
        np.testing.assert_array_equal(np.asarray(outs_b[g])[:, :K],
                                      outs_a[g][:, :K])
    np.testing.assert_array_equal(np.asarray(b.hist), np.asarray(a.hist))
    assert a.get_position() == b.get_position()


@pytest.mark.parametrize("config", ["reduced", "interp"])
def test_precise_mode_taps_sharded(config):
    """precise=True under TAPS sharding: each rank's contraction is only
    a partial K sum, so the f32 rounding must happen AFTER the psum
    (residue_window_dots defer_round — caught in review: rounding the
    partials re-introduced the f32 accumulation the mode exists to
    avoid).  Sharded-precise must sit at the f32 rounding floor of
    single-device-precise (not the looser default-dot floor), with
    counts exact."""
    from art_jax.core.flags import NO_FILTER_REDUCTION
    from art_jax.parallel.sharding import make_mesh

    if config == "reduced":
        ctor = (2, 380, 380, 44100, 48000, 0, IBL)
    else:
        ctor = (2, 48, 48, 44100, 48000, 0,
                SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
                | NO_FILTER_REDUCTION)
    e1 = DeviceStreamResampler(*ctor, precise=True)
    e2 = DeviceStreamResampler(*ctor, precise=True, mesh=make_mesh(2, 4))
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 4096)).astype(np.float32)
                    * 0.25)
    a1 = jnp.zeros((), jnp.float32)
    a2 = jnp.zeros((), jnp.float32)
    for _ in range(3):
        o1, K1, a1 = e1.process(x, 4096, a1)
        o2, K2, a2 = e2.process(x, 4096, a2)
        assert K1 == K2
        v1 = np.asarray(o1)[:, :K1]
        v2 = np.asarray(o2)[:2, :K1]
        # both sides round ONE f64-accumulated sum to f32, so they agree
        # bitwise except for astronomically rare f64-reassociation ties
        # at an f32 rounding boundary (measured 0 mismatches); the old
        # round-partials-then-psum behavior flips the low bit on ~36% of
        # samples — this fraction is the discriminating signal
        assert (v1 != v2).mean() < 0.01, (v1 != v2).mean()
