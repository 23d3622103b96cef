"""Batched drifting-ratio ASRC tests (BASELINE config 5)."""

import numpy as np
import pytest
import jax.numpy as jnp

from art_jax.core.flags import BLACKMAN_HARRIS, SUBSAMPLE_INTERPOLATE
from art_jax.engines.resampler import Resampler
from art_jax.parallel.asrc import BatchedASRC
from art_jax.utils.testsig import NoiseLCG

# float64 engine vs float64 host engine: identical positions, phases and
# fractions; the windowed dot sums the same products in another order, so
# samples (|x| < ~4) differ by a few ulps of the running sum
F64_TOL = 1e-12


def test_batched_asrc_matches_per_stream_engines():
    S, taps, filters = 8, 48, 64
    rng = np.random.default_rng(0)
    lcg = NoiseLCG()
    b = BatchedASRC(S, taps, filters)
    b.advance_position(24.0)
    singles = []
    for _ in range(S):
        r = Resampler(1, taps, filters, 0.0,
                      SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS,
                      backend="numpy")
        r.advance_position(24.0)
        singles.append(r)
    md = 0.0
    for _ in range(6):
        x = lcg.fill(S * 512).reshape(S, 512)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        out, Ks = b.process(jnp.asarray(x), ratios)
        out = np.asarray(out)
        for s in range(S):
            ho, res = singles[s].process(x[s:s + 1], 512, 2000,
                                         float(ratios[s]))
            assert res.input_used == 512
            assert res.output_generated == Ks[s]
            md = max(md, float(np.abs(ho[0] - out[s, :Ks[s]]).max()))
            assert abs(b.get_position()[s]
                       - singles[s].get_position()) < 1e-9
    assert md < 1e-6


def test_batched_asrc_per_stream_independent_ratios():
    """Streams with different ratios produce different output counts, and
    position drift tracks the cumulative ratio per stream."""
    S = 4
    b = BatchedASRC(S, 48, 64)
    b.advance_position(24.0)
    lcg = NoiseLCG()
    ratios = np.array([0.98, 1.0, 1.02, 1.005])
    total = np.zeros(S, dtype=np.int64)
    for _ in range(10):
        x = lcg.fill(S * 512).reshape(S, 512)
        out, Ks = b.process(jnp.asarray(x), ratios)
        total += Ks
    expect = 10 * 512 * ratios
    assert np.all(np.abs(total - expect) < 30)
    pos = b.get_position()
    assert np.all(np.isfinite(pos)) and np.all(np.abs(pos) < 513)


def test_batched_asrc_sharded_over_mesh():
    """Streams shard across a device mesh with identical results (the
    scale-out story for BASELINE config 5)."""
    import jax
    from art_jax.parallel.sharding import make_mesh
    mesh = make_mesh(8, 1)
    # make_mesh names axes (streams, taps); BatchedASRC shards on "streams"
    lcg = NoiseLCG()
    rng = np.random.default_rng(0)
    a = BatchedASRC(16, 48, 64, mesh=mesh)
    b = BatchedASRC(16, 48, 64)
    a.advance_position(24.0)
    b.advance_position(24.0)
    for _ in range(3):
        x = lcg.fill(16 * 512).reshape(16, 512)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, 16)
        oa, Ka = a.process(jnp.asarray(x), ratios)
        ob, Kb = b.process(jnp.asarray(x), ratios)
        assert np.array_equal(Ka, Kb)
        np.testing.assert_allclose(np.asarray(oa), np.asarray(ob), atol=1e-6)
    assert len(a.hist.sharding.device_set) == 8


def test_batched_asrc_phase_query_contract():
    """Negative position => an output is ready without more input
    (reference resampler.c:950-963)."""
    b = BatchedASRC(2, 48, 64)
    np.testing.assert_allclose(b.get_position(), 0.0, atol=0)
    b.advance_position(np.array([24.0, 10.0]))
    np.testing.assert_allclose(b.get_position(), [24.0, 10.0])
    x = np.ones((2, 100), np.float32)
    out, Ks = b.process(jnp.asarray(x), np.array([1.0, 1.0]))
    pos = b.get_position()
    np.testing.assert_allclose(pos, [24.0, 10.0] + Ks - 100.0, atol=1e-12)


def test_batched_asrc_checkpoint_resume():
    """state_dict/load_state round-trip mid-stream: a resumed engine
    continues bit-identically (the SURVEY checkpoint/resume contract)."""
    lcg = NoiseLCG()
    rng = np.random.default_rng(4)
    a = BatchedASRC(8, 48, 64)
    a.advance_position(24.0)
    for _ in range(3):
        x = lcg.fill(8 * 512).reshape(8, 512)
        a.process(jnp.asarray(x), 1.0 + rng.uniform(-0.01, 0.01, 8))
    snap = a.state_dict()
    x = lcg.fill(8 * 512).reshape(8, 512)
    ratios = 1.0 + rng.uniform(-0.01, 0.01, 8)
    o1, K1 = a.process(jnp.asarray(x), ratios)

    b = BatchedASRC(8, 48, 64)
    b.load_state(snap)
    o2, K2 = b.process(jnp.asarray(x), ratios)
    assert np.array_equal(K1, K2)
    assert np.array_equal(np.asarray(o1), np.asarray(o2))
    assert np.array_equal(a.get_position(), b.get_position())


def test_batched_asrc_dense_sharded_matches_single_device():
    """The step runs under shard_map (one instance per device on its local
    block of 8 streams); results match the single-device engine and shards
    stay distributed."""
    from art_jax.parallel.sharding import make_mesh
    mesh = make_mesh(8, 1)
    lcg = NoiseLCG()
    rng = np.random.default_rng(8)
    S = 64                              # 8 local streams per device
    a = BatchedASRC(S, 48, 64, mesh=mesh)
    b = BatchedASRC(S, 48, 64)
    a.advance_position(24.0)
    b.advance_position(24.0)
    for _ in range(3):
        x = lcg.fill(S * 512).reshape(S, 512)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        oa, Ka = a.process(jnp.asarray(x), ratios)
        ob, Kb = b.process(jnp.asarray(x), ratios)
        assert np.array_equal(Ka, Kb)
        np.testing.assert_allclose(np.asarray(oa), np.asarray(ob),
                                   atol=1e-6)
    assert len(a.hist.sharding.device_set) == 8


def test_batched_asrc_chunk_size_invariance():
    """Processing the same streams in different chunkings produces the
    same audio within the float accounting floor (the reference's
    chunk-size-invariance design requirement, README.md:120-123, applied
    to the batched engine; per-call offsets re-accumulate exactly like the
    C context, so positions agree to sub-ulp, not bitwise)."""
    lcg = NoiseLCG()
    S = 8
    x = lcg.fill(S * 4096).reshape(S, 4096)
    ratios = 1.0 + 0.005 * np.sin(np.arange(S))

    def run(chunks):
        eng = BatchedASRC(S, 48, 64)
        eng.advance_position(24.0)
        outs = []
        at = 0
        for c in chunks:
            o, Ks = eng.process(jnp.asarray(x[:, at:at + c]), ratios)
            at += c
            assert (Ks == Ks[0]).all() or True
            outs.append((np.asarray(o), np.asarray(Ks)))
        return outs

    a = run([4096])
    b = run([512] * 8)
    c = run([1024, 2048, 1024])
    cat = {}
    for name, outs in (("a", a), ("b", b), ("c", c)):
        per_stream = []
        for s in range(S):
            per_stream.append(np.concatenate(
                [o[s, :K[s]] for o, K in outs]))
        cat[name] = per_stream
    for s in range(S):
        n = min(len(cat["a"][s]), len(cat["b"][s]), len(cat["c"][s]))
        assert abs(len(cat["a"][s]) - len(cat["b"][s])) <= 1
        assert abs(len(cat["a"][s]) - len(cat["c"][s])) <= 1
        assert np.abs(cat["a"][s][:n] - cat["b"][s][:n]).max() < 1e-6
        assert np.abs(cat["a"][s][:n] - cat["c"][s][:n]).max() < 1e-6


def test_asrc_step_compilation_stable_under_drifting_ratios():
    """Per-call ratio drift must not grow the jit cache: the output
    capacity is bucketed to the step tile, so the compiled step is reused
    (unbucketed k_max recompiles per distinct max ratio)."""
    from art_jax.parallel.asrc import _asrc_step
    rng = np.random.default_rng(0)
    eng = BatchedASRC(8, 48, 64)
    eng.advance_position(24.0)
    x = jnp.asarray(rng.standard_normal((8, 512)).astype(np.float32))
    eng.process(x, 1.0 + 0.003 * np.arange(8))
    base = _asrc_step._cache_size()
    for it in range(5):
        ratios = 1.0 + 0.01 * np.sin(np.arange(8) + it * 0.7)
        eng.process(x, ratios)
    assert _asrc_step._cache_size() == base


def test_batched_asrc_kernel_chain_matches_host_oracle():
    """Ratio regimes from tight drift around 1.0 through wide drift,
    halving and 5x decimation, in one engine: every call must match the
    per-stream host engine in counts, samples and positions."""
    S, taps, filters = 8, 48, 64
    lcg = NoiseLCG()
    b = BatchedASRC(S, taps, filters)
    b.advance_position(24.0)
    singles = []
    for _ in range(S):
        r = Resampler(1, taps, filters, 0.0,
                      SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS,
                      backend="numpy")
        r.advance_position(24.0)
        singles.append(r)
    legs = [
        1.0 + 0.0005 * np.arange(S),          # tight drift
        1.0 / (1.0 + 0.15 * np.sin(np.arange(S) + 1.0)),  # wide drift
        np.full(S, 0.5) + 0.01 * np.arange(S),  # about an octave down
        np.full(S, 0.2),                      # 5x decimation
        1.0 - 0.0005 * np.arange(S),          # back to tight drift
    ]
    for ratios in legs:
        x = lcg.fill(S * 512).reshape(S, 512)
        out, Ks = b.process(jnp.asarray(x), ratios)
        out = np.asarray(out)
        for s in range(S):
            ho, res = singles[s].process(x[s:s + 1], 512, 4000,
                                         float(ratios[s]))
            assert res.output_generated == Ks[s]
            assert np.abs(ho[0] - out[s, :Ks[s]]).max() < 1e-6
            assert abs(b.get_position()[s]
                       - singles[s].get_position()) < 1e-9


def test_asrc_hankel_compilation_stable_under_drifting_ratios():
    """The float64 engine's capacity buckets like the float32 one: a
    drifting-ratio serving loop must reuse one compiled specialization."""
    from art_jax.parallel.asrc import _asrc_step
    rng = np.random.default_rng(0)
    eng = BatchedASRC(8, 48, 64, dtype=np.float64)
    eng.advance_position(24.0)
    x = jnp.asarray(rng.standard_normal((8, 512)))
    eng.process(x, 1.0 + 0.003 * np.arange(8))
    base = _asrc_step._cache_size()
    for it in range(5):
        ratios = 1.0 + 0.01 * np.sin(np.arange(8) + it * 0.7)
        eng.process(x, ratios)
    assert _asrc_step._cache_size() == base


def test_batched_asrc_staggered_flush_matches_host_engines():
    """Per-stream flush/teardown (reference postfill + FLUSHED latch,
    resampler.c:663-698, 438-439): streams end at staggered times; each
    flushed stream's final outputs, counts, and frozen phase position
    equal an independent host engine flushed at the same point, while
    live streams keep serving unperturbed."""
    S, taps, filters = 8, 48, 64
    lcg = NoiseLCG()
    rng = np.random.default_rng(3)
    b = BatchedASRC(S, taps, filters)
    b.advance_position(24.0)
    singles = []
    for _ in range(S):
        r = Resampler(1, taps, filters, 0.0,
                      SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS,
                      backend="numpy")
        r.advance_position(24.0)
        singles.append(r)

    # end two streams after every other chunk
    flush_at = {1: [6, 3], 3: [0, 2], 5: [4, 7], 7: [1, 5]}
    ended = set()
    for t in range(8):
        x = lcg.fill(S * 512).reshape(S, 512)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        out, Ks = b.process(jnp.asarray(x), ratios)
        out = np.asarray(out)
        for s in range(S):
            if s in ended:
                assert Ks[s] == 0
                assert not np.any(out[s])
                continue
            ho, res = singles[s].process(x[s:s + 1], 512, 2000,
                                         float(ratios[s]))
            assert res.output_generated == Ks[s]
            assert np.abs(ho[0] - out[s, :Ks[s]]).max() < 1e-6
        if t in flush_at:
            fmask = np.zeros(S, bool)
            fmask[flush_at[t]] = True
            fr = 1.0 + rng.uniform(-0.01, 0.01, S)
            fout, fKs = b.flush(fr, fmask)
            fout = np.asarray(fout)
            for s in range(S):
                if not fmask[s]:
                    assert fKs[s] == 0
                    continue
                ho, res = singles[s].process(None, -1, 2000, float(fr[s]))
                assert res.output_generated == fKs[s]
                assert np.abs(ho[0] - fout[s, :fKs[s]]).max() < 1e-6
                ended.add(s)
        # flushed positions frozen and equal to the host engines'
        pos = b.get_position()
        for s in ended:
            assert pos[s] == singles[s].get_position()

    # double-flush is a no-op; all streams end cleanly
    fout, fKs = b.flush(np.ones(S), np.ones(S, bool))
    for s in range(S):
        if s in ended:
            assert fKs[s] == 0
        else:
            ho, res = singles[s].process(None, -1, 2000, 1.0)
            assert res.output_generated == fKs[s]
    assert b.flushed.all()


def test_batched_asrc_f64_ds_kernel_matches_host():
    """The f64 engine (native float64 positions and dots): counts and
    positions exact vs per-stream f64 host engines, samples at the f64
    floor (F64_TOL: only the summation order over taps differs)."""
    S, taps, filters = 8, 48, 64
    lcg = NoiseLCG()
    rng = np.random.default_rng(5)
    b = BatchedASRC(S, taps, filters, dtype=np.float64)
    b.advance_position(24.0)
    singles = []
    for _ in range(S):
        r = Resampler(1, taps, filters, 0.0,
                      SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS,
                      backend="numpy", dtype=np.float64)
        r.advance_position(24.0)
        singles.append(r)
    for _ in range(4):
        x = lcg.fill(S * 512).reshape(S, 512).astype(np.float64)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        out, Ks = b.process(jnp.asarray(x), ratios)
        out = np.asarray(out)
        for s in range(S):
            ho, res = singles[s].process(x[s:s + 1], 512, 2000,
                                         float(ratios[s]))
            assert res.output_generated == Ks[s]
            assert np.abs(ho[0] - out[s, :Ks[s]]).max() < F64_TOL
            assert b.get_position()[s] == singles[s].get_position()


def test_batched_asrc_f64_ds_sharded_matches_single_device():
    """The f64 step under shard_map (one instance per device on its local
    stream block): results equal to the single-device f64 engine at the
    f64 floor over the virtual 8-device mesh."""
    from art_jax.parallel.sharding import make_mesh
    mesh = make_mesh(8, 1)
    lcg = NoiseLCG()
    rng = np.random.default_rng(12)
    S = 64
    a = BatchedASRC(S, 48, 64, dtype=np.float64, mesh=mesh)
    b = BatchedASRC(S, 48, 64, dtype=np.float64)
    a.advance_position(24.0)
    b.advance_position(24.0)
    for _ in range(3):
        x = lcg.fill(S * 512).reshape(S, 512).astype(np.float64)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        oa, Ka = a.process(jnp.asarray(x), ratios)
        ob, Kb = b.process(jnp.asarray(x), ratios)
        assert np.array_equal(Ka, Kb)
        np.testing.assert_allclose(np.asarray(oa), np.asarray(ob),
                                   atol=F64_TOL)
    assert len(a.hist.sharding.device_set) == 8


def test_batched_asrc_f64_flush_matches_host_engines():
    """Per-stream flush on the f64 engine: counts and frozen positions
    exact vs host f64 engines; samples at the f64 floor."""
    S, taps, filters = 8, 48, 64
    lcg = NoiseLCG()
    rng = np.random.default_rng(11)
    b = BatchedASRC(S, taps, filters, dtype=np.float64)
    b.advance_position(24.0)
    singles = []
    for _ in range(S):
        r = Resampler(1, taps, filters, 0.0,
                      SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS,
                      backend="numpy", dtype=np.float64)
        r.advance_position(24.0)
        singles.append(r)
    for _ in range(3):
        x = lcg.fill(S * 512).reshape(S, 512).astype(np.float64)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        out, Ks = b.process(jnp.asarray(x), ratios)
        for s in range(S):
            ho, res = singles[s].process(x[s:s + 1], 512, 2000,
                                         float(ratios[s]))
            assert res.output_generated == Ks[s]
    fr = 1.0 + rng.uniform(-0.01, 0.01, S)
    fmask = np.zeros(S, bool)
    fmask[[1, 4, 6]] = True
    fout, fKs = b.flush(fr, fmask)
    fout = np.asarray(fout)
    pos = b.get_position()
    for s in range(S):
        if not fmask[s]:
            assert fKs[s] == 0
            continue
        ho, res = singles[s].process(None, -1, 2000, float(fr[s]))
        assert res.output_generated == fKs[s]
        assert np.abs(ho[0] - fout[s, :fKs[s]]).max() < F64_TOL
        assert pos[s] == singles[s].get_position()


def test_asrc_slide_tie_boundary_counts():
    """Fuzz seed 5113's float64 rounding tie, ASRC form: on the second
    call the emission boundary compare differs between entry and slid
    ring coordinates (the reference re-rounds fl(outputOffset + offset2)
    after each mid-call ring slide, resampler.c:500-501).  The batched
    engine's O(S) count bracket must evaluate the ring-exact compare
    (BatchedASRC._ring_ok) — the entry-coordinate form emitted 1394
    instead of 1395 here.  Counts and positions vs the host engine
    (itself golden-tested on this config) must match exactly."""
    from art_jax.utils.testsig import NoiseLCG

    taps, filters = 88, 67
    ratio = 48000 / 44100
    b = BatchedASRC(8, taps, filters)
    b.advance_position(taps // 2 + 26.25)
    r = Resampler(1, taps, filters, 0.0,
                  SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS, backend="numpy")
    r.advance_position(taps // 2 + 26.25)
    lcg = NoiseLCG()
    seenK = []
    for t in range(3):
        x = lcg.fill(1281).reshape(1, 1281)
        xs = np.ascontiguousarray(np.broadcast_to(x, (8, 1281)))
        out, Ks = b.process(jnp.asarray(xs), np.full(8, ratio))
        ho, res = r.process(x, 1281, 4000, ratio)
        assert int(Ks[0]) == res.output_generated, (t, Ks[0])
        assert (Ks == Ks[0]).all()
        assert (b.get_position() == r.get_position()).all()
        seenK.append(res.output_generated)
    assert seenK[1] == 1395      # the tie call (1394 = regression)


def test_asrc_exactly_full_requested_capacity_ok():
    """Ks.max() == req_k_max exactly fills the requested capacity — the
    host count is exact (only padded-capacity saturation is ambiguous),
    so this must succeed, and one more output must raise."""
    b = BatchedASRC(4, 48, 48)
    b.advance_position(24)
    x = jnp.asarray(np.zeros((4, 500), np.float32))
    r = np.full(4, 1.0)
    out, Ks = b.process(x, r, k_max=1000)      # prime past startup latency
    out, Ks = b.process(x, r, k_max=1000)
    steady = int(Ks.max())
    assert steady > 0
    out, Ks = b.process(x, r, k_max=steady)    # exactly full: legal
    assert int(Ks.max()) == steady and out.shape[1] == steady
    with pytest.raises(ValueError):
        b.process(x, r, k_max=steady - 1)

    # flush: same rule
    b2 = BatchedASRC(4, 48, 48)
    b2.advance_position(24)
    b2.process(x, r)
    probe = BatchedASRC(4, 48, 48)
    probe.advance_position(24)
    probe.process(x, r)
    _, fKs = probe.flush(r)
    need = int(fKs.max())
    out, Ks = b2.flush(r, k_max=need)          # exactly full: legal
    assert int(Ks.max()) == need


def test_asrc_latched_stream_ratio_is_inert():
    """A flushed (latched) stream's caller-supplied ratio must not inflate
    the auto capacity estimate: the stale value is dead weight (its Ks is
    forced to 0 and its position frozen).  Before the fix,
    ratios[flushed]=50 ballooned k_max ~50x (every call a fresh compile
    bucket)."""
    S, taps, filters = 4, 48, 48
    lcg = NoiseLCG()
    b = BatchedASRC(S, taps, filters)
    b.advance_position(24.0)
    x = lcg.fill(S * 512).reshape(S, 512)
    out0, _ = b.process(jnp.asarray(x), np.full(S, 1.001))
    width0 = out0.shape[1]

    mask = np.zeros(S, bool)
    mask[0] = True
    b.flush(np.ones(S), mask=mask)

    ref = BatchedASRC(S, taps, filters)
    ref.advance_position(24.0)
    ref.process(jnp.asarray(x), np.full(S, 1.001))
    rmask = np.zeros(S, bool)
    rmask[0] = True
    ref.flush(np.ones(S), mask=rmask)

    ratios = np.full(S, 1.001)
    bad = ratios.copy()
    bad[0] = 50.0                      # stale garbage for the dead stream
    x2 = lcg.fill(S * 512).reshape(S, 512)
    out_bad, Ks_bad = b.process(jnp.asarray(x2), bad)
    out_ref, Ks_ref = ref.process(jnp.asarray(x2), ratios)
    assert out_bad.shape[1] == out_ref.shape[1] == width0
    assert int(Ks_bad[0]) == 0
    np.testing.assert_array_equal(np.asarray(Ks_bad), np.asarray(Ks_ref))
    np.testing.assert_array_equal(np.asarray(out_bad), np.asarray(out_ref))
    np.testing.assert_array_equal(b.get_position(), ref.get_position())

    # flush: a masked-out stream's garbage ratio is equally inert
    fbad = np.full(S, 50.0)
    fmask = np.zeros(S, bool)
    fmask[1] = True
    fbad[1] = 1.001
    fout, fKs = b.flush(fbad, mask=fmask)
    rout, rKs = ref.flush(np.where(fmask, 1.001, 1.0), mask=fmask)
    assert fout.shape[1] == rout.shape[1]
    np.testing.assert_array_equal(np.asarray(fKs), np.asarray(rKs))
    np.testing.assert_array_equal(np.asarray(fout), np.asarray(rout))


def test_asrc_flush_nothing_to_emit_skips_dispatch():
    """flush() with an all-masked-out (or all-latched) batch must not
    dispatch a device step: an unseen k_max bucket would pay a compile
    for zeros.  The output is all-zero with Ks == 0, shaped to
    req_k_max when one is given."""
    S = 4
    b = BatchedASRC(S, 48, 48)
    b.advance_position(24.0)
    x = jnp.asarray(np.zeros((S, 256), np.float32))
    b.process(x, np.ones(S))

    calls = []
    orig = b._run_step
    b._run_step = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]

    fout, fKs = b.flush(np.ones(S), mask=np.zeros(S, bool))
    assert not calls                       # no device dispatch
    assert int(np.asarray(fKs).max()) == 0
    assert not np.asarray(fout).any()

    fout, fKs = b.flush(np.ones(S), mask=np.zeros(S, bool), k_max=37)
    assert not calls
    assert fout.shape == (S, 37)

    # all streams already latched: same fast path
    b.flush(np.ones(S))                    # real flush (dispatches)
    assert len(calls) == 1
    fout, fKs = b.flush(np.ones(S))
    assert len(calls) == 1 and int(np.asarray(fKs).max()) == 0


def test_asrc_stream_adapter_matches_host_engine():
    """ASRCStreamResampler (the artest --backend=device runtime-ratio
    path): counts/positions exact vs the host
    interpolated engine across drifting-ratio chunks of varying size,
    samples at the f32 kernel floor, flush counts exact, and the engine
    surface (queries, planar form) matches the host contract."""
    from art_jax.parallel.asrc import ASRCStreamResampler

    rng = np.random.default_rng(5)
    ch, taps, filters = 2, 64, 128
    IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
    host = Resampler(ch, taps, filters, 0.0, IB, backend="numpy")
    dev = ASRCStreamResampler(ch, taps, filters, 0.0, IB)
    host.advance_position(taps / 2)
    dev.advance_position(taps / 2)
    assert dev.get_num_filters() == host.get_num_filters()
    assert dev.interpolation_used() == 1
    assert dev.get_lowpass_ratio() == host.get_lowpass_ratio()
    ratio = 48000 / 44100
    mx = 0.0
    for i in range(10):
        n = 1000 + (i % 3) * 137
        r = ratio * (1.0 + 0.003 * np.sin(i))
        data = (rng.standard_normal((n, ch)) * 0.25).astype(np.float32)
        cap = int(n * r) + taps + 16
        if i % 4 == 3:                       # exercise the planar form
            oh, rh = host.process(
                np.ascontiguousarray(data.T), n, cap, r)
            od, rd = dev.process(np.ascontiguousarray(data.T), n, cap, r)
            oh, od = oh.T, od.T
        else:
            oh, rh = host.process_interleaved(data, n, cap, r)
            od, rd = dev.process_interleaved(data, n, cap, r)
        assert (rh.input_used, rh.output_generated) \
            == (rd.input_used, rd.output_generated), i
        assert host.get_position() == dev.get_position(), i
        K = rh.output_generated
        mx = max(mx, float(np.abs(np.asarray(oh)[:K]
                                  - np.asarray(od)[:K]).max()))
    assert mx < 5e-7                          # f32 kernel class
    fd = (rng.standard_normal((500, ch)) * 0.25).astype(np.float32)
    oh, rh = host.process_and_flush_interleaved(fd, 500, 2000, ratio)
    od, rd = dev.process_and_flush_interleaved(fd, 500, 2000, ratio)
    assert rh.output_generated == rd.output_generated
    K = rh.output_generated
    assert float(np.abs(np.asarray(oh)[:K]
                        - np.asarray(od)[:K]).max()) < 5e-7
    # FLUSHED latch: later input emits nothing
    od2, rd2 = dev.process_interleaved(fd, 500, 2000, ratio)
    assert rd2.output_generated == 0


def test_asrc_stream_adapter_guards():
    from art_jax.core.flags import EXTRAPOLATE_ENDPOINTS
    from art_jax.parallel.asrc import ASRCStreamResampler
    with pytest.raises(ValueError, match="SUBSAMPLE_INTERPOLATE"):
        ASRCStreamResampler(2, 64, 128, 0.0, BLACKMAN_HARRIS)
    with pytest.raises(ValueError, match="EXTRAPOLATE"):
        ASRCStreamResampler(
            2, 64, 128, 0.0,
            SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | EXTRAPOLATE_ENDPOINTS)
    eng = ASRCStreamResampler(2, 64, 128, 0.0,
                              SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS)
    with pytest.raises(ValueError, match="positive per-call ratio"):
        eng.process_interleaved(np.zeros((16, 2), np.float32), 16, 64, 0.0)


def test_batched_asrc_lowpass_ratio_bank():
    """lowpass_ratio folds into the ASRC bank exactly like the fixed
    engines (reference resampler.c:1111): a lowpassed BatchedASRC
    matches a lowpassed host engine at the same ratio."""
    from art_jax.parallel.asrc import ASRCStreamResampler

    ch, taps, filters = 1, 48, 64
    IBL = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
    lp = 0.7
    host = Resampler(ch, taps, filters, lp, IBL, backend="numpy")
    dev = ASRCStreamResampler(ch, taps, filters, lp, IBL)
    host.advance_position(taps / 2)
    dev.advance_position(taps / 2)
    lcg = NoiseLCG()
    data = lcg.fill(2048).reshape(2048, 1)
    r = 44100 / 48000
    oh, rh = host.process_interleaved(data, 2048, 4096, r)
    od, rd = dev.process_interleaved(data, 2048, 4096, r)
    assert rh.output_generated == rd.output_generated
    K = rh.output_generated
    assert float(np.abs(np.asarray(oh)[:K]
                        - np.asarray(od)[:K]).max()) < 5e-7
