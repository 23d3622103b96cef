"""Fused device pipeline: quantization bit-exactness vs the host decimator,
ragged-chunk state advance, and sharded == single-device on the production
step (virtual 8-device CPU mesh via conftest)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from art_jax.core.flags import (DITHER_FLAT, DITHER_HIGHPASS, DITHER_LOWPASS,
                                SHAPING_2ND_ORDER, SHAPING_ATH_CURVE)
from art_jax.engines.decimator import Decimator
from art_jax.ops import decimate_device as dd
from art_jax.ops import decimate_kernel as dk


def _device_quantize(x, dec: Decimator, K=None):
    """Run the device quantize stages with a fresh state matching ``dec``'s
    initial state; returns (packed bytes, clips, state tuple)."""
    n, S = x.shape
    K = n if K is None else K
    gens = jnp.asarray(dec.tpdf_generators if dec.tpdf_generators is not None
                       else np.zeros(S, np.uint32))
    dither = None
    new_gens = gens
    if dec.tpdf_generators is not None:
        A, V0, V1 = (jnp.asarray(t) for t in dd.dither_tables(n))
        d, seq = dd.tpdf_dither_dev(gens, A, V0, V1, dec.dither_type, n)
        new_gens = dd.advance_states(gens, seq, jnp.int32(K))
        dither = d.T                                        # [n, S]
    fb = jnp.asarray(dec.feedback)
    xs = jnp.asarray(x)
    if dec.noise_shaper is not None:
        sh = dec.noise_shaper
        outv, clipf, fb, xh, yh = dd.quantize_shaped_dev(
            xs, dither, dec.scaler, fb, sh.a, sh.b, jnp.asarray(sh.xh),
            jnp.asarray(sh.yh), jnp.int32(K), dec.highclip, dec.lowclip)
        state = (np.asarray(new_gens), np.asarray(fb), np.asarray(xh),
                 np.asarray(yh))
    else:
        outv, clipf = dd.quantize_flat_dev(xs, dither, dec.scaler, fb,
                                           dec.highclip, dec.lowclip)
        kmask = jnp.arange(n)[:, None] < K
        outv = jnp.where(kmask, outv, 0)
        clipf = clipf & kmask
        state = (np.asarray(new_gens), np.asarray(fb), None, None)
    packed = dd.pack_bytes_dev(outv, dec.output_bits, dec.output_bytes)
    return (np.asarray(packed)[:K], int(jnp.sum(clipf)), state)


@pytest.mark.parametrize("bits,flags", [
    (16, DITHER_HIGHPASS | SHAPING_ATH_CURVE),   # the ART CLI default
    (16, DITHER_FLAT | SHAPING_2ND_ORDER),
    (8, DITHER_LOWPASS),
    (24, SHAPING_ATH_CURVE),
    (16, 0),
])
def test_device_quantize_bitexact_vs_host(bits, flags):
    rng = np.random.default_rng(7)
    n, S = 700, 3
    x = np.clip(rng.standard_normal((n, S)) * 0.6, -1.2, 1.2) \
        .astype(np.float32)
    host = Decimator(S, bits, (bits + 7) // 8, 1.0, 44100, flags,
                     backend="numpy")
    dev = Decimator(S, bits, (bits + 7) // 8, 1.0, 44100, flags,
                    backend="numpy")
    packed_h, clips_h = host.process_interleaved(x)
    packed_d, clips_d, _ = _device_quantize(x, dev)
    assert clips_d == clips_h
    np.testing.assert_array_equal(packed_d, np.asarray(packed_h))


def test_device_quantize_ragged_chunks_freeze_state():
    """Padded chunks (rows beyond K are garbage) must advance LCG, feedback
    and shaper state by exactly K samples — two ragged device chunks equal
    one host run over the concatenated valid samples."""
    rng = np.random.default_rng(11)
    flags = DITHER_HIGHPASS | SHAPING_ATH_CURVE
    S, bits = 2, 16
    k1, k2, pad = 333, 250, 77
    x1 = rng.standard_normal((k1 + pad, S)).astype(np.float32) * 0.5
    x2 = rng.standard_normal((k2 + pad, S)).astype(np.float32) * 0.5
    x1[k1:] = np.nan          # beyond-K rows must be fully ignored
    x2[k2:] = np.nan

    host = Decimator(S, bits, 2, 1.0, 48000, flags, backend="numpy")
    full = np.concatenate([x1[:k1], x2[:k2]], axis=0)
    packed_h, clips_h = host.process_interleaved(full)

    dev = Decimator(S, bits, 2, 1.0, 48000, flags, backend="numpy")
    p1, c1, (gens, fb, xh, yh) = _device_quantize(x1, dev, K=k1)
    dev.tpdf_generators = gens
    dev.feedback = fb
    dev.noise_shaper.xh = xh.astype(dev.noise_shaper.xh.dtype)
    dev.noise_shaper.yh = yh.astype(dev.noise_shaper.yh.dtype)
    p2, c2, _ = _device_quantize(x2, dev, K=k2)
    np.testing.assert_array_equal(np.concatenate([p1, p2]),
                                  np.asarray(packed_h))
    assert c1 + c2 == clips_h


def _tiny_sharded_inputs(S, nK, hist_len, chunk, dtype=np.float32):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, chunk)).astype(dtype) * 0.5
    hist = np.zeros((S, hist_len), dtype)
    gens = dk.seed_generators(S)
    fb = np.zeros(S, dtype)
    xh = np.zeros((4, S), dtype)
    yh = np.zeros((4, S), dtype)
    A, V0, V1 = dd.dither_tables(nK)
    return x, hist, gens, fb, xh, yh, A, V0, V1


def test_sharded_production_step_matches_single_device():
    """The full production chunk (resample + dithered shaped quantize +
    pack) sharded over a (streams x taps) mesh vs a 1x1 mesh: counts and
    packed bytes bit-equal for a summation-order-invariant phase matrix,
    resampled floats at the f32 floor in general."""
    from art_jax.parallel.pipeline import make_sharded_step, pad_phase_matrix
    from art_jax.parallel.sharding import make_mesh
    from art_jax.engines.decimator import Decimator as D

    M, L, nb, qn, hist_len = 3, 2, 16, 4, 32
    nK = nb * L
    S, chunk = 8, nb * M
    dec = D(S, 16, 2, 1.0, 44100, DITHER_HIGHPASS | SHAPING_ATH_CURVE)
    sh = dec.noise_shaper

    # one-hot passthrough phase rows: the taps-parallel psum then sums one
    # nonzero against zeros, so the resample stage is bit-exact on every
    # mesh shape and the packed bytes must match exactly
    Pq = np.zeros((qn * M, L), np.float32)
    Pq[2, 0] = 1.0
    Pq[5, 1] = 1.0

    kw = dict(M=M, L=L, nb=nb, qn=qn, hist_len=hist_len, scaler=32768.0,
              highclip=32767, lowclip=-32768, dither_type=-1,
              shaper_a=sh.a, shaper_b=sh.b, output_bits=16, output_bytes=2)
    x, hist, gens, fb, xh, yh, A, V0, V1 = _tiny_sharded_inputs(
        S, nK, hist_len, chunk)
    args0 = (np.int32(8), np.int32(nK), gens, fb, xh, yh, A, V0, V1)

    results = []
    for mesh_shape in [(1, 1), (4, 2), (8, 1), (2, 4)]:
        mesh = make_mesh(*mesh_shape)
        ntap = mesh_shape[1]
        qn_pad = -(-qn // ntap) * ntap
        step = make_sharded_step(mesh, **kw)
        Pp = pad_phase_matrix(Pq, M, L, qn, qn_pad, np.float32)
        out = step(x, hist, Pp, *args0)
        results.append(tuple(np.asarray(o) for o in out))

    ref = results[0]
    for got in results[1:]:
        for i, (r, g) in enumerate(zip(ref, got)):
            if i == 7:      # power: float psum reassociates across shards
                np.testing.assert_allclose(r, g, rtol=1e-6)
            else:
                np.testing.assert_array_equal(r, g)
    packed, new_hist, new_gens, fb2, xh2, yh2, clips, power = ref
    assert packed.shape == (nK, S * 2)
    assert np.isfinite(power)
    # the quantize stage must agree with the host decimator bit-for-bit on
    # the passthrough-resampled samples
    buf = np.concatenate([hist, x], axis=1)
    win = buf[:, 8:8 + (nb + qn) * M].reshape(S, nb + qn, M)
    Xq = np.stack([win[:, q:q + nb] for q in range(qn)], 2) \
        .reshape(S, nb, qn * M)
    out_ref = (Xq @ Pq).reshape(S, nK)
    packed_h, clips_h = dec.process_interleaved(out_ref.T)
    assert int(clips) == clips_h
    np.testing.assert_array_equal(packed, np.asarray(packed_h))


def test_device_decimator_engine_bit_exact():
    """DeviceDecimator (fused dither+quantize+pack, packed-bytes-only fetch)
    is byte-exact vs the host Decimator across dither/shaping modes and
    ragged chunk tails."""
    import numpy as np
    from art_jax.core import flags as F
    from art_jax.engines.decimator import Decimator, DeviceDecimator

    rng = np.random.default_rng(3)
    cases = [
        (F.DITHER_HIGHPASS | F.SHAPING_ATH_CURVE, 16, 2, 44100),
        (F.DITHER_FLAT, 16, 2, 48000),
        (F.DITHER_LOWPASS | F.SHAPING_2ND_ORDER, 8, 1, 32000),
        (0, 24, 3, 96000),
    ]
    for flags, bits, nbytes, rate in cases:
        ch = 2
        host = Decimator(ch, bits, nbytes, 1.0, rate, flags,
                         backend="numpy")
        dev = DeviceDecimator(ch, bits, nbytes, 1.0, rate, flags)
        for n, K in [(256, 256), (256, 100), (64, 64)]:
            x = (rng.random((n, ch)).astype(np.float32) - 0.5) * 1.7
            ph, ch_clip = host.process_interleaved(x[:K])
            pd, cd_clip = dev.process_chunk(x, K)
            assert ch_clip == cd_clip, (flags, n, K)
            assert np.array_equal(ph.reshape(K, -1), pd), (flags, n, K)


def test_device_decimator_checkpoint_resume():
    """DeviceDecimator state_dict/load_state: the resumed stream emits
    byte-identical packed output."""
    import numpy as np
    from art_jax.core import flags as F
    from art_jax.engines.decimator import DeviceDecimator

    rng = np.random.default_rng(9)
    d = DeviceDecimator(2, 16, 2, 1.0, 44100,
                        F.DITHER_HIGHPASS | F.SHAPING_ATH_CURVE)
    x0 = (rng.random((256, 2)).astype(np.float32) - 0.5) * 1.5
    d.process_chunk(x0, 256)
    snap = d.state_dict()
    x1 = (rng.random((256, 2)).astype(np.float32) - 0.5) * 1.5
    p1, c1 = d.process_chunk(x1, 200)

    d2 = DeviceDecimator(2, 16, 2, 1.0, 44100,
                         F.DITHER_HIGHPASS | F.SHAPING_ATH_CURVE)
    d2.load_state(snap)
    p2, c2 = d2.process_chunk(x1, 200)
    assert c1 == c2
    assert np.array_equal(p1, p2)


def test_sharded_production_step_with_post_biquad():
    """pipeline_chunk's optional -p post-filter cascade (masked associative
    scan between resample and quantize, reference art.c:1052-1058): sharded
    over every mesh shape == 1x1 mesh bit-for-bit on a passthrough phase
    matrix, and the filtered samples equal the host Biquad cascade at the
    f64-reassociation floor."""
    from art_jax.engines.biquad import Biquad, biquad_lowpass
    from art_jax.engines.decimator import Decimator as D
    from art_jax.parallel.pipeline import make_sharded_step, pad_phase_matrix
    from art_jax.parallel.sharding import make_mesh

    M, L, nb, qn, hist_len = 3, 2, 16, 4, 32
    nK = nb * L
    S, chunk = 8, nb * M
    dec = D(S, 16, 2, 1.0, 44100, DITHER_HIGHPASS | SHAPING_ATH_CURVE)
    sh = dec.noise_shaper
    bq = Biquad.init(biquad_lowpass(0.2), 1.0, S, np.float64)
    post_bq = ((bq.a, bq.b), (bq.a, bq.b))

    Pq = np.zeros((qn * M, L), np.float32)
    Pq[2, 0] = 1.0
    Pq[5, 1] = 1.0

    kw = dict(M=M, L=L, nb=nb, qn=qn, hist_len=hist_len, scaler=32768.0,
              highclip=32767, lowclip=-32768, dither_type=-1,
              shaper_a=sh.a, shaper_b=sh.b, output_bits=16, output_bytes=2,
              post_bq=post_bq)
    x, hist, gens, fb, xh, yh, A, V0, V1 = _tiny_sharded_inputs(
        S, nK, hist_len, chunk)
    bq_state = tuple(np.zeros((4, S), np.float64) for _ in range(4))
    args0 = (np.int32(8), np.int32(nK), gens, fb, xh, yh, A, V0, V1,
             bq_state)

    results = []
    for mesh_shape in [(1, 1), (8, 1), (4, 2)]:
        mesh = make_mesh(*mesh_shape)
        qn_pad = -(-qn // mesh_shape[1]) * mesh_shape[1]
        step = make_sharded_step(mesh, **kw)
        Pp = pad_phase_matrix(Pq, M, L, qn, qn_pad, np.float32)
        out = step(x, hist, Pp, *args0)
        flat = list(out[:8]) + list(out[8])
        results.append(tuple(np.asarray(o) for o in flat))

    ref = results[0]
    for got in results[1:]:
        for i, (r, g) in enumerate(zip(ref, got)):
            if i == 7:
                np.testing.assert_allclose(r, g, rtol=1e-6)
            else:
                np.testing.assert_array_equal(r, g)

    # filtered+quantized output == host Biquad cascade -> host decimator
    buf = np.concatenate([hist, x], axis=1)
    win = buf[:, 8:8 + (nb + qn) * M].reshape(S, nb + qn, M)
    Xq = np.stack([win[:, q:q + nb] for q in range(qn)], 2) \
        .reshape(S, nb, qn * M)
    res = (Xq @ Pq).reshape(S, nK)
    h1 = Biquad.init(biquad_lowpass(0.2), 1.0, S, np.float64)
    h2 = Biquad.init(biquad_lowpass(0.2), 1.0, S, np.float64)
    filt = h2.apply_buffer(h1.apply_buffer(res.T.astype(np.float64)))
    packed_h, clips_h = dec.process_interleaved(filt.astype(np.float32))
    assert int(ref[6]) == clips_h
    np.testing.assert_array_equal(ref[0], np.asarray(packed_h))
