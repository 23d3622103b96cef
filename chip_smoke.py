#!/usr/bin/env python3
"""Bring-up smoke test: the main device path once on one GPU, at full width,
checked against the repo's host engines.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --four     # four GPUs: the multi-device path only

Phases (each runs its device work twice — cold, which compiles or loads the
persistent cache, then warm — and checks the warm results):

  fixed         preset-3 44.1k->48k stereo, 10 minutes of artest noise with
                fades, forward and inverse through DeviceStreamResampler on
                the flat-group path in the f32, int8 and f64-accumulate
                modes: round-trip diff RMS against the C reference's
                -142.29 dB, and the first 2^20 outputs against the host
                numpy Resampler (counts and positions exact)
  interpolated  preset-1 mono as 64 engine rows (the serving form) against
                the host engine
  asrc          BatchedASRC(256, 380, 380) in f32 and f64: three drifting-
                ratio calls of 32768 frames and a masked flush, against
                per-stream host engines on 8 sentinel streams
  f64_chain     DeviceBiquadCascade + f64 DeviceStreamResampler (5.1ch
                48k->44.1k, -p) against host apply_cascade + f64 Resampler
  packed        process_flat_packed int16 bytes against the native quantizer
                on the same f32 outputs, clip counts equal
  cli           art --backend=device on a 5-minute 44.1k stereo float WAV and
                artest --backend=device, both in process, against
                --backend=numpy

Any failed comparison or exception exits nonzero.  The last line of stdout
is one JSON object, {"ok": true, "device": {...}}, printed only when every
phase passed.  JAX_PLATFORMS is forced to "cuda" before jax is imported, so
a machine without a GPU fails at start-up instead of falling back to the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REF_DIFF_RMS_DB = -142.29        # C reference, artest -3 -i -e (BASELINE)
# round-trip limits: the int8 and f64-accumulate modes must sit within
# 0.1 dB of the C reference.  The f32 mode accumulates in FP32 GEMMs, whose
# error on the H100 depends on the GEMM kernel XLA picks for the shape:
# -133.91 dB on this phase's 10-minute flat-group path, -140.35 dB on
# artest's 4096-frame path (PERF.md).  Its bound leaves ~2 dB for the
# autotuner's choice, while a reduced-precision slip (TF32, bf16) reads
# tens of dB worse.
ROUNDTRIP_LIMIT_DB = {"f32": -132.0, "int8": REF_DIFF_RMS_DB + 0.1,
                      "f64acc": REF_DIFF_RMS_DB + 0.1}
# device f32 vs host f32 outputs: both accumulate the same products, in a
# different order and width (PARITY.md, f32 class, at full scale)
FIXED_TOL = 3e-6
# BatchedASRC vs host engines: f32 at the f32 floor (PARITY.md).  f64: the
# device forms read positions fl(offset + k/ratio) in call-entry
# coordinates, the host in ring coordinates (see asrc._asrc_step), so a
# position may differ by one ulp — 7.3e-12 samples at the ~4e4 positions
# of 32768-frame calls — times the signal slope (< pi * peak, peak 0.5
# here), plus the summation order over 380 taps (~1e-15)
ASRC_TOL = {np.float32: 1e-6, np.float64: 1e-10}
# f64 chain: the combined order-4 IIR reassociates the cascade at the
# ~2.4e-13 relative class (PARITY.md) and the f64 resampler sums in
# another order; samples are O(1)
F64_CHAIN_TOL = 1e-10


class SmokeFailure(RuntimeError):
    """A comparison did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _flags():
    """(interpolated Blackman-Harris, the same with INCLUDE_LOWPASS)."""
    from art_jax.core import flags as F
    ib = F.SUBSAMPLE_INTERPOLATE | F.BLACKMAN_HARRIS
    return ib, ib | F.INCLUDE_LOWPASS


def mult_chunk(target: int, M: int) -> int:
    """Multiple of the input period M nearest the target: the fixed-ratio
    steady state is then exactly periodic (the flat-group precondition)."""
    return max(1, round(target / M)) * M


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def require_gpu(jax) -> None:
    backend = jax.default_backend()
    check(backend == "gpu", f"JAX backend is {backend!r}, not 'gpu'")


class PhaseClock:
    """Wall time of a phase's device work, cold (first call: compiles, or
    loads the persistent cache) and warm, with the backend compile seconds
    and persistent-cache hits and misses seen in each call."""

    def __init__(self):
        self.compile_s = 0.0
        self.hits = 0
        self.misses = 0
        self.rows: dict[str, dict] = {}

    def listen(self, jax) -> None:
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += secs

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def _one(self, fn):
        c0, h0, m0 = self.compile_s, self.hits, self.misses
        t0 = time.perf_counter()
        out = fn()
        return out, {"wall_s": time.perf_counter() - t0,
                     "compile_s": self.compile_s - c0,
                     "cache_hits": self.hits - h0,
                     "cache_misses": self.misses - m0}

    def twice(self, name: str, fn):
        """Run fn (which returns host data, so the device work is done)
        cold and warm; return the warm result."""
        _, cold = self._one(fn)
        out, warm = self._one(fn)
        self.rows[name] = {"cold": cold, "warm": warm}
        return out


def _once(clock, name, fn):
    return fn() if clock is None else clock.twice(name, fn)


# ---------------------------------------------------------------- fixed
def stream_flat_out(eng, x, chunk: int, G: int):
    """Push device x [ch, n] through a fixed-ratio engine on the flat-group
    path: the first chunk through process() (it absorbs the non-periodic
    entry plan), then groups of G chunks through process_flat_out, single
    chunks and the tail through process(), then flush.  Returns (audio
    [ch, K_total] on device, per-call output counts)."""
    import jax.numpy as jnp

    ch, n = x.shape
    outs, Ks = [], []
    pos = min(chunk, n)
    o, K = eng.process(x[:, :pos], pos)
    outs.append(o[:, :K])
    Ks.append(K)
    while n - pos >= G * chunk:
        o, ks = eng.process_flat_out(x[:, pos:pos + G * chunk], chunk)
        outs.append(o)
        Ks.extend(int(k) for k in ks)
        pos += G * chunk
    while n - pos >= chunk:
        o, K = eng.process(x[:, pos:pos + chunk], chunk)
        outs.append(o[:, :K])
        Ks.append(K)
        pos += chunk
    if pos < n:
        o, K = eng.process(x[:, pos:], n - pos)
        outs.append(o[:, :K])
        Ks.append(K)
    o, K = eng.flush()
    outs.append(o[:, :K])
    Ks.append(K)
    return jnp.concatenate(outs, axis=1), Ks


def artest_noise(frames: int, ch: int, bufn: int = 4096) -> np.ndarray:
    """artest's LCG noise with its endpoint fades, [ch, frames] f32."""
    from art_jax.utils.testsig import NoiseLCG, fade_in, fade_out
    sig = NoiseLCG().fill(frames * ch, np.float32).reshape(frames, ch)
    fade_in(sig[:bufn])
    fade_out(sig[-bufn:])
    return np.ascontiguousarray(sig.T)


def roundtrip_db(x, precise, chunk_target: int, G: int) -> float:
    """The artest -i -e metric on the device engines: preset-3 44.1k->48k
    and back on the flat-group path, diff RMS of the time-aligned result
    against the source (reference artest.c:446-612, display_stats
    10*log10(sum/count*2))."""
    import jax.numpy as jnp
    from art_jax.parallel.streams import DeviceStreamResampler

    IB, _ = _flags()
    ch, n = x.shape
    fwd = DeviceStreamResampler(ch, 380, 380, 44100, 48000, 0, IB,
                                precise=precise)
    inv = DeviceStreamResampler(ch, 380, 380, 48000, 44100, 0, IB,
                                precise=precise)
    fwd.advance_position(190)
    inv.advance_position(190)
    y, _ = stream_flat_out(fwd, x, mult_chunk(chunk_target, fwd.M), G)
    z, _ = stream_flat_out(inv, y, mult_chunk(chunk_target, inv.M), G)
    m = min(n, z.shape[1])
    diff = (z[:, :m] - x[:, :m]).astype(jnp.float64)
    sumsq = float(jnp.sum(diff * diff))
    return 10.0 * math.log10(sumsq / (m * ch) * 2.0)


MODES = {"int8": "int8", "f64acc": True, "f32": False}


def phase_fixed(clock=None, *, seconds: float = 600.0,
                check_frames: int = 1 << 20, chunk_target: int = 1 << 19,
                check_chunk_target: int = 1 << 18, G: int = 8) -> dict:
    import jax.numpy as jnp
    from art_jax.engines.resampler import Resampler
    from art_jax.parallel.streams import DeviceStreamResampler

    IB, _ = _flags()
    ch = 2
    n = int(seconds * 44100)
    x_host = artest_noise(n, ch)
    res = {"frames_in": n}

    # host oracle for the first check_frames outputs: the same chunking as
    # the device (first chunk, then one flat group of the rest)
    M = 147
    cc = mult_chunk(check_chunk_target, M)
    nchk = 4
    while (nchk - 1) * cc * 48000 // 44100 < check_frames:
        nchk += 1
    check(nchk * cc <= n, "input too short for the host comparison")
    host = Resampler.fixed_ratio(ch, 380, 380, 44100, 48000, 0, IB)
    host.advance_position(190)
    h_outs, h_Ks = [], []
    for i in range(nchk):
        o, r = host.process(x_host[:, i * cc:(i + 1) * cc], cc, 2 * cc, 0.0)
        h_outs.append(o[:, :r.output_generated])
        h_Ks.append(r.output_generated)
    h_out = np.concatenate(h_outs, axis=1)[:, :check_frames]
    h_pos = host.get_position()

    x = jnp.asarray(x_host)
    for mode, precise in MODES.items():
        def device_check(precise=precise):
            eng = DeviceStreamResampler(ch, 380, 380, 44100, 48000, 0, IB,
                                        precise=precise)
            eng.advance_position(190)
            o0, K0 = eng.process(x[:, :cc], cc)
            og, ks = eng.process_flat_out(x[:, cc:nchk * cc], cc)
            out = jnp.concatenate([o0[:, :K0], og], axis=1)
            return (np.asarray(out[:, :check_frames]),
                    [K0] + [int(k) for k in ks], eng.get_position())

        out, Ks, pos = _once(clock, f"fixed/{mode}/vs_host", device_check)
        check(Ks == h_Ks, f"fixed/{mode}: counts {Ks} != host {h_Ks}")
        check(pos == h_pos, f"fixed/{mode}: position {pos} != host {h_pos}")
        dmax = float(np.abs(out - h_out).max())
        check(out.shape == h_out.shape and dmax <= FIXED_TOL,
              f"fixed/{mode}: max|d| {dmax:.3g} vs host > {FIXED_TOL}")
        db = _once(clock, f"fixed/{mode}/roundtrip",
                   lambda precise=precise: roundtrip_db(
                       x, precise, chunk_target, G))
        res[mode] = {"roundtrip_db": db, "vs_host_maxdiff": dmax}
        print(f"# fixed/{mode}: {json.dumps(res[mode])}", flush=True)
        limit = ROUNDTRIP_LIMIT_DB[mode]
        check(db <= limit, f"fixed/{mode}: round trip {db:.2f} dB > "
              f"{limit:.2f} dB")
    return res


# --------------------------------------------------------- interpolated
def phase_interpolated(clock=None, *, rows: int = 64,
                       chunk_target: int = 1 << 16, chunks: int = 4,
                       seed: int = 1) -> dict:
    import jax.numpy as jnp
    from art_jax.engines.resampler import Resampler
    from art_jax.parallel.streams import DeviceStreamResampler

    IB, _ = _flags()
    probe = DeviceStreamResampler(1, 48, 48, 44100, 48000, 0, IB)
    check(probe.interp, "preset-1 44.1k->48k should be interpolated")
    cc = mult_chunk(chunk_target, probe.M)
    rng = np.random.default_rng(seed)
    x_host = rng.uniform(-0.5, 0.5, (rows, chunks * cc)).astype(np.float32)

    host = Resampler.fixed_ratio(rows, 48, 48, 44100, 48000, 0, IB)
    host.advance_position(24)
    h_outs, h_Ks = [], []
    for i in range(chunks):
        o, r = host.process(x_host[:, i * cc:(i + 1) * cc], cc, 2 * cc, 0.0)
        h_outs.append(o[:, :r.output_generated])
        h_Ks.append(r.output_generated)
    h_out = np.concatenate(h_outs, axis=1)

    x = jnp.asarray(x_host)

    def device():
        eng = DeviceStreamResampler(rows, 48, 48, 44100, 48000, 0, IB)
        eng.advance_position(24)
        o0, K0 = eng.process(x[:, :cc], cc)
        outs, Ks = [o0[:, :K0]], [K0]
        try:
            og, ks = eng.process_flat_out(x[:, cc:], cc)
            outs.append(og)
            Ks.extend(int(k) for k in ks)
            flat = True
        except ValueError:
            # the pattern did not repeat (a float64 tie): per-chunk form
            flat = False
            for i in range(1, chunks):
                o, K = eng.process(x[:, i * cc:(i + 1) * cc], cc)
                outs.append(o[:, :K])
                Ks.append(K)
        out = jnp.concatenate(outs, axis=1)
        return np.asarray(out), Ks, eng.get_position(), flat

    out, Ks, pos, flat = _once(clock, "interpolated", device)
    check(Ks == h_Ks, f"interpolated: counts {Ks} != host {h_Ks}")
    check(pos == host.get_position(), "interpolated: position != host")
    dmax = float(np.abs(out - h_out).max())
    check(dmax <= FIXED_TOL,
          f"interpolated: max|d| {dmax:.3g} vs host > {FIXED_TOL}")
    return {"rows": rows, "frames_per_row": chunks * cc, "flat_group": flat,
            "vs_host_maxdiff": dmax}


# ----------------------------------------------------------------- asrc
def phase_asrc(clock=None, *, S: int = 256, taps: int = 380,
               filters: int = 380, n: int = 32768, calls: int = 3,
               sentinels: int = 8, seed: int = 2) -> dict:
    import jax.numpy as jnp
    from art_jax.engines.resampler import Resampler
    from art_jax.parallel.asrc import BatchedASRC

    IB, _ = _flags()
    rng = np.random.default_rng(seed)
    xs_host = [rng.uniform(-0.5, 0.5, (S, n)) for _ in range(calls)]
    ratios = [1.0 + 0.01 * np.sin(np.arange(S) * 0.1 + 0.031 * t)
              for t in range(calls + 1)]
    mask = np.arange(S) % 3 != 1                 # flush two streams in 3
    sent = np.unique(np.linspace(0, S - 1, sentinels).astype(int))
    res = {}
    for dt in (np.float32, np.float64):
        xs = [jnp.asarray(a.astype(dt)) for a in xs_host]

        def device(dt=dt, xs=xs):
            eng = BatchedASRC(S, taps, filters, dtype=dt)
            eng.advance_position(float(taps // 2))
            outs, Kss, poss = [], [], []
            for t in range(calls):
                out, Ks = eng.process(xs[t], ratios[t])
                outs.append(np.asarray(out[sent]))
                Kss.append(np.asarray(Ks))
                poss.append(eng.get_position())
            fout, fKs = eng.flush(ratios[calls], mask)
            outs.append(np.asarray(fout[sent]))
            Kss.append(np.asarray(fKs))
            poss.append(eng.get_position())
            return outs, Kss, poss

        outs, Kss, poss = _once(clock, f"asrc/{np.dtype(dt).name}", device)
        md = 0.0
        for j, s in enumerate(sent):
            h = Resampler(1, taps, filters, 0.0, IB, backend="numpy",
                          dtype=dt)
            h.advance_position(float(taps // 2))
            for t in range(calls + 1):
                if t < calls:
                    ho, r = h.process(xs_host[t][s:s + 1].astype(dt), n,
                                      2 * n, float(ratios[t][s]))
                elif mask[s]:
                    ho, r = h.process(None, -1, 4 * taps,
                                      float(ratios[t][s]))
                else:
                    continue
                K = int(Kss[t][s])
                check(r.output_generated == K,
                      f"asrc/{np.dtype(dt).name}: stream {s} call {t}: "
                      f"{K} != host {r.output_generated}")
                check(poss[t][s] == h.get_position(),
                      f"asrc/{np.dtype(dt).name}: stream {s} call {t}: "
                      f"position {poss[t][s]} != host {h.get_position()}")
                if K:
                    md = max(md, float(np.abs(ho[0, :K]
                                              - outs[t][j, :K]).max()))
        tol = ASRC_TOL[dt]
        check(md <= tol, f"asrc/{np.dtype(dt).name}: max|d| {md:.3g} > "
              f"{tol}")
        check(all(int(k.min()) > 0 for k in Kss[:calls]),
              "asrc: a live stream emitted nothing")
        check(not Kss[calls][~mask].any(), "asrc: unmasked stream flushed")
        res[np.dtype(dt).name] = {
            "vs_host_maxdiff": md,
            "outputs": int(sum(int(k.sum()) for k in Kss))}
    return res


# ------------------------------------------------------------ f64 chain
def phase_f64_chain(clock=None, *, ch: int = 6,
                    chunk_target: int = 1 << 19, chunks: int = 3,
                    seed: int = 4) -> dict:
    import jax.numpy as jnp
    from art_jax.engines.biquad import Biquad, apply_cascade, biquad_lowpass
    from art_jax.engines.resampler import Resampler
    from art_jax.ops.biquad_kernel import DeviceBiquadCascade
    from art_jax.parallel.streams import DeviceStreamResampler

    _, flags = _flags()
    coeffs = biquad_lowpass(0.45 * 44100 / 48000)
    probe = DeviceStreamResampler(ch, 380, 380, 48000, 44100, 0, flags,
                                  dtype=np.float64)
    cc = mult_chunk(chunk_target, probe.M)
    rng = np.random.default_rng(seed)
    x_host = rng.standard_normal((ch, chunks * cc)) * 0.25

    bqs = [Biquad.init(coeffs, 1.0, channels=ch, dtype=np.float64)
           for _ in range(2)]
    host = Resampler.fixed_ratio(ch, 380, 380, 48000, 44100, 0, flags,
                                 dtype=np.float64)
    host.advance_position(190)
    h_outs, h_Ks = [], []
    for i in range(chunks):
        y = apply_cascade(bqs, np.ascontiguousarray(
            x_host[:, i * cc:(i + 1) * cc].T))
        o, r = host.process_interleaved(y, cc, 2 * cc, 0.0)
        h_outs.append(o[:r.output_generated].T)
        h_Ks.append(r.output_generated)
    h_out = np.concatenate(h_outs, axis=1)

    x = jnp.asarray(x_host)

    def device():
        eng = DeviceStreamResampler(ch, 380, 380, 48000, 44100, 0, flags,
                                    dtype=np.float64)
        eng.advance_position(190)
        casc = DeviceBiquadCascade(
            Biquad.init(coeffs, 1.0, 1, np.float64),
            Biquad.init(coeffs, 1.0, 1, np.float64), combined=True)
        casc.push_from(Biquad.init(coeffs, 1.0, ch, np.float64),
                       Biquad.init(coeffs, 1.0, ch, np.float64))
        outs, Ks = [], []
        for i in range(chunks):
            y = casc.process(x[:, i * cc:(i + 1) * cc], cc)
            o, K = eng.process(y, cc)
            outs.append(o[:, :K])
            Ks.append(K)
        return (np.asarray(jnp.concatenate(outs, axis=1)), Ks,
                eng.get_position())

    out, Ks, pos = _once(clock, "f64_chain", device)
    check(Ks == h_Ks, f"f64_chain: counts {Ks} != host {h_Ks}")
    check(pos == host.get_position(), "f64_chain: position != host")
    dmax = float(np.abs(out - h_out).max())
    check(dmax <= F64_CHAIN_TOL,
          f"f64_chain: max|d| {dmax:.3g} > {F64_CHAIN_TOL}")
    return {"channels": ch, "frames_in": chunks * cc,
            "vs_host_maxdiff": dmax}


# --------------------------------------------------------------- packed
def phase_packed(clock=None, *, chunk_target: int = 1 << 19, G: int = 4,
                 gains=(1.0, 1.5)) -> dict:
    """process_flat_packed's int16 bytes against the native quantizer
    (host Decimator, no dither, no shaping) run on process_flat_out's f32
    samples of the same chunks."""
    import jax.numpy as jnp
    from art_jax.engines.decimator import Decimator
    from art_jax.parallel.streams import DeviceStreamResampler

    IB, _ = _flags()
    ch = 2
    probe = DeviceStreamResampler(ch, 380, 380, 44100, 48000, 0, IB)
    cc = mult_chunk(chunk_target, probe.M)
    # full-scale (+-1) noise: the resampled overshoot drives real clipping
    x_host = artest_noise((G + 1) * cc, ch) * np.float32(2.0)
    x = jnp.asarray(x_host)
    res = {}
    for gain in gains:
        scaler = 32768.0 * gain

        def device(scaler=scaler):
            a = DeviceStreamResampler(ch, 380, 380, 44100, 48000, 0, IB)
            b = DeviceStreamResampler(ch, 380, 380, 44100, 48000, 0, IB)
            for e in (a, b):
                e.advance_position(190)
                e.process(x[:, :cc], cc)
            out, Ka = a.process_flat_out(x[:, cc:], cc)
            packed, Kb, clips = b.process_flat_packed(
                x[:, cc:], cc, jnp.zeros((), jnp.int32), scaler=scaler,
                highclip=32767, lowclip=-32768)
            return (np.asarray(out), list(Ka), np.asarray(packed),
                    list(Kb), int(clips))

        out, Ka, packed, Kb, clips = _once(clock, f"packed/gain{gain}",
                                           device)
        check(Ka == Kb, "packed: counts differ between delivery forms")
        dec = Decimator(ch, 16, 2, gain, 48000, 0, backend="native")
        want, want_clips = dec.process(out)               # [nK, ch*2]
        nK = out.shape[1]
        got = packed.view(np.uint8).reshape(ch, nK, 2) \
            .transpose(1, 0, 2).reshape(nK, ch * 2)
        nbad = int((got != np.asarray(want)).any(axis=1).sum())
        check(nbad == 0, f"packed/gain{gain}: {nbad} of {nK} frames differ "
              "from the native quantizer")
        check(clips == want_clips,
              f"packed/gain{gain}: clips {clips} != native {want_clips}")
        check(clips > 0, f"packed/gain{gain}: no clipping exercised")
        res[f"gain{gain}"] = {"frames": nK, "clips": clips}
    return res


# ------------------------------------------------------------------ cli
def write_float_wav(path: str, x: np.ndarray, rate: int) -> None:
    """Interleaved float frames [n, ch] -> 32-bit float WAV."""
    from art_jax.io import wavfile
    n, ch = x.shape
    with open(path, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=ch, num_frames=n,
                                 sample_rate=rate,
                                 channel_mask=0x5 - ch if ch <= 2 else 0)
        f.write(x.astype("<f4").tobytes())


def read_float_wav(path: str) -> np.ndarray:
    from art_jax.io import wavfile
    with open(path, "rb") as f:
        info = wavfile.read_wav_header(f)
        raw = f.read()
    check(info.is_float and info.bits_per_sample == 32,
          f"{path}: expected a 32-bit float WAV")
    return np.frombuffer(raw[:info.num_frames * info.num_channels * 4],
                         "<f4").reshape(info.num_frames, info.num_channels)


def run_cli(main, argv) -> tuple[int, str]:
    """Run a CLI entry point in process; returns (rc, its stderr).  Its
    stdout (artest writes binary there) is captured and dropped."""
    err = io.StringIO()
    out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, err.getvalue()


_STATS = re.compile(r"\((-w\d)\): count =\s*(\d+), checksum = (\w+),.*"
                    r"RMS = (-?[\d.]+|-inf) dB")


def artest_stats(text: str) -> dict:
    return {m.group(1): (int(m.group(2)), m.group(3), float(m.group(4)))
            for m in _STATS.finditer(text)}


def phase_cli(clock=None, *, seconds: float = 300.0,
              artest_seconds: int = 60, workdir: str | None = None) -> dict:
    from art_jax.cli import art, artest

    n = int(seconds * 44100)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
    res = {}
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        src = os.path.join(tmp, "in.wav")
        write_float_wav(src, x, 44100)

        def convert(backend, extra=()):
            dst = os.path.join(tmp, f"out_{backend}.wav")
            rc, log = run_cli(art.main, ["-q", "-y", f"--backend={backend}",
                                         *extra, "-3", "-r48k", src, dst])
            check(rc == 0, f"art --backend={backend} exited {rc}: {log}")
            return read_float_wav(dst)

        ref = convert("numpy")
        dev = _once(clock, "cli/art", lambda: convert("device"))
        check(dev.shape == ref.shape,
              f"art: device {dev.shape} != numpy {ref.shape}")
        dmax = float(np.abs(dev - ref).max())
        check(dmax <= FIXED_TOL, f"art: max|d| {dmax:.3g} > {FIXED_TOL}")
        res["art"] = {"frames_out": int(ref.shape[0]),
                      "vs_numpy_maxdiff": dmax}

    argv = ["-3", "-s44.1k", "-d48k", "-c2", f"-n{artest_seconds}", "-e",
            "-i"]
    rc, log_np = run_cli(artest.main, ["--backend=numpy", *argv])
    check(rc == 0, f"artest --backend=numpy exited {rc}")
    rc_dev, log_dev = _once(clock, "cli/artest", lambda: run_cli(
        artest.main, ["--backend=device", *argv]))
    check(rc_dev == 0, f"artest --backend=device exited {rc_dev}")
    s_np, s_dev = artest_stats(log_np), artest_stats(log_dev)
    check(set(s_np) == {"-w1", "-w2", "-w4", "-w5"}
          and set(s_dev) == set(s_np),
          f"artest: stats lines {sorted(s_dev)} vs {sorted(s_np)}")
    for w in s_np:
        check(s_dev[w][0] == s_np[w][0],
              f"artest {w}: count {s_dev[w][0]} != numpy {s_np[w][0]}")
    check(s_dev["-w1"][1] == s_np["-w1"][1], "artest: input checksum differs")
    limit = ROUNDTRIP_LIMIT_DB["f32"]       # artest -e runs the f32 mode
    check(s_dev["-w5"][2] <= limit,
          f"artest: device round trip {s_dev['-w5'][2]} dB > {limit} dB")
    res["artest"] = {"diff_db_device": s_dev["-w5"][2],
                     "diff_db_numpy": s_np["-w5"][2],
                     "count_w2": s_dev["-w2"][0]}
    return res


# ------------------------------------------------------- four devices
def phase_four(clock=None, *, devices=None, seconds: float = 60.0,
               S: int = 256, n: int = 32768, calls: int = 3,
               pipeline_blocks: int = 4096) -> dict:
    """The multi-device path on four devices against one device: art
    --mesh=4x1 and --mesh=2x2, BatchedASRC over a 4x1 mesh, and
    pipeline.make_sharded_step on a 4x1 mesh."""
    import jax
    import jax.numpy as jnp
    from art_jax.cli import art
    from art_jax.parallel.asrc import BatchedASRC
    from art_jax.parallel.sharding import make_mesh

    devices = list(devices if devices is not None else jax.devices())[:4]
    check(len(devices) == 4, f"--four needs 4 devices, found {len(devices)}")
    res = {}

    # art over a mesh vs one device
    nfr = int(seconds * 44100)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((nfr, 2)) * 0.3).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.wav")
        write_float_wav(src, x, 44100)

        def convert(mesh):
            tag = mesh or "1"
            dst = os.path.join(tmp, f"out_{tag}.wav")
            extra = [f"--mesh={mesh}"] if mesh else []
            rc, log = run_cli(art.main, ["-q", "-y", "--backend=device",
                                         *extra, "-3", "-r48k", src, dst])
            check(rc == 0, f"art --mesh={tag} exited {rc}: {log}")
            return read_float_wav(dst)

        one = convert(None)
        for mesh in ("4x1", "2x2"):
            got = _once(clock, f"four/art/{mesh}", lambda m=mesh: convert(m))
            check(got.shape == one.shape, f"art --mesh={mesh}: shape")
            d = float(np.abs(got - one).max())
            check(d <= FIXED_TOL, f"art --mesh={mesh}: max|d| {d:.3g}")
            res[f"art_{mesh}"] = {"vs_one_device_maxdiff": d}

    # BatchedASRC over a 4x1 mesh vs the unmeshed engine
    mesh = make_mesh(4, 1, devices)
    xs = [jnp.asarray(rng.uniform(-0.5, 0.5, (S, n)).astype(np.float32))
          for _ in range(calls)]
    ratios = [1.0 + 0.01 * np.sin(np.arange(S) * 0.1 + 0.031 * t)
              for t in range(calls + 1)]
    fmask = np.arange(S) % 2 == 0

    def asrc(m):
        eng = BatchedASRC(S, 380, 380, mesh=m)
        eng.advance_position(190.0)
        outs, Kss = [], []
        for t in range(calls):
            o, K = eng.process(xs[t], ratios[t])
            outs.append(np.asarray(o))
            Kss.append(np.asarray(K))
        o, K = eng.flush(ratios[calls], fmask)
        outs.append(np.asarray(o))
        Kss.append(np.asarray(K))
        return outs, Kss, eng.get_position(), len(eng.hist.sharding.device_set)

    o1, K1, p1, _ = asrc(None)
    o4, K4, p4, ndev = _once(clock, "four/asrc", lambda: asrc(mesh))
    check(ndev == 4, f"asrc: state spans {ndev} devices, not 4")
    check(all(np.array_equal(a, b) for a, b in zip(K1, K4)),
          "asrc mesh: counts differ")
    check(np.array_equal(p1, p4), "asrc mesh: positions differ")
    d = max(float(np.abs(a - b).max()) for a, b in zip(o1, o4))
    check(d <= ASRC_TOL[np.float32], f"asrc mesh: max|d| {d:.3g}")
    res["asrc_4x1"] = {"vs_one_device_maxdiff": d}

    res["pipeline_4x1"] = _pipeline_four(clock, devices, pipeline_blocks)
    return res


def _pipeline_four(clock, devices, nb: int) -> dict:
    """pipeline.make_sharded_step over 4x1 vs 1x1: a one-hot passthrough
    phase matrix makes the resample exact on any mesh, so the dithered,
    ATH-shaped packed bytes must match bit for bit; the preset-3 matrix,
    undithered, must agree to the f32 floor (at most 1 LSB, rarely)."""
    from art_jax.core.flags import DITHER_HIGHPASS, SHAPING_ATH_CURVE
    from art_jax.engines.decimator import Decimator
    from art_jax.ops import decimate_device as dd
    from art_jax.ops import decimate_kernel as dk
    from art_jax.ops.polyphase import PolyphaseMatrix
    from art_jax.core.filters import make_filter_bank
    from art_jax.parallel.pipeline import make_sharded_step, pad_phase_matrix
    from art_jax.parallel.sharding import make_mesh

    M, L, T = 147, 160, 380
    qn = -(-(M + T) // M)
    hist_len = T * 16
    S = 8
    nK = nb * L
    chunk = nb * M
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((S, chunk)) * 0.3).astype(np.float32)
    hist = (rng.standard_normal((S, hist_len)) * 0.3).astype(np.float32)
    A, V0, V1 = dd.dither_tables(nK)
    sh = Decimator(S, 16, 2, 1.0, 48000,
                   DITHER_HIGHPASS | SHAPING_ATH_CURVE).noise_shaper
    one_hot = np.zeros((qn * M, L), np.float32)
    one_hot[np.arange(L) * M // L + T // 2, np.arange(L)] = 1.0
    bank = make_filter_bank(T, L, 1.0, True, np.float32)
    real = np.zeros((qn * M, L), np.float32)
    pm = PolyphaseMatrix(bank, L, M, 0, False)
    real[:pm.S] = pm.P.T
    start = np.int32(hist_len - T)

    def run(mesh_shape, P, shaped):
        mesh = make_mesh(*mesh_shape, devices)
        kw = dict(M=M, L=L, nb=nb, qn=qn, hist_len=hist_len,
                  scaler=32768.0, highclip=32767, lowclip=-32768,
                  output_bits=16, output_bytes=2)
        if shaped:
            kw.update(dither_type=-1, shaper_a=sh.a, shaper_b=sh.b)
        else:
            kw.update(dither_type=None)
        step = make_sharded_step(mesh, **kw)
        Pp = pad_phase_matrix(P, M, L, qn, qn, np.float32)
        out = step(x, hist, Pp, start, np.int32(nK), dk.seed_generators(S),
                   np.zeros(S, np.float32), np.zeros((4, S), np.float32),
                   np.zeros((4, S), np.float32), A, V0, V1)
        return [np.asarray(o) for o in out]

    exact1 = run((1, 1), one_hot, True)
    exact4 = _once(clock, "four/pipeline",
                   lambda: run((4, 1), one_hot, True))
    for i, (a, b) in enumerate(zip(exact1, exact4)):
        if i == 7:                   # power: the psum reassociates
            check(abs(float(a) - float(b)) <= 1e-5 * abs(float(a)),
                  "pipeline 4x1: power differs")
        else:
            check(np.array_equal(a, b), f"pipeline 4x1: output {i} differs")
    real1 = run((1, 1), real, False)
    real4 = run((4, 1), real, False)
    v1 = real1[0].view("<i2").astype(np.int32)
    v4 = real4[0].view("<i2").astype(np.int32)
    dl = np.abs(v1 - v4)
    check(int(dl.max()) <= 1 and float((dl > 0).mean()) < 1e-3,
          f"pipeline 4x1 preset-3: {int((dl > 0).sum())} samples differ, "
          f"max {int(dl.max())} LSB")
    return {"exact_bytes": True, "real_lsb_diffs": int((dl > 0).sum()),
            "real_samples": int(dl.size)}


# ----------------------------------------------------------------- main
PHASES = {"fixed": phase_fixed, "interpolated": phase_interpolated,
          "asrc": phase_asrc, "f64_chain": phase_f64_chain,
          "packed": phase_packed, "cli": phase_cli}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device path and its reference")
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cuda"
    import jax
    from art_jax._jaxinit import ensure_jax
    ensure_jax()
    require_gpu(jax)
    devs = jax.devices()
    print(nvidia_smi_line(), flush=True)
    print(f"# jax {jax.__version__}: {devs[0].platform} "
          f"{devs[0].device_kind} x{len(devs)}; compile cache "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)

    clock = PhaseClock()
    clock.listen(jax)
    phases = {"four": phase_four} if args.four else PHASES
    for name, fn in phases.items():
        t0 = time.perf_counter()
        out = fn(clock)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s "
              f"{json.dumps(out, default=float)}", flush=True)
    for name, row in clock.rows.items():
        c, w = row["cold"], row["warm"]
        print(f"# time {name}: cold {c['wall_s']:.3f} s (compile "
              f"{c['compile_s']:.3f} s, cache hits {c['cache_hits']}, "
              f"misses {c['cache_misses']}), warm {w['wall_s']:.3f} s",
              flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
