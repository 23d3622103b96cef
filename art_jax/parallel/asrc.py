"""Batched asynchronous sample-rate conversion (ASRC).

BASELINE config 5: hundreds of concurrent streams, each with a continuously
drifting ratio near 1.0 and an exactly recoverable phase position (the
feedback signal of an ASRC loop, reference resampler.c:937-968).  The
reference runs one context per stream; here all streams advance in one fused
device step:

  - per-call scalar accounting is vectorized over streams on the host
    (ratio is a runtime value per stream per call — never baked into the
    compiled kernel); emission counts and the phase-position query stay
    exact float64,
  - read positions are generated on device in float64 from
    (offset[s], ratio[s]) — the reference's double bookkeeping — and
    decomposed into window base + phase index + interpolation fraction,
  - the two-phase-interpolated windowed dot runs batched over
    [streams, outputs] as one XLA gather + lerp + reduce step
    (``_asrc_step``), in float32 or float64 alike.

All streams consume the same chunk length per call, so the history write
index is shared; only the fractional offsets differ per stream.
"""

from __future__ import annotations

import functools
import math

import numpy as np
from .._jaxinit import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp

from ..core.accounting import ring_floor
from ..core.filters import make_filter_bank
from ..core.flags import HISTORY_MULTIPLE, validate_taps_filters


# output columns per step tile; also the capacity bucket (_bucketed_k_max)
_TILE = 128


@functools.partial(jax.jit, static_argnames=("num_taps", "num_filters",
                                             "k_max", "hist_len"))
def _asrc_step(hist, x, bank, offsets, ratios, Ks, shift, num_taps: int,
               num_filters: int, k_max: int, hist_len: int):
    """One batched ASRC chunk.  hist [S, H]; x [S, n]; offsets f64 [S];
    ratios f64 [S]; Ks i32 [S]; shift maps linear history coordinates onto
    the device buffer (hist_len - valid_index).  Returns (new_hist,
    out [S, k_max] with k >= Ks zeroed)."""
    S = x.shape[0]
    half = num_taps // 2
    buf = jnp.concatenate([hist, x], axis=1)

    k = jnp.arange(k_max, dtype=jnp.float64)
    # positions use the fl(offset + k/ratio) sequence in CALL-ENTRY
    # coordinates (division, not a reciprocal product).  The host COUNTS
    # re-round in slid ring coordinates at float64 ties (_ring_ok) — at
    # such a tie the final emission's window base here can land one step
    # off the reference's; the position is value-continuous across that
    # flip (frac 0.9999.. <-> base+1, frac 0), so the sample stays at the
    # interpolation floor while the count remains exact
    pos = offsets[:, None] + k[None, :] / ratios[:, None]       # [S, K] f64
    ipos = jnp.floor(pos)
    ff = (pos - ipos) * num_filters
    fi = jnp.floor(ff).astype(jnp.int32)
    fi = jnp.minimum(fi, num_filters - 1)
    frac = (ff - fi).astype(bank.dtype)
    base = ipos.astype(jnp.int32) - half + 1 + shift

    taps_iota = jnp.arange(num_taps, dtype=jnp.int32)

    # tile the output axis so the [S, tile, T] gather intermediates stay
    # bounded regardless of chunk size
    tile = _TILE
    n_tiles = -(-k_max // tile)
    kp = n_tiles * tile
    base_p = jnp.pad(base, ((0, 0), (0, kp - k_max)))
    fi_p = jnp.pad(fi, ((0, 0), (0, kp - k_max)))
    frac_p = jnp.pad(frac, ((0, 0), (0, kp - k_max)))

    def tile_body(t, out):
        k0 = t * tile
        b = jax.lax.dynamic_slice(base_p, (0, k0), (S, tile))
        f = jax.lax.dynamic_slice(fi_p, (0, k0), (S, tile))
        fr = jax.lax.dynamic_slice(frac_p, (0, k0), (S, tile))
        idx = b[:, :, None] + taps_iota[None, None, :]          # [S, t, T]
        win = jnp.take_along_axis(buf[:, None, :],
                                  jnp.clip(idx, 0, buf.shape[1] - 1),
                                  axis=2)
        w = (jnp.take(bank, f, axis=0) * (1.0 - fr)[:, :, None]
             + jnp.take(bank, f + 1, axis=0) * fr[:, :, None])
        res = jnp.sum(win * w, axis=2)
        return jax.lax.dynamic_update_slice(out, res, (0, k0))

    out = jax.lax.fori_loop(0, n_tiles, tile_body,
                            jnp.zeros((S, kp), dtype=buf.dtype))[:, :k_max]
    valid = (jnp.arange(k_max, dtype=jnp.int32)[None, :] < Ks[:, None])
    out = out * valid.astype(out.dtype)
    new_hist = buf[:, buf.shape[1] - hist_len:]
    return new_hist, out


class BatchedASRC:
    """S independent drifting-ratio resampler streams, device-resident."""

    def __init__(self, num_streams: int, num_taps: int, num_filters: int,
                 *, dtype=np.float32, blackman_harris: bool = True,
                 mesh=None, lowpass_ratio: float = 1.0):
        """``mesh``: optional jax.sharding.Mesh with a "streams" axis; stream
        state and chunks are sharded across it, and each device runs the
        step on its own block of streams (streams are independent, so
        scale-out needs no collectives).  num_streams must be a multiple of
        the axis size."""
        validate_taps_filters(num_taps, num_filters)
        self.dtype = np.dtype(dtype)
        self.S = num_streams
        self.num_taps = num_taps
        self.num_filters = num_filters
        self.num_samples = num_taps * HISTORY_MULTIPLE
        # lowpass folds into the sinc argument exactly like the fixed
        # engines (reference init_filter, resampler.c:1111); 1.0 = none
        self.lowpass_ratio = float(lowpass_ratio)
        self.bank = make_filter_bank(num_taps, num_filters,
                                     self.lowpass_ratio, blackman_harris,
                                     self.dtype.type)
        self._bank_dev = jnp.asarray(self.bank)
        self.offsets = np.full(num_streams, float(num_taps // 2),
                               dtype=np.float64)
        self.input_index = num_taps
        self.flushed = np.zeros(num_streams, dtype=bool)
        self._flushed_pos = np.zeros(num_streams, dtype=np.float64)
        self.sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            self.sharding = NamedSharding(mesh, PartitionSpec("streams"))
        self.hist = jnp.zeros((num_streams, self.num_samples),
                              dtype=self.dtype)
        if self.sharding is not None:
            self.hist = jax.device_put(self.hist, self.sharding)

    def state_dict(self) -> dict:
        """Full streaming state (the SURVEY checkpoint/resume contract:
        state is (buffers, offsets, index) exactly like the reference
        context, resampler.h:44-58)."""
        return {
            "offsets": self.offsets.copy(),
            "input_index": int(self.input_index),
            "hist": np.asarray(self.hist),
            "flushed": self.flushed.copy(),
            "flushed_pos": self._flushed_pos.copy(),
        }

    def load_state(self, state: dict) -> None:
        self.offsets = np.asarray(state["offsets"], np.float64).copy()
        self.input_index = int(state["input_index"])
        self.flushed = np.asarray(
            state.get("flushed", np.zeros(self.S, bool))).copy()
        self._flushed_pos = np.asarray(
            state.get("flushed_pos", np.zeros(self.S))).copy()
        hist = jnp.asarray(np.asarray(state["hist"], self.dtype))
        if self.sharding is not None:
            hist = jax.device_put(hist, self.sharding)
        self.hist = hist

    def advance_position(self, delta) -> None:
        self.offsets += np.asarray(delta, dtype=np.float64)

    def get_position(self) -> np.ndarray:
        """Exact per-stream phase (reference resampler.c:965-968); frozen
        at flush time for FLUSHED streams (their context index stopped
        advancing with the batch)."""
        live = self.offsets + (self.num_taps / 2.0) - self.input_index
        return np.where(self.flushed, self._flushed_pos, live)

    def _ring_ok(self, ratios, k, n):
        """Emission-k feasibility with the reference's ring-coordinate
        slide re-rounding (resampler.c:500-501, 526): the loop compares
        fl((offset - s*S) + fl(k/ratio)) < bound - s*S, where s is the
        slide count at the emission's consume boundary — at a float64
        rounding tie this differs from the entry-coordinate compare
        fl(offset + k/ratio) < bound (the scalar form and full analysis:
        core.accounting._ring_floor).  ``k``: int array broadcastable
        against ratios; returns a bool array of the same shape."""
        offs = self.offsets
        q = np.asarray(k, np.int64) / ratios
        if q.ndim == 2:
            offs = offs[:, None]
        ip = ring_floor(offs, q, self.input_index, n, self.num_samples,
                        self.num_taps)
        return ip < (self.input_index + n - self.num_taps // 2)

    def _bucketed_k_max(self, req_k_max, estimate: int) -> int:
        """Static step capacity: bucket so per-call ratio drift cannot
        force a recompile of the jitted step (each distinct k_max is a
        distinct compilation).  An explicitly requested capacity buckets
        STRICTLY above itself so the host count at req_k_max is never
        clipped — otherwise a req that is a bucket multiple could not be
        told apart from saturation (an exactly-full request must be
        legal)."""
        bucket = _TILE
        want = estimate if req_k_max is None else req_k_max + 1
        kp = -(-want // bucket) * bucket
        # geometric coarsening (~1/16 granularity, still a tile multiple)
        # caps the distinct-bucket count at O(log) across any drift range
        # (a wide-drift endurance run otherwise sees a new capacity, and a
        # compile, every few calls) for <= 7% masked-out compute (the
        # per-stream Ks mask already zeroes the pad, so width only costs
        # throughput, never correctness).
        g = max(bucket, (kp >> 4) // bucket * bucket)
        return -(-kp // g) * g

    @staticmethod
    def _check_capacity(kmx: int, k_max: int, req_k_max, what: str) -> None:
        """Counts saturating the padded capacity are ambiguous (the
        estimate was clipped there); an EXACTLY-full requested capacity is
        not — the host count is exact and k_max > req_k_max by
        construction, so kmx == req_k_max is legal."""
        if kmx >= k_max or (req_k_max is not None and kmx > req_k_max):
            raise ValueError(f"k_max too small for {what}")

    def process(self, x, ratios, k_max: int | None = None):
        """x: device [S, n]; ratios: [S] per-call drifting ratios.

        Consumes all n inputs on every stream; emits K_s <= k_max outputs per
        stream (outputs beyond K_s zeroed).  Returns (out [S, k_max],
        Ks int [S])."""
        n = x.shape[1]
        half = self.num_taps // 2
        ratios = np.asarray(ratios, dtype=np.float64)
        # a latched stream's caller-supplied ratio is dead weight: it must
        # not inflate the auto capacity estimate; its Ks is zeroed below
        # and its offsets stay frozen via get_position, so 1.0 is inert
        ratios = np.where(self.flushed, 1.0, ratios)
        req_k_max = k_max
        k_max = self._bucketed_k_max(
            req_k_max, int(np.ceil((n + 2) * ratios.max())) + 2)

        # per-stream emission counts: pos_k = offset + k/ratio is strictly
        # increasing, so a closed-form estimate bracket-corrected at the
        # boundary reproduces the exact per-k comparison (the same float
        # ops per stream as core.accounting._count_emissions, including
        # the ring-coordinate slide re-rounding at ties) in O(S) instead
        # of materializing an [S, k_max] position grid
        bound = self.input_index + n - half
        est = np.floor((bound - self.offsets) * ratios).astype(np.int64)
        est = np.clip(est, 0, k_max)
        for _ in range(64):     # ok(est-1) and not ok(est) exactly
            over = (est > 0) & ~self._ring_ok(ratios, est - 1, n)
            under = (est < k_max) & self._ring_ok(ratios, est, n)
            if not (over.any() or under.any()):
                break
            est = est - over + under
        else:   # estimate off by >64: fall back to the exact grid —
            # counted as the reference's PREFIX (the loop ends at the
            # first blocked emission), not the total of feasible ks, in
            # case a slide-tie re-rounding ever makes ok(k) non-monotone
            ks = np.arange(k_max, dtype=np.int64)
            okg = self._ring_ok(ratios[:, None], ks[None, :], n)
            est = np.where(okg.all(axis=1), k_max,
                           np.argmin(okg, axis=1))
        Ks = est.astype(np.int32)
        Ks[self.flushed] = 0            # latched streams ignore input
        kmx = int(Ks.max(initial=0))
        self._check_capacity(kmx, k_max, req_k_max, "requested chunk")

        new_hist, out = self._run_step(x, ratios, Ks, k_max, req_k_max)
        self.hist = new_hist

        # advance per-stream offsets with the reference ring-slide
        # arithmetic (all streams consume the same count, so the write index
        # stays shared); exact-integer shifts preserve float-tie behavior
        slide = self.num_samples - self.num_taps
        n_slides = max(0, math.ceil(
            (self.input_index + n - self.num_samples) / slide))
        self.input_index = self.input_index + n - n_slides * slide
        self.offsets = (self.offsets - n_slides * slide) + Ks / ratios
        return out, Ks

    def flush(self, ratios, mask=None, k_max: int | None = None):
        """End the masked streams: emit their final half-filter of output
        from a zero postfill and latch them FLUSHED (reference
        postfillAllChannels + RESAMPLER_FLUSHED, resampler.c:663-698,
        438-439; the zero-postfill mode — endpoint extrapolation stays a
        host-engine feature).  Streams NOT in ``mask`` are untouched: the
        zero postfill never enters the shared history, so live streams
        keep serving.  Flushed streams return 0 outputs from later calls
        and their phase position freezes.

        Returns (out [S, k_max], Ks [S]) with rows outside ``mask`` zero.
        """
        half = self.num_taps // 2
        ratios = np.asarray(ratios, dtype=np.float64)
        if mask is None:
            mask = np.ones(self.S, dtype=bool)
        mask = np.asarray(mask, bool) & ~self.flushed

        # only masked streams emit; other streams' ratios must not steer
        # the capacity (see process())
        ratios = np.where(mask, ratios, 1.0)
        req_k_max = k_max
        k_max = self._bucketed_k_max(
            req_k_max, int(np.ceil((half + 2) * ratios.max())) + 2)

        # final emission counts: the zero postfill raises the input bound
        # by half and emission stops at idx_f - half = input_index
        # (reference resampler.c:882-918 flush simulation).  If the pad
        # would not fit, postfill slides the ring FIRST (resampler.c:667-
        # 672) and the emission compare then runs in slid coordinates —
        # an integer shift of both sides that re-rounds the float compare
        # at ties (same class as _ring_ok; no further slides occur during
        # flush, so one static shift suffices)
        shift = (self.num_samples - self.num_taps
                 if self.num_samples - self.input_index < half else 0)
        bound = self.input_index - shift
        ks = np.arange(k_max, dtype=np.float64)
        Ks = (((self.offsets - shift)[:, None] + ks[None, :]
               / ratios[:, None]) < bound).sum(axis=1).astype(np.int32)
        Ks[~mask] = 0
        kmx = int(Ks.max(initial=0))
        self._check_capacity(kmx, k_max, req_k_max, "flush")

        if kmx == 0:
            # nothing to emit (empty/already-flushed mask): skip the
            # device dispatch entirely — an unseen k_max bucket would
            # otherwise pay a compile for zeros
            out_cols = req_k_max if req_k_max is not None else k_max
            out = jnp.zeros((self.S, out_cols), dtype=self.dtype)
        else:
            x = jnp.zeros((self.S, half), dtype=self.dtype)
            _discard_hist, out = self._run_step(x, ratios, Ks, k_max,
                                                req_k_max)

        # the reference accumulates outputOffset in the slid coordinates
        # (oo_ring + offset2 rounds there); position = oo_f + half - idx_f
        final_ring = (self.offsets - shift) + Ks / ratios
        self._flushed_pos = np.where(
            mask, final_ring - (self.input_index - shift),
            self._flushed_pos)
        self.offsets = np.where(mask, final_ring + shift, self.offsets)
        self.flushed = self.flushed | mask
        return out, Ks

    def _run_step(self, x, ratios, Ks, k_max, req_k_max):
        """Run one batched chunk through the step and return (new_hist,
        out) without committing any engine state."""
        args = (self.hist, x, self._bank_dev, jnp.asarray(self.offsets),
                jnp.asarray(ratios), jnp.asarray(Ks),
                jnp.int32(self.num_samples - self.input_index))
        static = dict(num_taps=self.num_taps, num_filters=self.num_filters,
                      k_max=k_max, hist_len=self.num_samples)
        if self.sharding is None:
            new_hist, out = _asrc_step(*args, **static)
        else:
            new_hist, out = self._sharded_step(k_max)(*args)
        if req_k_max is not None and req_k_max != k_max:
            out = out[:, :req_k_max]
        return new_hist, out

    def _sharded_step(self, k_max: int):
        return _sharded_asrc_step(self.sharding.mesh, self.num_taps,
                                  self.num_filters, k_max, self.num_samples)


@functools.lru_cache(maxsize=64)
def _sharded_asrc_step(mesh, num_taps: int, num_filters: int, k_max: int,
                       hist_len: int):
    """The step under shard_map over the "streams" axis: each device runs
    it on its local block of streams, the bank replicates, and no
    collective is involved (the reference's threaded == unthreaded
    guarantee, workers.c:133-184, scaled out).  Cached per mesh and
    static shape, so engines on one mesh share one compilation."""
    from jax.sharding import PartitionSpec as P

    step = functools.partial(_asrc_step, num_taps=num_taps,
                             num_filters=num_filters, k_max=k_max,
                             hist_len=hist_len)
    st, s1 = P("streams", None), P("streams")
    return jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(st, st, P(None, None), s1, s1, s1, P()),
        out_specs=(st, st), check_vma=False))


class ASRCStreamResampler:
    """artest/host-API adapter over BatchedASRC: the runtime-ratio
    interpolated resampler on device, channels riding as streams.

    This is the device form of the reference's plain ``resampleInit`` +
    per-call-ratio ``resampleProcess`` contract (reference
    resampler.c:433-541 with SUBSAMPLE_INTERPOLATE; the ASRC usage
    pattern, SURVEY §3.5) — the path ``artest`` takes WITHOUT ``-e``
    (reference artest.c:380-437).  Exposes the host engine's
    ``process_interleaved`` / ``process_and_flush_interleaved`` surface
    so the artest CLI is agnostic.

    Counts and positions are exact vs the C semantics (the engine's
    ring-tie bracket, core.accounting); output samples sit at the f32
    floor of the host engine.
    """

    def __init__(self, num_channels: int, num_taps: int, num_filters: int,
                 lowpass_ratio: float, flags: int, *, dtype=np.float32):
        from ..core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                                  SUBSAMPLE_INTERPOLATE)
        from ..core.filters import resolve_lowpass
        if not (flags & SUBSAMPLE_INTERPOLATE):
            raise ValueError("ASRCStreamResampler is the interpolated "
                             "runtime-ratio engine; pass "
                             "SUBSAMPLE_INTERPOLATE (use the fixed-ratio "
                             "device engines otherwise)")
        if flags & EXTRAPOLATE_ENDPOINTS:
            raise ValueError("EXTRAPOLATE_ENDPOINTS is not modeled by the "
                             "device ASRC engine; use the host Resampler")
        lowpass_ratio, flags = resolve_lowpass(lowpass_ratio, flags)
        self._ch = num_channels
        self.flags = flags
        self.lowpass_ratio = lowpass_ratio
        self.num_taps = num_taps
        self.asrc = BatchedASRC(num_channels, num_taps, num_filters,
                                dtype=dtype,
                                blackman_harris=bool(flags
                                                     & BLACKMAN_HARRIS),
                                lowpass_ratio=lowpass_ratio)
        self.dtype = self.asrc.dtype

    # ------------------------------------------------------------- queries
    def advance_position(self, delta: float) -> None:
        self.asrc.advance_position(float(delta))

    def get_position(self) -> float:
        return float(self.asrc.get_position()[0])

    def get_lowpass_ratio(self) -> float:
        return self.lowpass_ratio

    def get_num_filters(self) -> int:
        return self.asrc.num_filters

    def interpolation_used(self) -> int:
        return 1

    # ------------------------------------------------------------- process
    def _ratios(self, ratio: float) -> np.ndarray:
        if not ratio or ratio <= 0.0:
            raise ValueError("the runtime-ratio engine needs a positive "
                             "per-call ratio (reference resampleProcess "
                             "ratio argument)")
        return np.full(self._ch, float(ratio), np.float64)

    def process_interleaved(self, data, n_in: int, n_out: int,
                            ratio: float = 0.0):
        """Reference resampleProcessInterleaved semantics for the artest
        harness shape: consumes all n_in frames (the harness sizes n_out
        to worst case and treats saturation as fatal, artest.c:486-489);
        flush via n_in < 0.  Returns ([K, ch] host array,
        ResampleResult)."""
        from ..engines.resampler import ResampleResult
        if n_in is not None and n_in < 0:
            return self._flush(n_out, ratio)
        x = jnp.asarray(np.ascontiguousarray(
            np.asarray(data)[:n_in].T, dtype=self.dtype))
        out, Ks = self.asrc.process(x, self._ratios(ratio), k_max=n_out)
        return self._frames(out, Ks), ResampleResult(n_in, int(Ks[0]))

    def _flush(self, n_out: int, ratio: float):
        from ..engines.resampler import ResampleResult
        out, Ks = self.asrc.flush(self._ratios(ratio), k_max=n_out)
        return self._frames(out, Ks), ResampleResult(0, int(Ks[0]))

    def _frames(self, out, Ks) -> np.ndarray:
        """[ch, k_max] device output -> [K, ch] host frames; every channel
        runs at the same ratio, so all emit the same count K."""
        K = int(Ks[0])
        assert (Ks == K).all()
        return np.ascontiguousarray(
            np.asarray(out[:, :K]).T.astype(self.dtype))

    def process(self, data, n_in: int, n_out: int, ratio: float = 0.0):
        """Planar form (host-engine contract: [ch, n] in, [ch, K] out)."""
        inter = None if data is None else \
            np.ascontiguousarray(np.asarray(data).T)
        out, res = self.process_interleaved(inter, n_in, n_out, ratio)
        return np.ascontiguousarray(out.T), res

    def process_and_flush_interleaved(self, data, n_in: int, n_out: int,
                                      ratio: float = 0.0):
        """Process the final block then flush in one call (reference
        resampleProcessAndFlushInterleaved, resampler.c:741-758)."""
        out1, res = self.process_interleaved(data, n_in, n_out, ratio)
        out2, fres = self._flush(n_out - res.output_generated, ratio)
        res.output_generated += fres.output_generated
        return np.concatenate([out1, out2], axis=0), res

    def process_and_flush(self, data, n_in: int, n_out: int,
                          ratio: float = 0.0):
        inter = None if data is None else \
            np.ascontiguousarray(np.asarray(data).T)
        out, res = self.process_and_flush_interleaved(inter, n_in, n_out,
                                                      ratio)
        return np.ascontiguousarray(out.T), res
