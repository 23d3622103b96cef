"""Device-resident streaming engines.

The host-side ``engines.resampler.Resampler`` round-trips audio through host
memory every call — correct, but device->host transfers and per-call
dispatch are the costs a device pipeline avoids.  This engine keeps audio
and history on device; the host performs only scalar consume/emit
accounting per chunk (core/accounting.py), and results stay on device until
the caller reduces or fetches them.

Kernel shape:  the fixed-ratio steady state is *exactly* periodic (see
ops/polyphase.py), so each chunk becomes a single fused XLA computation:

  history concat -> residue-split block-Toeplitz contraction (qn pure
  reshape-of-slice views, each dotted K=qn*M against the padded [qn*M, L]
  phase matrix — no gather; see pipeline.residue_window_dots) -> history
  extraction.

The contraction is a plain dot_general, which XLA hands to a GEMM library;
per-chunk host dispatch pipelines fine as long as nothing synchronizes
mid-stream, and ``process_scan`` batches G chunks into one dispatch for
fetch-coupled serving loops.  (The formulation and dispatch forms were
chosen on the earlier accelerator; not yet measured on the H100.)
"""

from __future__ import annotations

import functools
import math

import numpy as np
from .._jaxinit import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp

from ..core import accounting
from ..core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                          EXTRAPOLATE_PREFILL, INCLUDE_LOWPASS,
                          SUBSAMPLE_INTERPOLATE)
from ..core.filters import (make_filter_bank, plan_fixed_ratio,
                            resolve_lowpass)
from ..ops.polyphase import PolyphaseMatrix
from .pipeline import _resample_block, residue_window_dots


def _chunk_body(hist, x, P, start, K, acc, M, L, nb, qn, hist_len,
                precise=False):
    """The fused streaming step: history concat -> block-Toeplitz window
    build (static shifted slices, no gather) -> residue-split matmuls
    against the padded [qn*M, L] phase matrix (pipeline.residue_window_dots)
    -> validity mask -> power accumulate -> history extraction.  start is
    the window origin in the padded buffer; outputs beyond K are zeroed;
    acc carries running output power so streaming statistics add no extra
    dispatches.  The window/dot/mask math is pipeline._resample_block (the
    sharded production step with a trivial shard); precision is pinned to
    HIGHEST inside residue_window_dots: a reduced-precision dot (bf16, or
    TF32 on a GPU) loses tens of dB of output SNR — full float32 keeps the
    C reference's -142 dB round-trip."""
    out, new_hist = _resample_block(
        x, hist, P, start, K, M=M, L=L, nb=nb, qn_pad=qn, qn_local=qn,
        hist_len=hist_len, q0=jnp.int32(0), taps_axis=None,
        precise=precise)
    acc = acc + jnp.sum(out * out)
    return new_hist, out, acc



@functools.partial(jax.jit, static_argnames=("M", "L", "nb", "qn",
                                             "hist_len", "stats",
                                             "precise"))
def _chunk_scan_step(hist, xs, P_all, meta, acc, M: int, L: int, nb: int,
                     qn: int, hist_len: int, stats: bool = False,
                     precise: bool = False):
    """G fused steady-state chunk steps in ONE dispatch: lax.scan over
    _chunk_body with the phase-anchor matrix dynamically indexed from the
    stacked bank ``P_all`` [L, qn*M, L] per step.  Amortizes per-dispatch
    host overhead where a result fetch couples to each group (serving
    loops); outputs are bitwise-identical to sequential process().
    ``meta`` [3, G] int32 packs (j0, start, K) rows so each call uploads
    ONE small array.  ``stats=True`` consumes each chunk's outputs
    in-graph (the power accumulator IS the consumer — the artest harness
    analog, reference artest.c:491 update_stats over a cache-resident
    scratch) and returns outs=None: no [G, ch, nb*L] materialization in
    device memory."""
    def body(carry, per):
        hist, acc = carry
        x, j, start, K = per
        P = jax.lax.dynamic_index_in_dim(P_all, j, axis=0, keepdims=False)
        hist, out, acc = _chunk_body(hist, x, P, start, K, acc, M, L, nb,
                                     qn, hist_len, precise)
        return (hist, acc), (None if stats else out)
    (hist, acc), outs = jax.lax.scan(
        body, (hist, acc), (xs, meta[0], meta[1], meta[2]))
    return hist, outs, acc


@functools.partial(jax.jit, static_argnames=("M", "L", "nb", "qn",
                                             "hist_len", "precise"))
def _chunk_step(hist, x, P, start, K, acc, M: int, L: int, nb: int,
                qn: int, hist_len: int, precise: bool = False):
    """One fused streaming step (see _chunk_body)."""
    return _chunk_body(hist, x, P, start, K, acc, M, L, nb, qn, hist_len,
                       precise)


@functools.partial(jax.jit, static_argnames=("start", "K", "M", "L", "nb",
                                             "qn", "hist_len", "stats",
                                             "precise"))
def _chunk_scan_step_static(hist, xs, P, acc, start: int, K: int, M: int,
                            L: int, nb: int, qn: int, hist_len: int,
                            stats: bool = False, precise: bool = False):
    """G fused chunk steps in one dispatch with a COMPILE-TIME-CONSTANT
    plan: when the chunk size is a multiple of the input period M, the
    fixed-ratio steady state consumes/emits identically every chunk
    (same K, same window origin, same phase anchor), so start/K become
    static — the window dynamic_slice canonicalizes to a static slice
    XLA can fuse (no materialized window copy) and the validity mask
    constant-folds.  Bitwise-identical outputs to _chunk_scan_step.
    ``stats=True``: outputs consumed in-graph by the power accumulator
    (see _chunk_scan_step), outs=None."""
    def body(carry, x):
        hist, acc = carry
        # static ints become int32 literals inside the trace (graph
        # constants — NOT traced operands like _chunk_scan_step's meta)
        hist, out, acc = _chunk_body(hist, x, P, jnp.int32(start),
                                     jnp.int32(K), acc, M, L, nb, qn,
                                     hist_len, precise)
        return (hist, acc), (None if stats else out)
    (hist, acc), outs = jax.lax.scan(body, (hist, acc), xs)
    return hist, outs, acc


def _group_buf(hist, xs_flat, start: int, xlen: int, G: int, n: int,
               hist_len: int):
    """Shared flat-group prologue: ONE contiguous stream [hist ++ xs_flat
    (++ zero tail)] so chunk g's block-Toeplitz window is a STATIC slice
    at g*n + start, plus the advanced history (the last hist_len columns
    of hist++xs)."""
    ch = xs_flat.shape[0]
    tail = (G - 1) * n + start + xlen - (hist_len + G * n)
    parts = [hist, xs_flat]
    if tail > 0:
        parts.append(jnp.zeros((ch, tail), dtype=xs_flat.dtype))
    buf = jnp.concatenate(parts, axis=1)
    new_hist = jax.lax.slice(buf, (0, G * n), (ch, hist_len + G * n))
    return buf, new_hist


@functools.partial(jax.jit, static_argnames=(
    "start", "K", "G", "n", "M", "L", "nb", "qn", "hist_len", "precise"))
def _chunk_group_static(hist, xs_flat, P, acc, start: int, K: int, G: int,
                        n: int, M: int, L: int, nb: int, qn: int,
                        hist_len: int, precise: bool = False):
    """G periodic steady-state chunks over ONE flat input buffer, fully
    static (no lax.scan): because the steady state is exactly periodic
    (M-multiple chunks — the _chunk_scan_step_static precondition), the
    whole group is one contiguous stream [hist ++ xs_flat] and chunk g's
    block-Toeplitz window is a STATIC slice at g*n + start.  That removes
    the two copies the scanned form pays per chunk (the scan's per-step
    xs slice materialization and the per-chunk history concat write); XLA
    can fuse the static window slices straight into the dot operand
    reads.

    Blocks past each chunk's K read real next-chunk samples here (the
    per-chunk form reads zero padding) but are masked to zero after the
    dot, so outputs/acc/hist are bitwise-identical to sequential
    process() (tests/test_parallel.py).  Outputs are consumed in-graph by
    the power accumulator (stats form — the headline-bench contract);
    returns (new_hist, acc)."""
    ch = xs_flat.shape[0]
    nb_rs = -(-nb // qn) * qn
    xlen = (nb_rs + qn) * M
    buf, new_hist = _group_buf(hist, xs_flat, start, xlen, G, n, hist_len)
    valid = (jnp.arange(nb * L, dtype=jnp.int32) < K)
    for g in range(G):
        off = g * n + start
        win = jax.lax.slice(buf, (0, off), (ch, off + xlen))
        out = residue_window_dots(win, P, M=M, nb_rs=nb_rs, qn_pad=qn,
                                  qn_local=qn, q0=jnp.int32(0),
                                  precise=precise)
        out = jax.lax.slice(out, (0, 0, 0), (ch, nb, L)).reshape(ch, nb * L)
        out = out * valid.astype(out.dtype)[None, :]
        acc = acc + jnp.sum(out * out)
    return new_hist, acc


@functools.partial(jax.jit, static_argnames=(
    "start", "K", "G", "n", "M", "L", "nb", "qn", "hist_len", "precise"))
def _chunk_group_static_interp(hist, xs_flat, P2, fracv, acc, start: int,
                               K: int, G: int, n: int, M: int, L: int,
                               nb: int, qn: int, hist_len: int,
                               precise: bool = False):
    """Interpolated-mode flat group (see _chunk_group_static): G periodic
    chunks with a REPEATING phase pattern (one banked [qn*M, 2L] matrix +
    fraction vector) as one fully-static dispatch; outputs consumed
    in-graph by the power accumulator.  Bitwise-identical to sequential
    process() on the same plan."""
    ch = xs_flat.shape[0]
    nb_rs = -(-nb // qn) * qn
    xlen = (nb_rs + qn) * M
    buf, new_hist = _group_buf(hist, xs_flat, start, xlen, G, n, hist_len)
    valid = (jnp.arange(nb * L, dtype=jnp.int32) < K)
    f = fracv[None, None, :]
    for g in range(G):
        off = g * n + start
        win = jax.lax.slice(buf, (0, off), (ch, off + xlen))
        dd = residue_window_dots(win, P2, M=M, nb_rs=nb_rs, qn_pad=qn,
                                 qn_local=qn, q0=jnp.int32(0),
                                 precise=precise)
        dd = jax.lax.slice(dd, (0, 0, 0), (ch, nb, 2 * L))
        out = dd[:, :, :L] * (1.0 - f) + dd[:, :, L:] * f
        out = out.reshape(ch, nb * L) * valid.astype(out.dtype)[None, :]
        acc = acc + jnp.sum(out * out)
    return new_hist, acc


def _group_chunk_out(buf, P2, fracv, g: int, *, start: int, K: int, n: int,
                     M: int, L: int, nb: int, qn: int,
                     precise: bool = False):
    """One flat-group chunk's VALID output samples [ch, K]: static window
    slice -> residue dots (banked + lerp when ``fracv`` is given) -> static
    slice to the first K columns.  K is a compile-time constant in the
    flat-group form, so slicing replaces the validity mask (identical
    values on the kept columns — the mask only zeroes the discarded
    tail)."""
    ch = buf.shape[0]
    nb_rs = -(-nb // qn) * qn
    xlen = (nb_rs + qn) * M
    off = g * n + start
    win = jax.lax.slice(buf, (0, off), (ch, off + xlen))
    dd = residue_window_dots(win, P2, M=M, nb_rs=nb_rs, qn_pad=qn,
                             qn_local=qn, q0=jnp.int32(0), precise=precise)
    # flatten at nb_rs (the contraction's own row-major order — a pure
    # reshape of the banded dot's [ch, nr, qn*L2] result) and slice the
    # valid K prefix directly: slicing to nb FIRST forces a physical
    # relayout of the dot output; K <= nb*L <= nb_rs*L so the kept samples
    # are identical either way
    if fracv is not None:
        f = fracv[None, None, :]
        out = dd[:, :, :L] * (1.0 - f) + dd[:, :, L:] * f
        out = out.reshape(ch, nb_rs * L)
    else:
        out = dd.reshape(ch, nb_rs * L)
    return jax.lax.slice(out, (0, 0), (ch, K))


@functools.partial(jax.jit, static_argnames=(
    "start", "K", "G", "n", "M", "L", "nb", "qn", "hist_len", "precise"))
def _chunk_group_static_out(hist, xs_flat, P2, fracv, start: int, K: int,
                            G: int, n: int, M: int, L: int, nb: int,
                            qn: int, hist_len: int, precise: bool = False):
    """Flat-group steady state DELIVERING the audio: G periodic chunks as
    one fully-static dispatch (see _chunk_group_static) whose result is
    the valid output samples [ch, G*K] materialized in device memory —
    the form for
    callers that receive real output buffers (reference
    resampler.c:523-527).  No validity mask and no power pass: K is
    static, so each chunk's valid prefix is a static slice and XLA fuses
    the concat write into the dot epilogues (the kept samples are
    bitwise-identical to the masked stats form).  ``fracv=None`` selects
    the reduced mode; otherwise P2/fracv are the banked interp matrix and
    lerp fractions.  Returns (out [ch, G*K], new_hist)."""
    nb_rs = -(-nb // qn) * qn
    xlen = (nb_rs + qn) * M
    buf, new_hist = _group_buf(hist, xs_flat, start, xlen, G, n, hist_len)
    outs = [_group_chunk_out(buf, P2, fracv, g, start=start, K=K, n=n,
                             M=M, L=L, nb=nb, qn=qn, precise=precise)
            for g in range(G)]
    return jnp.concatenate(outs, axis=1), new_hist


def _floor_half_up_exact(code):
    """floor(float64(code) + 0.5) computed exactly in f32/int32 ops.

    float64(code) + 0.5 is exact (24-bit mantissa shifted <= 2^16 for the
    |code| < 2^23 quantizer range), so the f64 floor equals
    floor(code) + (code - floor(code) >= 0.5); both floor(code) and the
    fractional part are exact in f32 (Sterbenz), and the >= compare is
    exact — bit-identical to the reference's double rounding
    (decimator.c:163) without any f64 pointwise math on device."""
    f = jnp.floor(code)
    return f.astype(jnp.int32) + (code - f >= 0.5).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=(
    "scaler", "start", "K", "G", "n", "M", "L", "nb", "qn", "hist_len",
    "output_bits", "output_bytes", "precise"))
def _chunk_group_static_packed(hist, xs_flat, P2, fracv, scaler, clips,
                               start: int, K: int, G: int, n: int, M: int,
                               L: int, nb: int, qn: int, hist_len: int,
                               highclip: int, lowclip: int,
                               output_bits: int, output_bytes: int,
                               precise: bool = False):
    """Flat-group steady state fused through ditherless quantization and
    LE byte packing: resample -> scale -> round-half-up -> clip -> pack,
    all in the dense [ch, nK] orientation, packed bytes [ch,
    G*K*output_bytes] as the only audio leaving the graph (half the
    device-memory bytes of the f32 form at 16-bit).  The quantizer is the
    no-dither no-shaping decimator configuration (reference decimator.c:152-194
    with dither=0, feedback=0), bit-exact via _floor_half_up_exact;
    clipped-sample counts accumulate into ``clips`` (i32).  Returns
    (packed u8 [ch, G*K*output_bytes], clips', new_hist)."""
    nb_rs = -(-nb // qn) * qn
    xlen = (nb_rs + qn) * M
    buf, new_hist = _group_buf(hist, xs_flat, start, xlen, G, n, hist_len)
    sc = jnp.asarray(scaler, xs_flat.dtype)
    # scaler = 2^(bits-1) * gain; at gain 1.0 (the delivery configs) it
    # is a power of two, and fl32(u * 2^k) is EXACT (pure exponent
    # shift; overflow -> inf on both routes), so the plain f32 multiply
    # is bit-identical to the reference's double-precision product
    # rounding — and avoids _mul_for's f64 pointwise chain +
    # reduce_precision barrier on device.
    if float(scaler) > 0 and math.frexp(float(scaler))[0] == 0.5:
        def mul(u, v):
            return u * v
    else:
        from ..ops.decimate_device import _mul_for
        mul = _mul_for(xs_flat.dtype)
    pre_zeros = output_bytes - ((output_bits + 7) // 8)
    offset = 128 if output_bits <= 8 else 0
    leftshift = (24 - output_bits) % 8
    # container dtype: the packed samples stay dense [ch, K] in a
    # u8/u16/u32 whose little-endian byte view IS the packed stream, so a
    # byte-interleaved [ch, K, output_bytes] u8 array with a tiny minor
    # dim is never materialized
    cdt = {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32}[output_bytes]
    used_mask = jnp.uint32((1 << (8 * ((output_bits + 7) // 8))) - 1)
    packs = []
    for g in range(G):
        out = _group_chunk_out(buf, P2, fracv, g, start=start, K=K, n=n,
                               M=M, L=L, nb=nb, qn=qn, precise=precise)
        code = mul(out, sc)
        ov = _floor_half_up_exact(code)
        clips = clips + jnp.sum((ov > highclip) | (ov < lowclip),
                                dtype=jnp.int32)
        ov = jnp.clip(ov, lowclip, highclip)
        v = (ov.astype(jnp.uint32) << jnp.uint32(leftshift)) \
            + jnp.uint32(offset)
        v = (v & used_mask) << jnp.uint32(8 * pre_zeros)
        packs.append(v.astype(cdt))
    return jnp.concatenate(packs, axis=1), clips, new_hist


def _chunk_body_interp(hist, x, P2, fracv, start, K, acc, M: int, L: int,
                       nb: int, qn: int, hist_len: int,
                       precise: bool = False):
    """Interpolated fixed-rational chunk body: P2 stacks the two adjacent
    phase banks ([qn*M, 2L]); the per-phase lerp fractions broadcast over
    output blocks (reference subsample_interpolate, resampler.c:1147-1157,
    factored dot-then-lerp).  One implementation: the sharded production
    body with a trivial shard (no mesh axes)."""
    return _sharded_interp_body(hist, x, P2, fracv, start, K, acc, M=M,
                                L=L, nb=nb, qn_pad=qn, qn_local=qn,
                                hist_len=hist_len, taps_axis=None,
                                streams_axis=None, precise=precise)


@functools.partial(jax.jit, static_argnames=("M", "L", "nb", "qn",
                                             "hist_len", "precise"))
def _chunk_step_interp(hist, x, P2, fracv, start, K, acc, M: int, L: int,
                       nb: int, qn: int, hist_len: int,
                       precise: bool = False):
    """One fused interpolated streaming step (see _chunk_body_interp)."""
    return _chunk_body_interp(hist, x, P2, fracv, start, K, acc, M, L, nb,
                              qn, hist_len, precise)


@functools.partial(jax.jit, static_argnames=("start", "K", "M", "L", "nb",
                                             "qn", "hist_len", "stats",
                                             "precise"))
def _chunk_scan_step_interp_static(hist, xs, P2, fracv, acc, start: int,
                                   K: int, M: int, L: int, nb: int,
                                   qn: int, hist_len: int,
                                   stats: bool = False,
                                   precise: bool = False):
    """Interpolated scan with a compile-time-constant plan (periodic
    steady state AND a repeating phase pattern — the M-multiple chunk
    case; see _chunk_scan_step_static): one banked matrix / fraction
    vector, static start/K.  Bitwise-identical to the scanned-meta
    form.  ``stats=True``: outputs consumed in-graph (see
    _chunk_scan_step), outs=None."""
    def body(carry, x):
        hist, acc = carry
        hist, out, acc = _chunk_body_interp(
            hist, x, P2, fracv, jnp.int32(start), jnp.int32(K), acc, M, L,
            nb, qn, hist_len, precise)
        return (hist, acc), (None if stats else out)
    (hist, acc), outs = jax.lax.scan(body, (hist, acc), xs)
    return hist, outs, acc


@functools.partial(jax.jit, static_argnames=("M", "L", "nb", "qn",
                                             "hist_len", "stats",
                                             "precise"))
def _chunk_scan_step_interp(hist, xs, P2s, frs, meta, acc, M: int, L: int,
                            nb: int, qn: int, hist_len: int,
                            stats: bool = False, precise: bool = False):
    """G interpolated chunk steps in ONE dispatch (see _chunk_scan_step;
    here the per-chunk banked matrix [qn*M, 2L] and lerp fractions ride
    as scanned inputs instead of a stacked-bank index).  ``stats=True``:
    outputs consumed in-graph (see _chunk_scan_step), outs=None."""
    def body(carry, per):
        hist, acc = carry
        x, P2, fracv, start, K = per
        hist, out, acc = _chunk_body_interp(hist, x, P2, fracv, start, K,
                                            acc, M, L, nb, qn, hist_len,
                                            precise)
        return (hist, acc), (None if stats else out)
    (hist, acc), outs = jax.lax.scan(
        body, (hist, acc), (xs, P2s, frs, meta[0], meta[1]))
    return hist, outs, acc


@functools.partial(jax.jit, static_argnames=("rows", "L", "T"))
def _build_interp_matrix(bank, d, fi, rows: int, L: int, T: int):
    """Construct the stacked interpolated matrices [rows, 2L] on device
    from the per-phase pattern vectors (window offsets d[L], filter
    indices fi[L]) — only ~2 KB crosses host->device per new pattern
    instead of the ~MB matrix itself."""
    r = jnp.arange(rows, dtype=jnp.int32)[:, None]
    offs = r - d[None, :]                              # [rows, L]
    valid = (offs >= 0) & (offs < T)
    oc = jnp.clip(offs, 0, T - 1)
    P1 = jnp.where(valid, bank[fi[None, :], oc], 0.0)
    P2 = jnp.where(valid, bank[fi[None, :] + 1, oc], 0.0)
    return jnp.concatenate([P1, P2], axis=1)


def _sharded_interp_body(hist, x, P2l, fracv, start, K, acc, *, M: int,
                         L: int, nb: int, qn_pad: int, qn_local: int,
                         hist_len: int, taps_axis, streams_axis,
                         precise: bool = False):
    """Interpolated chunk body over a local range of shift blocks: each
    taps-rank contracts its slice of the stacked [qn_pad*M, 2L] interp
    matrix, the psum completes the banked dots, and the phase lerp runs on
    the replicated sum (reference subsample_interpolate,
    resampler.c:1147-1157, scaled out).  Window build / output masking are
    the shared pipeline helpers (_window_and_hist / _mask_outputs)."""
    from .pipeline import _mask_outputs, _window_and_hist
    ch = x.shape[0]
    nb_rs = -(-nb // qn_pad) * qn_pad
    win, new_hist = _window_and_hist(x, hist, start,
                                     (nb_rs + qn_pad) * M, hist_len)
    q0 = jnp.int32(0)
    if taps_axis is not None:
        q0 = jax.lax.axis_index(taps_axis).astype(jnp.int32) * qn_local
    defer = precise and taps_axis is not None
    dd = residue_window_dots(win, P2l, M=M, nb_rs=nb_rs, qn_pad=qn_pad,
                             qn_local=qn_local, q0=q0, precise=precise,
                             defer_round=defer)
    if taps_axis is not None:
        dd = jax.lax.psum(dd, taps_axis)
    if defer:
        dd = dd.astype(x.dtype)
    dd = jax.lax.slice(dd, (0, 0, 0), (ch, nb, 2 * L))
    f = fracv[None, None, :]
    out = dd[:, :, :L] * (1.0 - f) + dd[:, :, L:] * f
    out = _mask_outputs(out, K, ch, nb, L)
    power = jnp.sum(out * out)
    if streams_axis is not None:
        power = jax.lax.psum(power, streams_axis)
    acc = acc + power
    return new_hist, out, acc


class DeviceStreamResampler:
    """Fixed-ratio streaming resampler with device-resident state.

    Supports reduced (non-interpolated) configurations — the reference's
    fast path (resampleFixedRatioInit with successful filter reduction,
    reference resampler.c:321-335) — and interpolated configurations whose
    ratio is exactly rational with a workable period (two banked matmuls +
    per-phase lerp; see _chunk_step_interp).  Endpoint extrapolation is not
    supported here; use the host engine (or HybridStreamResampler) when
    EXTRAPOLATE_ENDPOINTS is needed.

    ``mesh``: optional jax.sharding.Mesh with a "streams" axis (and
    optionally a "taps" axis).  Channel/stream rows shard data-parallel
    over "streams" (rows pad up to a multiple of the axis size; pad rows
    are inert) and the polyphase contraction shards tensor-parallel over
    "taps" with one psum — the multi-chip analog of the reference's
    per-channel worker pool on its shipped engines (reference
    resampler.c:441-484).  Streams-only sharding is bit-identical to the
    single-device step (same per-row float ops); taps sharding
    reassociates the qn-term sum and sits at the f32 matmul floor.
    """

    def __init__(self, num_channels: int, num_taps: int, max_filters: int,
                 source_rate: float, destin_rate: float, lowpass_freq: float,
                 flags: int, *, dtype=np.float32, mesh=None,
                 precise: bool = False):
        if flags & EXTRAPOLATE_ENDPOINTS:
            # fail fast: the device engine does not model endpoint
            # extrapolation (prefill/postfill) — silently emitting
            # non-extrapolated edges would diverge from the reference.
            # HybridStreamResampler strips this flag for its device part
            # and runs the edges on the host engine.
            raise ValueError("EXTRAPOLATE_ENDPOINTS is not modeled by the "
                             "device engine; use HybridStreamResampler or "
                             "the host Resampler")
        plan = plan_fixed_ratio(num_taps, max_filters, source_rate,
                                destin_rate, lowpass_freq, flags)
        self.interp = bool(plan.flags & SUBSAMPLE_INTERPOLATE)
        if self.interp:
            # interpolated configs are supported when the ratio is exactly
            # rational with a workable period: the phase pattern then
            # repeats every Lp outputs / Mp inputs and the chunk becomes
            # two banked matmuls + a per-phase lerp
            if not (float(source_rate).is_integer()
                    and float(destin_rate).is_integer()):
                raise ValueError("interpolated device resampling needs "
                                 "integral rates (exact rational ratio)")
            g = math.gcd(int(source_rate), int(destin_rate))
            Lp, Mp = int(destin_rate) // g, int(source_rate) // g
            qn_i = -(-(Mp + num_taps) // Mp)
            if Lp > 1024 or qn_i * Mp * 2 * Lp > 4 << 20:
                raise ValueError("rational period too large for the device "
                                 "interpolated path")
        self.dtype = np.dtype(dtype)
        self.num_channels = num_channels
        self.num_taps = num_taps
        self.num_filters = plan.num_filters
        self.num_samples = num_taps * 16
        self.flags = plan.flags
        self.fixed_ratio = plan.fixed_ratio
        # mirror the host engine's resolve_lowpass BOTH ways (reference
        # resampler.c:120-125): a ratio in (0,1) must SET INCLUDE_LOWPASS
        # (else the phase-0 passthrough shortcut would bypass the filter),
        # an out-of-range ratio clears it
        lowpass_ratio, self.flags = resolve_lowpass(plan.lowpass_ratio,
                                                    self.flags)
        self.lowpass_ratio = lowpass_ratio
        self.bank = make_filter_bank(num_taps, self.num_filters,
                                     lowpass_ratio,
                                     bool(flags & BLACKMAN_HARRIS),
                                     self.dtype.type)
        if self.interp:
            self.L, self.M = Lp, Mp
        else:
            self.L = self.num_filters
            self.M = int(round(self.L / self.fixed_ratio))
        self.qn = -(-(self.M + num_taps) // self.M)
        # precise modes, f32 data only (the f64 path accumulates in f64
        # natively):
        #   True   — f64-accumulated contraction dots, rounded once
        #            (residue_window_dots docstring);
        #   "int8" — int8 fixed-point (Ozaki-split) dots at the SAME
        #            single-rounding accuracy floor (ozaki_window_dots
        #            docstring; round-trip lands BETTER than the C
        #            reference).
        # Their costs were measured on the earlier accelerator; not yet on
        # the H100.
        if precise == "int8":
            if self.dtype != np.float32:
                raise ValueError("precise='int8' is the f32 data path's "
                                 "fixed-point mode")
            if mesh is not None:
                raise NotImplementedError("precise='int8' is single-shard "
                                          "(use precise=True under a mesh)")
            self._precise = "int8"
            from .pipeline import OzakiPlan
            self._ozaki_sp = OzakiPlan.scale_for(
                max(float(np.abs(self.bank).max()), 1.0))
            self._plans: dict[int, object] = {}
        else:
            self._precise = bool(precise and self.dtype == np.float32)
        self._interp_cache: dict = {}
        self._pattern_safe_cache: dict = {}
        self._last_interp = None           # steady-state pattern reuse
        self._flushed = False

        self.mesh = mesh
        self._rows = num_channels
        if mesh is not None:
            nstr = mesh.shape["streams"]
            self._ntap = mesh.shape.get("taps", 1)
            self._rows = -(-num_channels // nstr) * nstr
            self._qn_pad = -(-self.qn // self._ntap) * self._ntap
            self._sharded_cache: dict = {}

        self.output_offset = float(num_taps // 2)
        self.input_index = num_taps
        self.hist = jnp.zeros((self._rows, self.num_samples),
                              dtype=self.dtype)
        self._mats: dict[int, jax.Array] = {}
        self._mats_stacked = None
        self._bank_dev = None

    # ----------------------------------------------------------------- api
    def advance_position(self, delta: float) -> None:
        if delta < 0.0 or (not self.interp and math.floor(delta) != delta):
            raise ValueError("fractional advances need an interpolated "
                             "configuration (reference resampler.c:927-935)")
        self.output_offset += delta

    def get_position(self) -> float:
        return self.output_offset + self.num_taps / 2.0 - self.input_index

    def flush(self):
        """Emit the final half-filter of output by feeding zero padding
        (equivalent to the reference's postfill for the no-extrapolation
        case, reference resampler.c:663-685).  Latches FLUSHED: a second
        flush() or any later process() emits nothing and ignores input
        (reference resampler.c:438-439)."""
        half = self.num_taps // 2
        zeros = jnp.zeros((self.num_channels, half), dtype=self.dtype)
        result = self.process(zeros, half)
        self._flushed = True
        return result

    def prewarm(self) -> None:
        """Build and upload all L phase-anchor matrices (~hundreds of KB
        each) so steady-state streaming never pauses for a host-side matrix
        build.  Interpolated patterns depend on the streaming offset, so
        they are built (and cached) per chunk instead."""
        if self.interp:
            return
        for j in range(self.L):
            self._matrix(j)

    def _matrix(self, j0: int):
        # host-built + uploaded: these are per-anchor constants built once
        # per engine, and a device-side constructor would pay a one-time
        # jit compile (the interpolated path differs: its patterns recur
        # per chunk, so it builds on device — see _build_interp_matrix)
        m = self._mats.get(j0)
        if m is None:
            pm = PolyphaseMatrix(self.bank, self.L, self.M, j0,
                                 bool(self.flags & INCLUDE_LOWPASS))
            qn_rows = self._qn_pad if self.mesh is not None else self.qn
            P = np.zeros((qn_rows * self.M, self.L), dtype=self.dtype)
            P[:pm.S, :] = pm.P.T
            m = jnp.asarray(P)
            self._mats[j0] = m
        if self._precise == "int8":
            pl = self._plans.get(j0)
            if pl is None:
                from .pipeline import OzakiPlan
                # digit planes built on device from the uploaded f32
                # matrix (one jitted f64 pointwise split per anchor,
                # off the hot path)
                pl = OzakiPlan.from_device(m, self._ozaki_sp)
                self._plans[j0] = pl
            return pl
        return m

    def _stacked_matrices(self):
        """[L, qn*M, L] device stack of every phase-anchor matrix, built
        once (backs the scan-batched steady state: the per-step anchor is
        a dynamic device-memory index instead of a per-call operand)."""
        if self._mats_stacked is None:
            est = self.L * self.qn * self.M * self.L * self.dtype.itemsize
            if est > (1 << 29):
                raise ValueError(
                    f"stacked anchor bank would need {est/2**20:.0f} MB; "
                    "use process() for this configuration")
            self.prewarm()
            self._mats_stacked = jnp.stack(
                [self._mats[j] for j in range(self.L)])
        return self._mats_stacked

    def process_scan(self, xs, n_in: int, acc=None, stats: bool = False):
        """Run G steady-state chunks in ONE dispatch (lax.scan over the
        fused chunk body) — amortizes per-dispatch host overhead when
        each group's results are fetched (serving loops); outputs are
        bitwise-identical to sequential process().
        ``xs``: [G, ch, n_in] device array;
        every chunk is consumed in full.  Works in both the reduced and
        the interpolated fixed-ratio device modes (no mesh).  Returns
        (outs [G, ch, nb*L] with entries beyond each chunk's K zeroed,
        Ks int array [G][, acc']).

        ``stats=True`` (requires ``acc``): the power accumulator is the
        in-graph consumer of every output sample and the audio is never
        materialized in device memory — outs comes back None.  This is the
        faithful analog of the reference harness, whose 4096-frame scratch
        buffer (32 KB, cache-resident, overwritten every call) is read back
        only by update_stats (reference artest.c:371, 491); acc/hist
        advance bitwise-identically to the stacked form
        (test_parallel.py)."""
        if self.mesh is not None:
            raise NotImplementedError("scan batching is single-shard only")
        if stats and acc is None:
            raise ValueError("stats=True consumes outputs into the power "
                             "accumulator; pass acc")
        G = xs.shape[0]
        if self.interp:
            return self._process_scan_interp(xs, n_in, acc, stats)
        state0 = (self.output_offset, self.input_index)
        try:
            plans = [self._plan(n_in) for _ in range(G)]
            Ks = [p[0] for p in plans]
            nb = max(max(-(-k // self.L) for k in Ks), 1)
            acc_in = acc if acc is not None else jnp.zeros((), self.dtype)
            if all(p[:3] == plans[0][:3] for p in plans):
                # periodic steady state (e.g. chunk size a multiple of M):
                # every chunk has the identical (K, start, anchor) plan, so
                # the scan runs with a compile-time-constant plan — the
                # window slice goes static (fusable) and the mask constant-
                # folds; bitwise-identical to the dynamic-plan scan
                K0, start0, j0 = plans[0][:3]
                self.hist, outs, acc_out = _chunk_scan_step_static(
                    self.hist, xs, self._matrix(j0), acc_in, int(start0),
                    int(K0), self.M, self.L, nb, self.qn, self.num_samples,
                    stats, self._precise)
            elif self._precise == "int8":
                # mixed plans cannot ride the stacked-anchor-bank scan in
                # int8 mode (each anchor's operand is an OzakiPlan, not a
                # bank row): fall back to sequential chunks
                self.output_offset, self.input_index = state0
                outs, Ks, accs = [], [], acc
                for g in range(G):
                    r = self.process(xs[g], n_in, accs)
                    outs.append(r[0])
                    Ks.append(r[1])
                    if acc is not None:
                        accs = r[2]
                if stats:
                    return None, np.asarray(Ks), accs
                nbL = max(o.shape[1] for o in outs)
                outs = jnp.stack([
                    jnp.concatenate(
                        [o, jnp.zeros((o.shape[0], nbL - o.shape[1]),
                                      o.dtype)], axis=1)
                    if o.shape[1] != nbL else o for o in outs])
                if acc is None:
                    return outs, np.asarray(Ks)
                return outs, np.asarray(Ks), accs
            else:
                # mixed plans: dynamic meta + stacked anchor bank (built/
                # validated inside the try so a size rejection rolls the
                # consume/emit state back with the except below)
                meta = jnp.asarray([[p[2] for p in plans],
                                    [p[1] for p in plans], Ks], jnp.int32)
                self.hist, outs, acc_out = _chunk_scan_step(
                    self.hist, xs, self._stacked_matrices(), meta, acc_in,
                    self.M, self.L, nb, self.qn, self.num_samples,
                    stats, self._precise)
        except BaseException:
            # a failed dispatch (trace or compile error) must
            # not leave the consume/emit state G chunks ahead of the
            # audio; hist was not yet reassigned, so restoring the two
            # scalars makes the call a clean no-op
            self.output_offset, self.input_index = state0
            raise
        if acc is None:
            return outs, np.asarray(Ks)
        return outs, np.asarray(Ks), acc_out

    def _flat_plan(self, xs_flat, n_in: int):
        """Shared flat-group plan validation: checks the group shape,
        advances the consume/emit state G chunks, and returns
        (G, K0, start0, nb, P2, fracv, state0) where P2/fracv are the
        chunk matrix and lerp fractions (fracv=None in reduced mode) and
        state0 is the pre-call (output_offset, input_index) for rollback.
        Raises ValueError with the state ROLLED BACK when the plan is not
        exactly periodic (or, interp mode, the phase pattern is not a
        repeating verified one).  G == 0 signals the FLUSHED latch."""
        if self.mesh is not None:
            raise NotImplementedError("flat grouping is single-shard only")
        ch, total = xs_flat.shape
        if total % n_in:
            raise ValueError(f"flat buffer ({total}) must be G*n_in")
        G = total // n_in
        if self._flushed:
            # FLUSHED latch (reference resampler.c:438-439): input after
            # flush is ignored; state does not advance
            return 0, 0, 0, 1, None, None, None
        if G * n_in < self.num_samples:
            raise ValueError("group must cover at least one history length")
        state0 = (self.output_offset, self.input_index)
        if self.interp:
            # interpolated mode additionally needs the SAME verified phase
            # pattern every chunk (cache identity on the banked matrix /
            # fractions, like _process_scan_interp's static check)
            metas = []
            ok = True
            for _ in range(G):
                K, start, j0, pos0, plan = self._plan_compute(n_in)
                nb_g = -(-K // self.L) if K else 1
                P2, fracv, _d, _fi, _fr, pok = self._interp_pattern(
                    pos0, plan, n_in, K, nb_g)
                if not pok:
                    ok = False
                    break
                self.output_offset = plan.new_output_offset
                self.input_index = plan.new_input_index
                metas.append((K, start, P2, fracv))
            ok = ok and all(
                m[0] == metas[0][0] and m[1] == metas[0][1]
                and m[2] is metas[0][2] and m[3] is metas[0][3]
                for m in metas)
            if not ok:
                self.output_offset, self.input_index = state0
                raise ValueError("process_flat needs an exactly periodic "
                                 "steady state with a repeating verified "
                                 "phase pattern; use process_scan for "
                                 "this configuration")
            K0, start0 = metas[0][0], metas[0][1]
            nb = max(-(-K0 // self.L), 1)
            return G, K0, start0, nb, metas[0][2], metas[0][3], state0
        plans = [self._plan(n_in) for _ in range(G)]
        if not all(p[:3] == plans[0][:3] for p in plans):
            self.output_offset, self.input_index = state0
            raise ValueError("process_flat needs an exactly periodic "
                             "steady state (identical per-chunk plans); "
                             "use an M-multiple chunk size and absorb the "
                             "first chunk with process()")
        K0, start0, j0 = plans[0][:3]
        nb = max(-(-K0 // self.L), 1)
        return G, K0, start0, nb, self._matrix(j0), None, state0

    def process_flat(self, xs_flat, n_in: int, acc):
        """G periodic steady-state chunks over a FLAT [ch, G*n_in] buffer
        in one fully-static dispatch, outputs consumed in-graph by the
        power accumulator (see _chunk_group_static — the fastest shipped
        form of the headline steady state: no scan, no per-chunk input
        copies).  Works in both the reduced and the interpolated
        single-shard modes; requires an exactly periodic plan (n_in a
        multiple of the fundamental input period — use an M-multiple
        chunk and absorb the first non-periodic chunk with process()
        first; the interpolated mode additionally needs the repeating
        phase pattern to pass the exact-tie oracle).  Raises ValueError
        otherwise, with no state consumed.  Returns (Ks int array [G],
        acc')."""
        G, K0, start0, nb, Pm, fracv, state0 = self._flat_plan(xs_flat,
                                                               n_in)
        if G == 0:
            return np.zeros((xs_flat.shape[1] // n_in,), np.int64), acc
        try:
            if fracv is not None:
                self.hist, acc = _chunk_group_static_interp(
                    self.hist, xs_flat, Pm, fracv, acc, int(start0),
                    int(K0), G, n_in, self.M, self.L, nb, self.qn,
                    self.num_samples, self._precise)
            else:
                self.hist, acc = _chunk_group_static(
                    self.hist, xs_flat, Pm, acc, int(start0), int(K0), G,
                    n_in, self.M, self.L, nb, self.qn, self.num_samples,
                    self._precise)
        except BaseException:
            self.output_offset, self.input_index = state0
            raise
        return np.full((G,), K0, np.int64), acc

    def process_flat_out(self, xs_flat, n_in: int):
        """Flat-group steady state DELIVERING the audio: same plan
        contract as process_flat, but the dispatch's result is the valid
        output samples [ch, G*K0] materialized on device (the reference
        always hands callers real output buffers, resampler.c:523-527) —
        no validity mask, no power pass; the samples are bitwise-identical
        to process() / process_flat's masked prefix.  Returns
        (out [ch, G*K0] device array, Ks int array [G])."""
        G, K0, start0, nb, Pm, fracv, state0 = self._flat_plan(xs_flat,
                                                               n_in)
        if G == 0:
            ch = xs_flat.shape[0]
            return jnp.zeros((ch, 0), xs_flat.dtype), \
                np.zeros((xs_flat.shape[1] // n_in,), np.int64)
        try:
            out, self.hist = _chunk_group_static_out(
                self.hist, xs_flat, Pm, fracv, int(start0), int(K0), G,
                n_in, self.M, self.L, nb, self.qn, self.num_samples,
                self._precise)
        except BaseException:
            self.output_offset, self.input_index = state0
            raise
        return out, np.full((G,), K0, np.int64)

    def process_flat_packed(self, xs_flat, n_in: int, clips, *,
                            scaler: float, highclip: int, lowclip: int,
                            output_bits: int = 16, output_bytes: int = 2):
        """Flat-group steady state fused through the ditherless
        no-shaping decimator configuration: the only audio leaving the
        graph is packed little-endian PCM (planar per-channel packing,
        reference decimateProcessLE decimator.c:112-199 with
        dither/shaping off) — at 16-bit, half the device-memory bytes of
        the f32 form.  The packed samples are returned as a dense
        u{8*output_bytes} container array [ch, G*K0] whose little-endian
        byte view is the packed byte stream
        (``np.asarray(packed).view(np.uint8)`` == the reference's bytes).
        output_bytes must be 1, 2 or 4 (3-byte
        packing has no dense container; use the decimator path).
        Quantization is bit-exact to the host/device decimators (see
        _floor_half_up_exact).  ``clips`` accumulates the clipped-sample
        count on device.  Returns (packed [ch, G*K0] u{8*output_bytes},
        Ks int array [G], clips')."""
        if output_bytes not in (1, 2, 4):
            raise ValueError("process_flat_packed: output_bytes must be "
                             "1, 2 or 4 (dense LE containers); 3-byte "
                             "packing goes through the decimator path")
        G, K0, start0, nb, Pm, fracv, state0 = self._flat_plan(xs_flat,
                                                               n_in)
        if G == 0:
            ch = xs_flat.shape[0]
            cdt = {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32}[output_bytes]
            return jnp.zeros((ch, 0), cdt), \
                np.zeros((xs_flat.shape[1] // n_in,), np.int64), clips
        try:
            packed, clips, self.hist = _chunk_group_static_packed(
                self.hist, xs_flat, Pm, fracv, float(scaler), clips,
                int(start0), int(K0), G, n_in, self.M, self.L, nb, self.qn,
                self.num_samples, highclip, lowclip, output_bits,
                output_bytes, self._precise)
        except BaseException:
            self.output_offset, self.input_index = state0
            raise
        return packed, np.full((G,), K0, np.int64), clips

    def _process_scan_interp(self, xs, n_in: int, acc, stats: bool = False):
        """Interpolated-mode scan batching: the per-chunk banked matrices
        and lerp fractions are stacked ([G, qn*M, 2L] / [G, L] — cached
        device arrays, so stacking is one device op) and scanned over.
        Chunks whose tiled pattern fails the float64-tie oracle
        (_pattern_safe, expected ~once per 1e10 outputs) drop the whole
        group back to sequential process() calls with identical
        output-shape semantics."""
        G = xs.shape[0]
        state0 = (self.output_offset, self.input_index)
        metas = []
        safe = True
        for _ in range(G):
            K, start, j0, pos0, plan = self._plan_compute(n_in)
            nb_g = -(-K // self.L) if K else 1
            P2, fracv, _d, _fi, _fr, ok = self._interp_pattern(
                pos0, plan, n_in, K, nb_g)
            if not ok:
                safe = False
                break
            self.output_offset = plan.new_output_offset
            self.input_index = plan.new_input_index
            metas.append((K, start, P2, fracv))
        same = safe and all(m[0] == metas[0][0] and m[1] == metas[0][1]
                            and m[2] is metas[0][2] and m[3] is metas[0][3]
                            for m in metas)
        if not safe or (not same and self._precise == "int8"):
            # restore and take the slow exact path chunk by chunk (tie
            # class — or a mixed-pattern group in int8 mode, whose plans
            # cannot ride the stacked-operand scan)
            self.output_offset, self.input_index = state0
            outs, Ks, accs = [], [], acc
            for g in range(G):
                r = self.process(xs[g], n_in, accs)
                outs.append(r[0])
                Ks.append(r[1])
                if acc is not None:
                    accs = r[2]
            if stats:
                # outputs already consumed into the accumulator by each
                # process() call's fused power term; discard the audio
                return None, np.asarray(Ks), accs
            nbL = max(o.shape[1] for o in outs)
            outs = jnp.stack([
                jnp.concatenate(
                    [o, jnp.zeros((o.shape[0], nbL - o.shape[1]),
                                  o.dtype)], axis=1)
                if o.shape[1] != nbL else o for o in outs])
            if acc is None:
                return outs, np.asarray(Ks)
            return outs, np.asarray(Ks), accs
        Ks = [m[0] for m in metas]
        nb = max(max(-(-k // self.L) for k in Ks), 1)
        try:
            acc_in = acc if acc is not None else jnp.zeros((), self.dtype)
            if same:
                # periodic steady state with a repeating phase pattern
                # (cache identity on the banked matrix/fractions): static
                # plan, one matrix operand — see _chunk_scan_step_static
                self.hist, outs, acc_out = _chunk_scan_step_interp_static(
                    self.hist, xs, metas[0][2], metas[0][3], acc_in,
                    int(metas[0][1]), int(metas[0][0]), self.M, self.L, nb,
                    self.qn, self.num_samples, stats, self._precise)
            else:
                meta = jnp.asarray([[m[1] for m in metas], Ks], jnp.int32)
                P2s = jnp.stack([m[2] for m in metas])
                frs = jnp.stack([m[3] for m in metas])
                self.hist, outs, acc_out = _chunk_scan_step_interp(
                    self.hist, xs, P2s, frs, meta, acc_in,
                    self.M, self.L, nb, self.qn, self.num_samples,
                    stats, self._precise)
        except BaseException:
            # failed dispatch: roll the scalar state back (hist untouched)
            # so the engine is not G chunks ahead of the processed audio
            self.output_offset, self.input_index = state0
            raise
        if acc is None:
            return outs, np.asarray(Ks)
        return outs, np.asarray(Ks), acc_out

    def _sharded_step(self, nb: int):
        """shard_map-wrapped chunk step over the engine's mesh (cached per
        output-block count): streams axis data-parallel, taps axis
        tensor-parallel over shift blocks with one psum (the production
        _resample_block), power accumulator psum'd over streams."""
        key = (nb, self.interp)
        fn = self._sharded_cache.get(key)
        if fn is None:
            from jax.sharding import PartitionSpec as P

            from .pipeline import _resample_block

            mesh = self.mesh
            has_taps = "taps" in mesh.axis_names
            taps_axis = "taps" if has_taps else None
            qn_pad = self._qn_pad
            qn_local = qn_pad // self._ntap
            M, L, hist_len = self.M, self.L, self.num_samples
            tspec = P("taps", None) if has_taps else P(None, None)

            precise = self._precise
            if self.interp:
                def local(hist, x, P2l, fracv, start, K, acc):
                    return _sharded_interp_body(
                        hist, x, P2l, fracv, start, K, acc, precise=precise,
                        M=M, L=L, nb=nb,
                        qn_pad=qn_pad, qn_local=qn_local, hist_len=hist_len,
                        taps_axis=taps_axis, streams_axis="streams")

                fn = jax.jit(jax.shard_map(
                    local, mesh=mesh,
                    in_specs=(P("streams", None), P("streams", None), tspec,
                              P(None), P(), P(), P()),
                    out_specs=(P("streams", None), P("streams", None), P()),
                    check_vma=False))
            else:
                def local(hist, x, Pl, start, K, acc):
                    q0 = jnp.int32(0)
                    if taps_axis is not None:
                        q0 = jax.lax.axis_index(taps_axis) \
                            .astype(jnp.int32) * qn_local
                    out, new_hist = _resample_block(
                        x, hist, Pl, start, K, M=M, L=L, nb=nb,
                        qn_pad=qn_pad, qn_local=qn_local, hist_len=hist_len,
                        q0=q0, taps_axis=taps_axis, precise=precise)
                    acc = acc + jax.lax.psum(jnp.sum(out * out), "streams")
                    return new_hist, out, acc

                fn = jax.jit(jax.shard_map(
                    local, mesh=mesh,
                    in_specs=(P("streams", None), P("streams", None), tspec,
                              P(), P(), P()),
                    out_specs=(P("streams", None), P("streams", None), P()),
                    check_vma=False))
            self._sharded_cache[key] = fn
        return fn

    def _plan_compute(self, n_in: int):
        """Pure consume/emit plan for a chunk: no state is mutated."""
        n_out_cap = int((n_in + self.num_taps) * self.fixed_ratio) + 64
        plan = accounting.plan_process(
            output_offset=self.output_offset, input_index=self.input_index,
            flags=self.flags, num_taps=self.num_taps,
            num_samples=self.num_samples, num_filters=self.num_filters,
            fixed_ratio=self.fixed_ratio, n_in=n_in, n_out=n_out_cap,
            ratio=0.0)
        assert plan.input_used == n_in, "output capacity must cover input"
        K = plan.output_generated
        pos0 = plan.first_position
        ipos0 = math.floor(pos0)
        if self.interp:
            j0 = 0          # interpolated patterns are keyed by pos0 instead
        else:
            j0 = round((pos0 - ipos0) * self.L)
            if j0 >= self.L:
                ipos0 += 1
                j0 -= self.L
        half = self.num_taps // 2
        start = (ipos0 - half + 1) + (self.num_samples - self.input_index)
        return K, start, j0, pos0, plan

    def peek_output(self, n_in: int) -> int:
        """Outputs the next process(n_in) call would emit (state untouched)."""
        return self._plan_compute(n_in)[0]

    def _plan(self, n_in: int):
        K, start, j0, pos0, plan = self._plan_compute(n_in)
        # adopt the plan's state advance verbatim: it reproduces the
        # reference's ring-slide arithmetic exactly, so emission-count
        # comparisons can never diverge from the host engine at float ties
        self.output_offset = plan.new_output_offset
        self.input_index = plan.new_input_index
        return K, start, j0, pos0

    def _pattern_vals(self, first_position: float):
        """One period's (window offset, filter index, fraction) triples,
        computed exactly from the float64 streaming offset — the same
        per-output math as the host engine."""
        ratio = self.fixed_ratio
        j = np.arange(self.L, dtype=np.float64)
        pos = first_position + j / ratio
        ipos = np.floor(pos)
        ff = (pos - ipos) * self.num_filters
        fi = np.minimum(np.floor(ff), self.num_filters - 1).astype(np.int64)
        frac = (ff - fi)
        d = (ipos - ipos[0]).astype(np.int64)
        return d, fi, frac

    def _interp_pattern(self, pos0: float, plan, n_in: int, K: int,
                        nb: int):
        """This chunk's banked pattern WITH steady-state reuse.

        The f64 streaming offset drifts in its last ulps chunk to chunk,
        so the bitwise (d, fi, frac) pattern of an exactly-periodic
        steady state flips between value-continuous representations
        (filter fi-1 at frac 1 == filter fi at frac 0) — breaking the
        cache identity the static-plan scan and flat-group paths key on
        (preset-1 would fall to the dynamic-meta scan).  Reuse rule:
        if the PREVIOUS pattern's phase positions are within
        PATTERN_TOL of this chunk's (per-period L-element compare, plus
        this chunk's own analytic oracle bound), the previous pattern is
        provably as close to the ring-exact oracle as the fresh one —
        return it, keeping the cache identity stable.  Sequential
        process(), process_scan and process_flat all route through
        here, so they make identical pattern choices (the bitwise
        scan == sequential contract).

        Returns (P2, fracv, d, fi, frac, safe); ``safe=False`` means the
        caller must split the chunk (the ~1e-10 tie class, see
        _pattern_safe)."""
        ipos0 = math.floor(pos0)
        last = self._last_interp
        if last is not None and K:
            bound = 4.0 * np.spacing(abs(plan.first_position)
                                     + K / self.fixed_ratio)
            d, fi, frac = self._pattern_vals(pos0)
            Fn = float(self.num_filters)
            own = d.astype(np.float64) + (fi.astype(np.float64) + frac) / Fn
            dl, fil, fracl = last[2], last[3], last[4]
            prev = dl.astype(np.float64) \
                + (fil.astype(np.float64) + fracl) / Fn
            dev = float(np.abs(own - prev).max())
            if dev + bound <= self.PATTERN_TOL:
                return (*last, True)
        m = self._interp_matrix(pos0)
        safe = self._pattern_safe(plan, n_in, K, nb, ipos0, m[2], m[3],
                                  m[4])
        if safe:
            self._last_interp = m
        return (*m, safe)

    def _interp_matrix(self, first_position: float):
        """Banked interpolated matrices for this chunk's phase pattern
        (the integer pattern is tiled across the chunk's nb periods;
        _interp_pattern verifies the tiling against the ring-coordinate
        oracle before use)."""
        d, fi, frac = self._pattern_vals(first_position)
        key = (d.tobytes(), fi.tobytes(), frac.tobytes())
        m = self._interp_cache.get(key)
        if m is None:
            if self._bank_dev is None:
                self._bank_dev = jnp.asarray(self.bank)
            qn_rows = self._qn_pad if self.mesh is not None else self.qn
            P2 = _build_interp_matrix(
                self._bank_dev, jnp.asarray(d.astype(np.int32)),
                jnp.asarray(fi.astype(np.int32)),
                qn_rows * self.M, self.L, self.num_taps)
            if self._precise == "int8":
                # int8 mode: the pattern's dot operand is its OzakiPlan
                # (digit planes split on device, once per cached pattern)
                from .pipeline import OzakiPlan
                P2 = OzakiPlan.from_device(P2, self._ozaki_sp)
            m = (P2, jnp.asarray(frac.astype(self.dtype)), d, fi, frac)
            if len(self._interp_cache) > 64:
                # evict ONE oldest entry (dict preserves insertion order):
                # clearing everything made a 65-pattern working set rebuild
                # every matrix nearly every chunk
                self._interp_cache.pop(next(iter(self._interp_cache)))
            self._interp_cache[key] = m
        return m

    # max tolerated phase-position deviation of the tiled pattern from the
    # ring-exact oracle, in input-sample units.  A deviation d perturbs the
    # output by ~|signal slope| * d, so 1e-8 stays far below the f32 matmul
    # floor; the expected worst case (ulp of fl(k/ratio) at k ~ 2^22-frame
    # chunks) is ~1e-9.  Rational-ratio configs sit *systematically* on
    # float64 phase-grid ties (exact positions are multiples of 1/L), so
    # bitwise (window, filter) flips with compensating fractions are the
    # norm, not a 1e-10 rarity — they are value-continuous (filter fi-1 at
    # frac 1 == filter fi at frac 0; the rotated extra filter makes the
    # window+1/fi=0 wrap continuous too, reference resampler.c:154-159).
    PATTERN_TOL = 1e-8

    def _pattern_safe(self, plan, n_in: int, K: int, nb: int,
                      ipos0: float, d: np.ndarray, fi: np.ndarray,
                      frac: np.ndarray) -> bool:
        """Exact-fi verification of the tiled interpolated pattern against
        the host oracle: the reference rounds emission positions in ring
        coordinates (fl((o - slides) + fl(k/ratio)), resampler.c:526,
        1147-1157); the device step assumes period p of this chunk reads
        the continuous phase position ipos0 + d[j] + p*M + (fi[j] +
        frac[j])/F.  Vectorized over all K emissions and cached per
        (pattern, plan scalars); a deviation beyond PATTERN_TOL makes the
        caller split the chunk into provably-exact sub-chunks."""
        if nb <= 1 or not K:
            return True
        # analytic fast path: oracle and tiled pattern both approximate the
        # same exact rational position within a few roundings of their own
        # computations — the oracle's division fl(k/ratio) dominates at
        # <= 0.5 ulp(K/ratio), the pattern's period-0 terms are at small
        # magnitudes, and the fraction's f32 quantization adds
        # 2^-24/num_filters.  A generous 4x margin on the dominant term
        # proves typical chunks safe without scanning them.
        bound = 4.0 * np.spacing(abs(plan.first_position) + K
                                 / self.fixed_ratio)
        if bound <= self.PATTERN_TOL:
            return True
        key = (plan.first_position, K, self.input_index, n_in,
               d.tobytes(), fi.tobytes())
        safe = self._pattern_safe_cache.get(key)
        if safe is None:
            ip, frac0 = accounting.ring_positions(
                first_position=plan.first_position,
                flush_shift=plan.flush_shift, ratio=self.fixed_ratio, K=K,
                input_index=self.input_index, input_used=plan.input_used,
                num_samples=self.num_samples, num_taps=self.num_taps,
                flush=plan.flush)
            pos_oracle = ip.astype(np.float64) + frac0
            pidx = np.arange(K, dtype=np.int64)
            F = float(self.num_filters)
            pos_pat = (ipos0 + np.tile(d, nb)[:K]
                       + (pidx // self.L).astype(np.float64) * self.M
                       + np.tile((fi.astype(np.float64) + frac) / F,
                                 nb)[:K])
            safe = bool(np.abs(pos_oracle - pos_pat).max()
                        <= self.PATTERN_TOL)
            if len(self._pattern_safe_cache) > 256:
                self._pattern_safe_cache.pop(
                    next(iter(self._pattern_safe_cache)))
            self._pattern_safe_cache[key] = safe
        return safe

    def process(self, x, n_in: int, acc=None):
        """x: device array [ch, n_in].  Returns (out_dev [ch, nb*L] with
        entries beyond K zeroed, K) — or (out, K, acc') when a running
        output-power accumulator is passed (computed in the same dispatch).
        All n_in inputs are consumed."""
        if self._flushed:
            # FLUSHED latch (reference resampler.c:438-439): input after
            # flush is ignored until reset; state does not advance
            out = jnp.zeros((self.num_channels, self.L), dtype=self.dtype)
            return (out, 0) if acc is None else (out, 0, acc)
        if x.shape[1] != n_in:
            if x.shape[1] < n_in:
                raise ValueError(f"x has {x.shape[1]} columns < n_in "
                                 f"{n_in}")
            # capacity buffer wider than the valid frames: the extra
            # columns must not enter the history (the contraction window
            # and new_hist both read past n_in otherwise)
            x = x[:, :n_in]
        K, start, j0, pos0, plan = self._plan_compute(n_in)
        nb = -(-K // self.L) if K else 1
        if self.interp:
            P2, fracv, _d, _fi, _fr, safe = self._interp_pattern(
                pos0, plan, n_in, K, nb)
            if not safe:
                return self._process_split(x, n_in, acc)
        # adopt the plan's state advance verbatim: it reproduces the
        # reference's ring-slide arithmetic exactly, so emission-count
        # comparisons can never diverge from the host engine at float ties
        self.output_offset = plan.new_output_offset
        self.input_index = plan.new_input_index
        acc_in = acc if acc is not None else jnp.zeros((), self.dtype)
        if self.mesh is not None:
            if x.shape[0] != self._rows:
                x = jnp.concatenate(
                    [x, jnp.zeros((self._rows - x.shape[0], x.shape[1]),
                                  self.dtype)], axis=0)
            step = self._sharded_step(nb)
            if self.interp:
                new_hist, out, acc_out = step(
                    self.hist, x, P2, fracv, jnp.int32(start), jnp.int32(K),
                    acc_in)
            else:
                new_hist, out, acc_out = step(
                    self.hist, x, self._matrix(j0), jnp.int32(start),
                    jnp.int32(K), acc_in)
            out = out[:self.num_channels]
        elif self.interp:
            new_hist, out, acc_out = _chunk_step_interp(
                self.hist, x, P2, fracv, jnp.int32(start), jnp.int32(K),
                acc_in, self.M, self.L, nb, self.qn, self.num_samples,
                self._precise)
        else:
            new_hist, out, acc_out = _chunk_step(
                self.hist, x, self._matrix(j0), jnp.int32(start),
                jnp.int32(K), acc_in, self.M, self.L, nb, self.qn,
                self.num_samples, self._precise)
        self.hist = new_hist
        if acc is None:
            return out, K
        return out, K, acc_out

    def _process_split(self, x, n_in: int, acc):
        """Float64-tie chunk (the interpolated pattern does not repeat
        exactly): halve until every sub-chunk is single-period, which the
        tiled step computes exactly.  Expected ~once per 1e10 outputs."""
        if n_in <= 1:
            raise AssertionError("single-input chunk cannot be period-tied")
        n1 = n_in // 2
        r1 = self.process(x[:, :n1], n1, acc)
        acc1 = r1[2] if acc is not None else None
        r2 = self.process(x[:, n1:], n_in - n1, acc1)
        K1, K2 = r1[1], r2[1]
        K = K1 + K2
        nb = max(1, -(-K // self.L))
        out = jnp.zeros((x.shape[0], nb * self.L), dtype=self.dtype)
        out = out.at[:, :K1].set(r1[0][:, :K1])
        out = out.at[:, K1:K].set(r2[0][:, :K2])
        if acc is None:
            return out, K
        return out, K, r2[2]

class HybridStreamResampler:
    """File-pipeline engine: device steady state, host edges.

    Drives the fixed-ratio device engine for the repeated full-size blocks
    of a file conversion while delegating everything the device path does
    not model — endpoint extrapolation prefill (reference
    resampler.c:691-698), odd-sized tail blocks, and the extrapolated
    flush postfill (reference resampler.c:663-685) — to the bit-careful
    host engine, with exact streaming-state handoff between the two (the
    device history is the C ring right-aligned; offsets/indices are shared
    because both sides run the same accounting).

    Exposes the host engine's ``process_interleaved`` contract so callers
    (the art CLI) are agnostic.  Output samples are within the float32
    matmul noise floor of the host path; counts and positions are exact.
    """

    def __init__(self, num_channels: int, num_taps: int, max_filters: int,
                 source_rate: float, destin_rate: float, lowpass_freq: float,
                 flags: int, *, dtype=np.float32, mesh=None,
                 precise: bool = False):
        from ..engines.resampler import Resampler
        self.host = Resampler.fixed_ratio(
            num_channels, num_taps, max_filters, source_rate, destin_rate,
            lowpass_freq, flags, dtype=dtype)
        self.dev = DeviceStreamResampler(
            num_channels, num_taps, max_filters, source_rate, destin_rate,
            lowpass_freq, flags & ~EXTRAPOLATE_ENDPOINTS, dtype=dtype,
            mesh=mesh, precise=precise)
        self.dev.prewarm()
        self._on_device = False
        self._steady_n = None
        self._ch = num_channels

    # --------------------------------------------------------- state moves
    def _push(self) -> None:
        st = self.host.state_dict()
        ns, ii = self.dev.num_samples, int(st["input_index"])
        hist = np.zeros((self.dev._rows, ns), self.host.dtype)
        hist[:self._ch, ns - ii:] = st["history"][:, :ii]
        self.dev.hist = jnp.asarray(hist)
        self.dev.output_offset = st["output_offset"]
        self.dev.input_index = ii
        self._on_device = True

    def _pull(self) -> None:
        ns, ii = self.dev.num_samples, int(self.dev.input_index)
        st = self.host.state_dict()
        st["history"][:] = 0.0
        st["history"][:, :ii] = np.asarray(self.dev.hist)[:self._ch,
                                                          ns - ii:]
        st["output_offset"] = self.dev.output_offset
        st["input_index"] = ii
        self.host.load_state(st)
        self._on_device = False

    # ----------------------------------------------------------------- api
    def advance_position(self, delta: float) -> None:
        # a mid-stream advance (legal in the reference, resampler.c:927-935,
        # e.g. via capi.resampleAdvancePosition) must reach the LIVE state:
        # while steady-state blocks run on device, the host copy is stale
        # and the next _pull() would overwrite an advance applied there
        if self._on_device:
            self._pull()
        self.host.advance_position(delta)

    def get_position(self) -> float:
        if self._on_device:
            return self.dev.get_position()
        return self.host.get_position()

    def get_lowpass_ratio(self) -> float:
        return self.host.get_lowpass_ratio()

    def get_num_filters(self) -> int:
        return self.host.get_num_filters()

    def interpolation_used(self) -> int:
        return self.host.interpolation_used()

    def get_expected_output(self, n_in: int, ratio: float = 0.0) -> int:
        if self._on_device:
            # the dry-run needs only the two scalar state fields, which
            # are host-resident mirrors — a full _pull() would fetch the
            # entire device history per query
            from ..core import accounting
            return accounting.simulate_expected_output(
                output_offset=self.dev.output_offset,
                input_index=int(self.dev.input_index),
                flags=self.host.flags, num_samples=self.dev.num_samples,
                num_taps=self.dev.num_taps, n_in=n_in, ratio=ratio,
                fixed_ratio=self.host.fixed_ratio)
        return self.host.get_expected_output(n_in, ratio)

    def process_interleaved(self, data, n_in: int, n_out: int,
                            ratio: float = 0.0):
        out, res, dev = self.process_interleaved_device(data, n_in, n_out,
                                                        ratio)
        if dev is not None:
            out = np.ascontiguousarray(
                np.asarray(dev)[:, :res.output_generated].T)
        return out, res

    def process(self, data, n_in: int, n_out: int, ratio: float = 0.0):
        """Planar process (host-engine contract: inputs [ch, n] ->
        output [K, ch] transposed back to [ch, K]); routed through the
        interleaved path — the device engine is planar internally, so
        this only adds host transposes at the boundary."""
        inter = None if data is None else \
            np.ascontiguousarray(np.asarray(data).T)
        out, res = self.process_interleaved(inter, n_in, n_out, ratio)
        return np.ascontiguousarray(out.T), res

    def process_and_flush_interleaved(self, data, n_in: int, n_out: int,
                                      ratio: float = 0.0):
        """Process the final block then flush in one call (reference
        resampleProcessAndFlushInterleaved, resampler.c:741-758)."""
        out1, res = self.process_interleaved(data, n_in, n_out, ratio)
        if res.input_used != n_in or res.output_generated == n_out:
            return out1, res
        out2, fres = self.process_interleaved(
            None, -1, n_out - res.output_generated, ratio)
        res.output_generated += fres.output_generated
        return np.concatenate([out1, out2], axis=0), res

    def process_and_flush(self, data, n_in: int, n_out: int,
                          ratio: float = 0.0):
        inter = None if data is None else \
            np.ascontiguousarray(np.asarray(data).T)
        out, res = self.process_and_flush_interleaved(inter, n_in, n_out,
                                                      ratio)
        return np.ascontiguousarray(out.T), res

    def process_interleaved_device(self, data, n_in: int, n_out: int,
                                   ratio: float = 0.0):
        """process_interleaved that keeps device output device-resident.

        Returns (host_out | None, ResampleResult, dev_out | None): when the
        steady-state device path fires, dev_out is the [channels, capacity]
        device array (first output_generated columns valid) and host_out is
        None — a device-resident consumer (e.g. DeviceDecimator) avoids the
        large float32 device->host fetch entirely."""
        # flush / odd tail: host path (extrapolated postfill, any shape)
        prefill_pending = bool(self.host.flags & EXTRAPOLATE_PREFILL)
        if n_in < 0 or data is None:
            if self._on_device:
                self._pull()
            return (*self.host.process_interleaved(data, n_in, n_out,
                                                   ratio), None)
        if self._steady_n is None:
            self._steady_n = n_in
        if n_in != self._steady_n or prefill_pending:
            # first block (prefill) and tail blocks run on host
            if self._on_device:
                self._pull()
            return (*self.host.process_interleaved(data, n_in, n_out,
                                                   ratio), None)
        if not self._on_device:
            self._push()
        if self.dev.peek_output(n_in) > n_out:
            # undersized caller buffer: route to the host engine (which has
            # the partial-consumption semantics) BEFORE any state is
            # mutated — planning first avoids the chunk being consumed by
            # the device and then re-processed on host
            self._pull()
            return (*self.host.process_interleaved(data, n_in, n_out,
                                                   ratio), None)
        x = jnp.asarray(np.ascontiguousarray(np.asarray(data).T))
        out_dev, K = self.dev.process(x, n_in)
        from ..engines.resampler import ResampleResult
        return None, ResampleResult(input_used=n_in, output_generated=K), \
            out_dev
