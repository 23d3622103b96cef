"""Device-resident decimator stages (dither, quantize, byte-pack).

The host decimator (ops/decimate_kernel.py) precomputes dither with numpy and
runs the shaped scan through a host round-trip per call.  For the fused
device pipeline (resample -> biquad -> decimate in one jit, only packed bytes
fetched) every stage must live on device:

  - TPDF dither: the LCG ``g -> ((g<<4) - g) ^ 1`` is affine over Z/2^32 with
    a parity pattern fixed by the seed's low bit, so the k-th state is
    ``A_k * s0 + V_k(parity0)`` — the (A, V0, V1) tables are tiny per-chunk
    constants (host-built once per chunk length, device-resident), and the
    whole dither block becomes vectorized uint32 math.  Bit-exact vs the
    reference generator (reference decimator.c:370-382).
  - Shaped quantization: the error-feedback loop is a true nonlinear
    recurrence (floor() inside the loop) and runs as a lax.scan with the
    reference's exact float op order (float32 products forced through
    lax.reduce_precision so XLA cannot FMA-contract them).  A step-index
    guard freezes the carry beyond the chunk's valid length K, so ragged
    chunks advance the state by exactly K samples.
  - Flat (shaping-free) quantization is one fused elementwise pass.
  - Byte packing (reference decimator.c:152-191) is vectorized integer ops
    producing the little-endian uint8 stream directly on device.

All functions here are pure (state in, state out) and jit/shard_map-safe.
"""

from __future__ import annotations

import functools

import numpy as np

from .._jaxinit import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp

from .decimate_kernel import _INV15_32, _M32


@functools.lru_cache(maxsize=8)
def dither_tables(n: int):
    """(A, V0, V1) uint32 [5n] with state_k = A_k*s0 + V{parity0}_k
    for k = 1..5n (see decimate_kernel.lcg32_states)."""
    nsteps = 5 * n
    j = np.arange(nsteps, dtype=np.uint32)
    with np.errstate(over="ignore"):
        B = np.cumprod(np.full(nsteps, _INV15_32, dtype=np.uint32),
                       dtype=np.uint32)
        A = np.cumprod(np.full(nsteps, 15, dtype=np.uint32), dtype=np.uint32)
        out = [A]
        for parity0 in (0, 1):
            parity = np.uint32(parity0) ^ (j & np.uint32(1))
            c = np.where(parity == 0, np.uint32(1), _M32)
            V = np.cumsum(c * B, dtype=np.uint32)
            out.append(A * V)
    return tuple(out)


def tpdf_dither_dev(states, A, V0, V1, dither_type: int, n: int):
    """Vectorized device TPDF dither (reference decimator.c:370-382).

    states: uint32 [S]; A/V0/V1: uint32 [5n] tables from dither_tables(n).
    Returns (dither f64 [S, n], seq uint32 [S, 5n]) — the caller advances
    its states from ``seq`` (at 5*K-1 for a K-valid chunk)."""
    parity0 = (states & jnp.uint32(1))[:, None]
    V = jnp.where(parity0 == 0, V0[None, :], V1[None, :])
    seq = A[None, :] * states[:, None] + V                 # [S, 5n] u32
    g0 = jnp.concatenate([states[:, None], seq[:, 4:5 * n - 1:5]], axis=1)
    r2 = seq[:, 1::5]
    r5 = seq[:, 4::5]
    if dither_type == -1:
        first = ~g0
    elif dither_type == 1:
        first = g0
    else:
        first = ~r2
    d = (((first >> jnp.uint32(1)).astype(jnp.float64)
          + (r5 >> jnp.uint32(1)).astype(jnp.float64))
         / 2147483648.0) - 1.0
    return d, seq


def advance_states(states, seq, K):
    """LCG states after exactly K quantized samples (K traced, may be 0)."""
    idx = jnp.maximum(5 * K - 1, 0)
    stepped = jax.lax.dynamic_slice_in_dim(seq, idx, 1, axis=1)[:, 0]
    return jnp.where(K > 0, stepped, states)


def _mul_for(dtype):
    """Product at data-path precision.  For float32, XLA contracts mul+add
    chains into FMAs (skipping the product rounding the reference performs);
    lax.reduce_precision is the only reliable rounding barrier (see
    decimate_kernel.quantize_shaped_jax).  The f64 product of two f32 values
    is exact (48-bit mantissa), the downcast performs the single f32
    rounding, and the f32-identity reduce_precision pins that rounding so no
    later pass fuses the convert into a consumer.  (The barrier sits on
    the f32 side, where it is an identity on every backend.)"""
    if np.dtype(dtype) == np.float32:
        def mul(u, v):
            p = (u.astype(jnp.float64) * v.astype(jnp.float64)) \
                .astype(jnp.float32)
            return jax.lax.reduce_precision(p, exponent_bits=8,
                                            mantissa_bits=23)
    else:
        def mul(u, v):
            return u * v
    return mul


def quantize_flat_dev(samples, dither, scaler, feedback, highclip: int,
                      lowclip: int):
    """Shaping-free quantization, fused elementwise
    (reference decimator.c:152-194 with no shaper).

    samples [n, S] data dtype; dither [n, S] f64 or None; feedback [S].
    Returns (outv i32 [n, S], clip flags bool [n, S])."""
    dt = samples.dtype
    mul = _mul_for(dt)
    code = mul(samples, jnp.asarray(scaler, dt)) - feedback[None, :]
    d = dither.astype(dt) if dither is not None else jnp.zeros((), dt)
    t = (code + d).astype(jnp.float64) + 0.5
    outv = jnp.floor(t).astype(jnp.int32)
    clipf = (outv > highclip) | (outv < lowclip)
    outv = jnp.clip(outv, lowclip, highclip)
    return outv, clipf


def quantize_shaped_dev(samples, dither, scaler, feedback, a, b, xh, yh,
                        K, highclip: int, lowclip: int):
    """Shaped quantization scan, carry frozen beyond K (pure version of
    decimate_kernel.quantize_shaped_jax; reference decimator.c:152-194 +
    biquad apply_sample op order).

    samples [n, S]; dither [n, S] f64 or None; feedback [S]; a/b [5] shaper
    coefficients at data dtype; xh/yh [4, S]; K traced valid length.
    Returns (outv i32 [n, S], clip flags [n, S], feedback', xh', yh')."""
    n, S = samples.shape
    dt = samples.dtype
    mul = _mul_for(dt)
    a = jnp.asarray(a, dt)
    b = jnp.asarray(b, dt)
    scaler = jnp.asarray(scaler, dt)
    if dither is None:
        dither = jnp.zeros((n, S), jnp.float64)

    def step(carry, inp):
        fb, xh, yh = carry
        i, x, d = inp
        active = i < K
        code = mul(x, scaler) - fb
        t = (code + d.astype(code.dtype)).astype(jnp.float64) + 0.5
        ov = jnp.floor(t).astype(jnp.int32)
        err = ov.astype(code.dtype) - code
        s = mul(err, a[0])
        s = s + (mul(xh[3], a[4]) - mul(b[4], yh[3]))
        s = s + (mul(xh[2], a[3]) - mul(b[3], yh[2]))
        s = s + (mul(xh[1], a[2]) - mul(b[2], yh[1]))
        s = s + (mul(xh[0], a[1]) - mul(b[1], yh[0]))
        xh_n = jnp.concatenate([err[None], xh[:3]])
        yh_n = jnp.concatenate([s[None], yh[:3]])
        clipf = active & ((ov > highclip) | (ov < lowclip))
        ovc = jnp.clip(ov, lowclip, highclip)
        new = ((jnp.where(active, s, fb),
                jnp.where(active, xh_n, xh),
                jnp.where(active, yh_n, yh)))
        return new, (jnp.where(active, ovc, 0), clipf)

    idx = jnp.arange(n, dtype=jnp.int32)
    (fb, xh, yh), (outv, clipf) = jax.lax.scan(
        step, (feedback, xh, yh), (idx, samples, dither))
    return outv, clipf, fb, xh, yh


def pack_bytes_dev(outv, output_bits: int, output_bytes: int):
    """Vectorized LE byte packing on device (reference decimator.c:152-191).

    outv i32 [n, S] -> uint8 [n, S * output_bytes]."""
    n, S = outv.shape
    pre_zeros = output_bytes - ((output_bits + 7) // 8)
    offset = 128 if output_bits <= 8 else 0
    leftshift = (24 - output_bits) % 8
    v = (outv.astype(jnp.uint32) << jnp.uint32(leftshift)) \
        + jnp.uint32(offset)
    planes = [jnp.zeros((n, S), jnp.uint8)] * pre_zeros
    planes.append((v & 0xFF).astype(jnp.uint8))
    if output_bits > 8:
        planes.append(((v >> 8) & 0xFF).astype(jnp.uint8))
        if output_bits > 16:
            planes.append(((v >> 16) & 0xFF).astype(jnp.uint8))
    planes += [jnp.zeros((n, S), jnp.uint8)] * (output_bytes - len(planes))
    return jnp.stack(planes, axis=2).reshape(n, S * output_bytes)
