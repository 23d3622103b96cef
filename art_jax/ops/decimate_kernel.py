"""Device/vectorized kernels for the float->integer decimator.

The reference decimator (reference decimator.c) is a per-sample chain:
TPDF dither draw -> quantize -> noise-shaping error feedback -> clip ->
byte-pack.  Re-architected for wide hardware:

  - The dither LCG (``g = ((g<<4) - g) ^ 1`` stepped 5x per sample,
    reference decimator.c:370-382) *looks* sequential but is affine over
    Z/2^32 with a deterministic sign pattern, so entire dither sequences are
    precomputed in closed form with cumulative products — bit-exact and fully
    parallel over samples and channels.
  - The noise-shaping feedback loop is a true nonlinear recurrence
    (quantization inside the loop), so it runs as a lax.scan whose step uses
    the exact float32 op order of the reference's decoupled-H(z) biquad; the
    scan is vectorized across channels (and across batched streams upstream).
  - Without shaping, quantization is one fused elementwise pass.
  - Byte packing/unpacking is vectorized integer math (and is also provided
    by the native C++ runtime for the file CLI hot path).
"""

from __future__ import annotations

import numpy as np

_INV15_32 = pow(15, -1, 1 << 32)
_M32 = np.uint32(0xFFFFFFFF)


def lcg32_states(state: int, parity0: int, nsteps: int) -> np.ndarray:
    """States 1..nsteps of g -> ((g<<4) - g) ^ 1 over uint32, closed form.

    (15*g)^1 == 15*g + 1 - 2*(g&1), and the state parity alternates each
    step, giving s_k = 15^k*(s_0 + sum_j c_j*15^{-(j+1)}) mod 2^32.
    """
    j = np.arange(nsteps, dtype=np.uint32)
    parity = np.uint32(parity0) ^ (j & np.uint32(1))
    c = np.where(parity == 0, np.uint32(1), _M32)
    with np.errstate(over="ignore"):
        B = np.cumprod(np.full(nsteps, _INV15_32, dtype=np.uint32),
                       dtype=np.uint32)
        V = np.cumsum(c * B, dtype=np.uint32)
        A = np.cumprod(np.full(nsteps, 15, dtype=np.uint32),
                       dtype=np.uint32)
        return A * np.uint32(state) + A * V


def tpdf_dither_block(states: np.ndarray, dither_type: int, n: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized tpdf_dither (reference decimator.c:370-382).

    ``states``: per-channel uint32 generator states [ch].
    Returns (dither [n, ch] float64, new_states [ch]).
    """
    ch = states.shape[0]
    out = np.empty((n, ch), dtype=np.float64)
    new_states = states.copy()
    for c in range(ch):
        s0 = int(states[c])
        seq = lcg32_states(s0, s0 & 1, 5 * n)           # steps 1..5n
        g0 = np.empty(n, dtype=np.uint32)               # state entering sample
        g0[0] = s0
        if n > 1:
            g0[1:] = seq[4:-1:5]
        r2 = seq[1::5]                                  # after 2 steps
        r5 = seq[4::5]                                  # after 5 steps
        if dither_type == -1:
            first = ~g0
        elif dither_type == 1:
            first = g0
        else:
            first = ~r2
        out[:, c] = (((first >> np.uint32(1)).astype(np.float64)
                      + (r5 >> np.uint32(1)).astype(np.float64))
                     / 2147483648.0) - 1.0
        new_states[c] = r5[-1] if n else states[c]
    return out, new_states


def seed_generators(num_channels: int) -> np.ndarray:
    """Initial per-channel generator states (reference decimator.c:40-52):
    a byte-wise LCG stream off 0x31415926 filling the uint32 array."""
    nbytes = num_channels * 4
    random = 0x31415926
    seed = np.empty(nbytes, dtype=np.uint8)
    for i in range(nbytes):
        seed[i] = (random >> 24) & 0xFF
        for _ in range(3):
            random = (((random << 4) - random) ^ 1) & 0xFFFFFFFF
    return seed.view(np.dtype("<u4")).copy()


def quantize_flat(samples: np.ndarray, dither: np.ndarray | None,
                  scaler, feedback: np.ndarray,
                  highclip: int, lowclip: int
                  ) -> tuple[np.ndarray, int, np.ndarray]:
    """No-shaping path: fully vectorized quantization.

    samples: [n, ch] data dtype; dither: [n, ch] f64 or None.
    Returns (outvalues int32 [n, ch], clipped count, feedback unchanged).
    """
    dt = samples.dtype
    code = samples * dt.type(scaler) - feedback[None, :]
    # the reference stores the dither draw into artsample_t, so the whole
    # quantization sum rounds at data-path precision (decimator.c:162,170)
    d = dither.astype(dt) if dither is not None else dt.type(0.0)
    # (code + dither) rounds at data-path precision, but the trailing +0.5 is
    # a double literal in the reference (decimator.c:170) — add it in float64
    t = (code + d).astype(np.float64) + 0.5
    outv = np.floor(t).astype(np.int32)
    clipped = int((outv > highclip).sum() + (outv < lowclip).sum())
    outv = np.clip(outv, lowclip, highclip)
    return outv, clipped, feedback


def quantize_shaped_numpy(samples: np.ndarray, dither: np.ndarray | None,
                          scaler, feedback: np.ndarray, shaper,
                          highclip: int, lowclip: int
                          ) -> tuple[np.ndarray, int, np.ndarray]:
    """Shaped path, host scalar scan (parity reference).

    ``shaper`` is an engines.biquad.Biquad with ``channels == ch`` lanes.
    Mutates shaper state; returns (outvalues, clipped, new_feedback).
    """
    n, ch = samples.shape
    dt = samples.dtype
    outv = np.empty((n, ch), dtype=np.int32)
    clipped = 0
    fb = feedback.astype(dt).copy()
    for i in range(n):
        code = samples[i] * dt.type(scaler) - fb
        d = dither[i].astype(dt) if dither is not None else dt.type(0.0)
        # data-path rounding for (code + dither); the +0.5 adds in float64
        t = (code + d).astype(np.float64) + 0.5
        ov = np.floor(t).astype(np.int32)
        err = (ov.astype(dt) - code).astype(dt)
        fb = shaper.apply_sample(err).astype(dt)
        clipped += int((ov > highclip).sum() + (ov < lowclip).sum())
        outv[i] = np.clip(ov, lowclip, highclip)
    return outv, clipped, fb


def quantize_shaped_jax(samples: np.ndarray, dither: np.ndarray | None,
                        scaler, feedback: np.ndarray, shaper,
                        highclip: int, lowclip: int
                        ) -> tuple[np.ndarray, int, np.ndarray]:
    """Shaped path as a lax.scan over time, channels vectorized.

    Mirrors the reference biquad apply_sample op order; XLA would normally
    contract/fuse these float32 chains (FMA, convert+sub), so every product
    rounding is forced through lax.reduce_precision — results are then
    bit-identical to the host path on every backend."""
    from .._jaxinit import ensure_jax
    jax = ensure_jax()
    import jax.numpy as jnp

    n, ch = samples.shape
    dt = samples.dtype
    a = jnp.asarray(shaper.a)
    b = jnp.asarray(shaper.b)

    if dt == np.float32:
        # XLA may contract mul+add chains into FMAs, skipping the product
        # rounding the reference performs.  Computing each product through a
        # float64 round-trip yields exactly the float32-rounded product —
        # but the CPU backend also fuses the f64->f32 convert into a
        # following subtract (skipping the intermediate rounding again), so
        # the rounding is expressed as lax.reduce_precision, which XLA
        # treats as an opaque rounding point.  (The float64 data path keeps
        # native ops; its own FMA deviation is sub-ulp of the 52-bit
        # mantissa.)
        def mul(u, v):
            p = jax.lax.reduce_precision(
                u.astype(jnp.float64) * v.astype(jnp.float64),
                exponent_bits=8, mantissa_bits=23)
            return p.astype(jnp.float32)
    else:
        def mul(u, v):
            return u * v

    def step(carry, inp):
        fb, xh, yh = carry
        x, d = inp
        code = mul(x, dt.type(scaler)) - fb
        # (code + dither) at data-path precision; +0.5 in float64 like the
        # reference's double literal (decimator.c:170)
        t = (code + d.astype(code.dtype)).astype(jnp.float64) + 0.5
        ov = jnp.floor(t).astype(jnp.int32)
        err = (ov.astype(code.dtype) - code)
        s = mul(err, a[0])
        s = s + (mul(xh[3], a[4]) - mul(b[4], yh[3]))
        s = s + (mul(xh[2], a[3]) - mul(b[3], yh[2]))
        s = s + (mul(xh[1], a[2]) - mul(b[2], yh[1]))
        s = s + (mul(xh[0], a[1]) - mul(b[1], yh[0]))
        xh = jnp.concatenate([err[None], xh[:3]])
        yh = jnp.concatenate([s[None], yh[:3]])
        clip_n = jnp.sum((ov > highclip) | (ov < lowclip))
        ovc = jnp.clip(ov, lowclip, highclip)
        return (s, xh, yh), (ovc, clip_n)

    d = jnp.asarray(dither) if dither is not None else jnp.zeros(
        (n, ch), dtype=jnp.float64)
    carry0 = (jnp.asarray(feedback.astype(dt)), jnp.asarray(shaper.xh),
              jnp.asarray(shaper.yh))
    (fb, xh, yh), (outv, clips) = jax.lax.scan(
        step, carry0, (jnp.asarray(samples), d))
    shaper.xh = np.asarray(xh)
    shaper.yh = np.asarray(yh)
    return np.asarray(outv), int(np.asarray(clips).sum()), np.asarray(fb)


def pack_bytes(outvalues: np.ndarray, output_bits: int, output_bytes: int
               ) -> np.ndarray:
    """Vectorized little-endian byte packing
    (reference decimator.c:152-191): left-shift to a 24-bit frame, +128
    offset for <=8-bit (unsigned), pre-zero pad bytes for e.g. 24-in-32."""
    n, ch = outvalues.shape
    pre_zeros = output_bytes - ((output_bits + 7) // 8)
    offset = 128 if output_bits <= 8 else 0
    leftshift = (24 - output_bits) % 8
    v = (outvalues.astype(np.uint32) << np.uint32(leftshift)) \
        + np.uint32(offset)
    out = np.zeros((n, ch, output_bytes), dtype=np.uint8)
    j = pre_zeros
    out[:, :, j] = (v & 0xFF).astype(np.uint8)
    if output_bits > 8:
        out[:, :, j + 1] = ((v >> 8) & 0xFF).astype(np.uint8)
        if output_bits > 16:
            out[:, :, j + 2] = ((v >> 16) & 0xFF).astype(np.uint8)
    return out.reshape(n, ch * output_bytes)


def unpack_bytes(data: np.ndarray, gain: float, input_bits: int,
                 input_bytes: int, dtype=np.float32) -> np.ndarray:
    """Vectorized floatIntegersLE (reference decimator.c:416-450).

    data: uint8 array [..., nsamples*input_bytes]; returns float samples."""
    dt = np.dtype(dtype)
    raw = np.ascontiguousarray(data).reshape(-1, input_bytes)
    skip = input_bytes - ((input_bits + 7) // 8)
    raw = raw[:, skip:]
    if input_bits <= 8:
        gf = dt.type(gain / 128.0)
        vals = raw[:, 0].astype(np.int32) - 128
    elif input_bits <= 16:
        gf = dt.type(gain / 32768.0)
        vals = (raw[:, 0].astype(np.uint16)
                | (raw[:, 1].astype(np.uint16) << 8)).astype(np.int16)
    else:
        gf = dt.type(gain / 8388608.0)
        v = (raw[:, 0].astype(np.uint32)
             | (raw[:, 1].astype(np.uint32) << 8)
             | (raw[:, 2].astype(np.uint32) << 16))
        vals = np.where(v & 0x800000, v | 0xFF000000, v).astype(np.int32)
    return (vals.astype(dt) * gf).astype(dt)
