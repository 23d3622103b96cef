"""Device kernels for the windowed-sinc resampler.

The host accounting (core/accounting.py) reduces every process() call to a
batch of float64 read positions over a linear sample buffer.  This module
turns those positions into audio:

  - ``decompose_positions``: float64 host math splitting each position into
    (window base, filter index, interpolation fraction, passthrough) exactly
    the way the reference subsample functions do
    (reference resampler.c:1135-1157),
  - a numpy backend used as the bit-careful parity reference (float64
    accumulation, lerp of the two filter outputs in float64 like the
    reference's double-precision interpolation arithmetic),
  - a JAX backend: one gather of [K, T] history windows + phase-bank row
    gather + fused lerp + batched dot, jitted with bucketed shapes so
    streaming calls hit the compile cache.

The fixed-ratio steady-state path has a dedicated formulation in
``polyphase.py`` (strided convolution as a matmul); this module is the
fully-general path that also serves drifting-ratio ASRC.
"""

from __future__ import annotations

import functools

import numpy as np

# jax is imported lazily (see _jaxinit.ensure_jax): only the jax backend
# needs it, and importing it costs seconds of CLI startup


def decompose_positions(positions: np.ndarray, num_filters: int,
                        num_taps: int, interpolate: bool,
                        include_lowpass: bool) -> dict:
    """Split emission positions into gather/filter indices (host, float64)."""
    ipos = np.floor(positions)
    return decompose_indexed(ipos.astype(np.int64), positions - ipos,
                             num_filters, num_taps, interpolate,
                             include_lowpass)


def decompose_indexed(ipos: np.ndarray, frac0: np.ndarray, num_filters: int,
                      num_taps: int, interpolate: bool,
                      include_lowpass: bool) -> dict:
    """Like decompose_positions, from precomputed integer positions and
    ring-exact fractions (see core.accounting.ring_positions — the
    reference rounds positions in ring coordinates, which carries more
    fraction precision than the linear sum)."""
    half = num_taps // 2
    base = ipos.astype(np.int64) - half + 1
    if interpolate:
        ff = frac0 * num_filters
        fi = np.floor(ff)
        frac = ff - fi
        fi = fi.astype(np.int64)
        # guard the (half-ulp) case where frac0*F rounds up to exactly F
        over = fi >= num_filters
        fi = np.where(over, num_filters - 1, fi)
        frac = np.where(over, 1.0, frac)
        return dict(base=base, fi=fi, frac=frac,
                    pass_mask=np.zeros(len(ipos), dtype=bool),
                    pass_idx=np.zeros(len(ipos), dtype=np.int64))
    fi = np.floor(frac0 * num_filters + 0.5).astype(np.int64)
    pass_mask = (not include_lowpass) & (fi % num_filters == 0)
    pass_idx = ipos.astype(np.int64) + fi // num_filters
    return dict(base=base, fi=fi, frac=np.zeros_like(frac0),
                pass_mask=pass_mask, pass_idx=pass_idx)



def apply_numpy(L: np.ndarray, bank: np.ndarray, parts: dict,
                interpolate: bool, dtype) -> np.ndarray:
    """Parity backend: float64-accumulated windowed dot per position.

    L: [ch, S] linear buffer; bank: [F+1, T]; returns [ch, K] in ``dtype``.
    """
    ch, _ = L.shape
    T = bank.shape[1]
    K = parts["base"].shape[0]
    if K == 0:
        return np.zeros((ch, 0), dtype=dtype)
    win = np.lib.stride_tricks.sliding_window_view(L, T, axis=1)
    win = win[:, parts["base"], :]                     # [ch, K, T]
    f1 = bank[parts["fi"]]                             # [K, T]
    if interpolate:
        f2 = bank[parts["fi"] + 1]
        d1 = np.einsum("ckt,kt->ck", win, f1, dtype=np.float64)
        d2 = np.einsum("ckt,kt->ck", win, f2, dtype=np.float64)
        frac = parts["frac"][None, :]
        out = d1 * (1.0 - frac) + d2 * frac
    else:
        out = np.einsum("ckt,kt->ck", win, f1, dtype=np.float64)
        if parts["pass_mask"].any():
            passthrough = L[:, parts["pass_idx"]]
            out = np.where(parts["pass_mask"][None, :], passthrough, out)
    return out.astype(dtype, copy=False)


@functools.lru_cache(maxsize=1)
def _jitted_apply():
    from .._jaxinit import ensure_jax
    jax = ensure_jax()
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("interpolate", "use_pass",
                                                 "num_taps"))
    def _apply_jax(L, bank, base, fi, frac, pass_mask, pass_idx,
                   interpolate: bool, use_pass: bool, num_taps: int):
        taps_iota = jnp.arange(num_taps, dtype=base.dtype)
        idx = base[:, None] + taps_iota[None, :]       # [K, T]
        win = jnp.take(L, idx, axis=1)                 # [ch, K, T]
        if interpolate:
            fr = frac.astype(bank.dtype)[:, None]
            w = jnp.take(bank, fi, axis=0) * (1.0 - fr) \
                + jnp.take(bank, fi + 1, axis=0) * fr
        else:
            w = jnp.take(bank, fi, axis=0)
        # HIGHEST: a default-precision f32 dot may run in bf16 or TF32
        out = jax.lax.dot_general(
            win, w,
            dimension_numbers=(((2,), (1,)), ((1,), (0,))),
            preferred_element_type=bank.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )                                              # [K, ch]
        out = out.T
        if use_pass:
            out = jnp.where(pass_mask[None, :], jnp.take(L, pass_idx, axis=1),
                            out)
        return out

    return _apply_jax


def apply_jax(L: np.ndarray, bank_dev, parts: dict, interpolate: bool,
              dtype, bucket: int = 1024) -> np.ndarray:
    """JAX backend with shape bucketing for compile-cache reuse."""
    import jax.numpy as jnp
    _apply_jax = _jitted_apply()
    ch, S = L.shape
    K = parts["base"].shape[0]
    if K == 0:
        return np.zeros((ch, 0), dtype=dtype)
    T = bank_dev.shape[1]
    Kp = -(-K // bucket) * bucket
    Sp = -(-S // bucket) * bucket + T
    Lp = np.zeros((ch, Sp), dtype=dtype)
    Lp[:, :S] = L
    base = np.zeros(Kp, dtype=np.int32)
    base[:K] = parts["base"]
    fi = np.zeros(Kp, dtype=np.int32)
    fi[:K] = parts["fi"]
    frac = np.zeros(Kp, dtype=np.float64)
    frac[:K] = parts["frac"]
    pass_mask = np.zeros(Kp, dtype=bool)
    pass_mask[:K] = parts["pass_mask"]
    pass_idx = np.zeros(Kp, dtype=np.int32)
    pass_idx[:K] = parts["pass_idx"]
    use_pass = bool(parts["pass_mask"].any())
    # tile the output axis: the [ch, tile, T] gather intermediate must
    # stay bounded (an untiled 2^18-frame call can fuse to a tens-of-GB
    # intermediate)
    tile = 65536
    Ld = jnp.asarray(Lp)
    chunks = []
    for k0 in range(0, Kp, tile):
        k1 = min(k0 + tile, Kp)
        o = _apply_jax(Ld, bank_dev, jnp.asarray(base[k0:k1]),
                       jnp.asarray(fi[k0:k1]), jnp.asarray(frac[k0:k1]),
                       jnp.asarray(pass_mask[k0:k1]),
                       jnp.asarray(pass_idx[k0:k1]),
                       interpolate, use_pass, T)
        chunks.append(np.asarray(o))
    return np.concatenate(chunks, axis=1)[:, :K].astype(dtype, copy=False)


def apply_numpy_periodic(L: np.ndarray, bank: np.ndarray, parts: dict,
                         interpolate: bool, dtype, Lp: int, Mp: int
                         ) -> np.ndarray | None:
    """Block-GEMM fast path for fixed rational ratios (reduced or not).

    Within one call the emission positions advance by exactly Mp inputs per
    Lp outputs, so the phase pattern (window offset, filter index, fraction)
    repeats with period Lp and the whole windowed dot factors into one
    [groups, Mp+T] x [Mp+T, Lp] matrix product per filter row — the same
    math as the reference's per-sample loop (reference resampler.c:1147-1157)
    at BLAS speed instead of a gather.  No periodicity is *assumed*: the
    exact per-output (base, fi, frac) arrays are checked column-by-column,
    and any column whose pattern varies across groups (float64 ties at the
    phase-grid edges) plus the non-periodic tail fall back to the gather
    path.  float64 accumulation and the reference's dot-then-lerp order are
    preserved.  Returns None when the layout does not pay off.
    """
    base, fi, frac = parts["base"], parts["fi"], parts["frac"]
    K = base.shape[0]
    T = bank.shape[1]
    G = K // Lp
    if G < 2:
        return None
    Kfast = G * Lp
    pred = base[0] + np.arange(G, dtype=np.int64)[:, None] * Mp
    b2 = base[:Kfast].reshape(G, Lp)
    f2 = fi[:Kfast].reshape(G, Lp)
    r2 = frac[:Kfast].reshape(G, Lp)
    # only the integer pattern (window offset, filter index) must repeat:
    # the float64 fraction enters as a per-output lerp weight after the
    # dots, so its last-ulp wobble across groups costs nothing
    d = b2 - pred
    ok = (np.all(d == d[0], axis=0) & np.all(f2 == f2[0], axis=0)
          & (d[0] >= 0))
    if interpolate is False and parts["pass_mask"].any():
        ok &= ~parts["pass_mask"][:Kfast].reshape(G, Lp).any(axis=0)
    n_ok = int(ok.sum())
    if n_ok == 0 or n_ok < Lp // 2:
        # n_ok == 0 matters at Lp == 1 (e.g. integer-factor allpass
        # downsample: the single slot is the passthrough shortcut), where
        # the Lp//2 bound is vacuous and dj would be an empty reduction
        return None
    dj = d[0, ok].astype(np.int64)
    span = int(dj.max()) + T
    A0 = int(base[0])
    ch, S = L.shape
    if A0 < 0 or A0 + (G - 1) * Mp + span > S:
        return None

    # overlapping group windows as a strided view, flattened to one 2D
    # dgemm (batched 3D matmuls and offset-binned sub-gemms both measured
    # slower than a single banded gemm at these shapes)
    s0, s1 = L.strides
    X = np.lib.stride_tricks.as_strided(
        L[:, A0:], shape=(ch, G, span), strides=(s0, Mp * s1, s1))
    X64 = np.ascontiguousarray(X, dtype=np.float64).reshape(ch * G, span)

    fj = f2[0, ok]
    if interpolate:
        P = np.zeros((span, 2 * n_ok), dtype=np.float64)
        for c, (off, p) in enumerate(zip(dj, fj)):
            P[off:off + T, c] = bank[p]
            P[off:off + T, n_ok + c] = bank[p + 1]
        dd = (X64 @ P).reshape(ch, G, 2 * n_ok)
        rj = r2[:, ok][None, :, :]                    # exact per-output frac
        vals = dd[:, :, :n_ok] * (1.0 - rj) + dd[:, :, n_ok:] * rj
    else:
        P = np.zeros((span, n_ok), dtype=np.float64)
        for c, (off, p) in enumerate(zip(dj, fj)):
            P[off:off + T, c] = bank[p]
        vals = (X64 @ P).reshape(ch, G, n_ok)

    out = np.empty((ch, K), dtype=np.float64)
    cols = np.flatnonzero(ok)
    idx = (np.arange(G)[:, None] * Lp + cols[None, :]).ravel()
    out[:, idx] = vals.reshape(ch, -1)

    # residual: tie-flipped columns and the non-periodic tail via the
    # gather parity path
    rest = np.ones(K, dtype=bool)
    rest[idx] = False
    if rest.any():
        sub = {k: v[rest] for k, v in parts.items()}
        out[:, rest] = apply_numpy(L, bank, sub, interpolate, np.float64)
    return out.astype(dtype, copy=False)
