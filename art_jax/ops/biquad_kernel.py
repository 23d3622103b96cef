"""Device biquad filtering via exact block-Toeplitz IIR.

An order-N IIR section y_n = sum_i a_i x_{n-i} - sum_j b_j y_{n-j} splits
into a feed-forward FIR part f_n (a parallel convolution) and the linear
recurrence state_t = A state_{t-1} + f_t e0 with A the constant 4x4
companion matrix of the feedback taps.  Because A is CONSTANT, the
recurrence solves in closed form per block of B samples:

  y_t = G[t] @ s  +  sum_{j<=t} h[t-j] f_j,      t in [0, B)

with h[d] = (A^d)[0,0] the impulse response and G[t] = e0^T A^{t+1} the
boundary rows — i.e. one [B, B] lower-triangular Toeplitz matmul per
block (parallel over blocks) plus a tiny 4-vector carry scan across
blocks (s' = A^B s + trailing-4 contribution).  This is EXACT (no
impulse-response truncation) and replaces the earlier
`lax.associative_scan` over [n, 4, 4] matrix products, which did ~32x the
necessary flops; the block form is matmul-shaped.

This is the high-throughput device path; it reassociates float math, so for
bit-parity with the reference use engines.biquad / the native runtime.  The
math runs in float64 internally to keep the reassociation error below the
float32 quantization floor even for near-unstable shapers.
"""

from __future__ import annotations

import functools

import numpy as np
from .._jaxinit import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp


def biquad_apply_buffer_assoc(biquad, buffer: np.ndarray) -> np.ndarray:
    """Filter [n] or [n, channels] through a Biquad state (engines.biquad)
    using the device block-IIR kernel.  Mutates the biquad history like
    apply_buffer and returns the filtered buffer."""
    buf = np.asarray(buffer)
    squeeze = buf.ndim == 1
    if squeeze:
        buf = buf[:, None]
    n, ch = buf.shape
    dt = buf.dtype

    a = np.asarray(biquad.a, dtype=np.float64)
    b = np.asarray(biquad.b, dtype=np.float64)
    xh = np.asarray(biquad.xh, dtype=np.float64)      # [4, ch] newest-first
    yh = np.asarray(biquad.yh, dtype=np.float64)

    y = _assoc_run(jnp.asarray(buf.astype(np.float64)), jnp.asarray(a),
                   jnp.asarray(b), jnp.asarray(xh), jnp.asarray(yh))
    y = np.asarray(y)

    # update histories (newest-first) like the sequential paths
    joined_x = np.concatenate([xh[::-1].T, buf.astype(np.float64).T], axis=1)
    joined_y = np.concatenate([yh[::-1].T, y.T], axis=1)
    biquad.xh = np.ascontiguousarray(
        joined_x[:, -4:][:, ::-1].T).astype(biquad.xh.dtype)
    biquad.yh = np.ascontiguousarray(
        joined_y[:, -4:][:, ::-1].T).astype(biquad.yh.dtype)
    out = y.astype(dt)
    return out[:, 0] if squeeze else out


_IIR_BLOCK = 256
_IIR_SUPER = 64          # carry-recurrence blocks per outer-scan step


def _carry_power_tables(AB: np.ndarray, Q: int):
    """Closed-form carry tables from the per-block transition AB = A^B:
    PW [Q,4,4] with PW[d] = AB^d, the masked inner window W [Q,Q,4,4]
    with W[q,j] = AB^(q-1-j) for j < q (else 0), WQ [Q,4,4] with
    WQ[j] = AB^(Q-1-j), and ABQ = AB^Q."""
    PW = np.zeros((Q, 4, 4))
    p = np.eye(4)
    for d in range(Q):
        PW[d] = p
        p = p @ AB
    W = np.zeros((Q, Q, 4, 4))
    for q in range(1, Q):
        W[q, :q] = PW[:q][::-1]
    return PW, W, PW[::-1].copy(), p


def iir_tables(b, B: int = _IIR_BLOCK, Q: int = _IIR_SUPER,
               dtype=np.float64):
    """Host-precomputed block-IIR tables for feedback taps ``b`` (numpy
    float64): (T [B,B] lower-triangular Toeplitz impulse response,
    G [B,4] boundary rows e0^T A^(t+1), Wv [4,B] / AB [4,4] the carry
    recurrence rows, and the _carry_power_tables bundle), as device
    arrays, built once per filter instead of per call (a B-step in-graph
    scan).  ``dtype``: table precision — the
    tables are always built in float64 and rounded once (float32 tables
    back the mixed-precision refined solve)."""
    b = np.asarray(b, np.float64)
    A = np.zeros((4, 4))
    A[0] = [-b[1], -b[2], -b[3], -b[4]]
    A[1, 0] = A[2, 1] = A[3, 2] = 1.0
    G = np.zeros((B, 4))
    r = A[0].copy()
    for t in range(B):
        G[t] = r
        r = r @ A
    h = np.concatenate([[1.0], G[:B - 1, 0]])
    d = np.arange(B)[:, None] - np.arange(B)[None, :]
    T = np.where(d >= 0, h[np.clip(d, 0, B - 1)], 0.0)
    AB = G[B - 4:][::-1].copy()
    PW, W, WQ, ABQ = _carry_power_tables(AB, Q)
    return tuple(jnp.asarray(t.astype(dtype)) for t in
                 (T, G, T[B - 4:][::-1].copy(), AB, PW, W, WQ, ABQ))


def _iir_y(f, b, yh, tables=None, sp=None):
    """Solve y_t = f_t - sum_j b[j] y_{t-j} block-parallel (module
    docstring): per block of B samples one lower-triangular Toeplitz
    matmul of the impulse response h plus boundary rows G on the carried
    state; across blocks a 4-vector lax.scan (s' = A^B s + trailing
    contribution).  Exact — no truncation; float64 throughout.

    f [n, S] (forcing, already masked as needed); yh [4, S] newest-first
    output history.  Returns y [n, S] in f's dtype (float64 for the
    exact path; the float32 instantiation backs the mixed-precision
    refined solve — pass matching float32 ``tables``)."""
    n, S = f.shape
    dt = f.dtype
    # geometry rides with the tables (iir_tables(b, B=..., Q=...)) so the
    # block size can be tuned per deployment; the in-graph fallback uses
    # the defaults
    B = tables[0].shape[0] if tables is not None else _IIR_BLOCK
    nb = -(-n // B)
    # pad the stream axis to ``sp`` columns: per-stream results must be
    # bitwise independent of the batch width, because the sharded pipeline
    # step runs this with S_local = S/n_shards and the sharded ==
    # single-device contract is bit-for-bit (tests/test_pipeline.py).
    # XLA picks shape-dependent dot associations (observed on XLA:CPU down
    # to K=4 contractions at S=1), so stability comes from running the
    # SAME kernel shape class on every shard, not from the op choice:
    # callers pass sp = the GLOBAL stream count padded even, which is the
    # same constant on every mesh width (even rather than a multiple of 8:
    # the pad is dead work in the Toeplitz dot).
    Sp = sp if sp is not None else -(-S // 8) * 8
    assert Sp >= S and Sp % 2 == 0, (Sp, S)
    if Sp != S:
        f = jnp.concatenate(
            [f, jnp.zeros((n, Sp - S), dt)], axis=1)
        yh = jnp.concatenate(
            [yh, jnp.zeros((4, Sp - S), dt)], axis=1)
    fp = jnp.concatenate(
        [f, jnp.zeros((nb * B - n, Sp), dt)], axis=0)
    if tables is not None:
        T, G, Wv, AB, PW, W, WQ, ABQ = tables
    else:
        A = jnp.array([[0.0, 0.0, 0.0, 0.0],
                       [1.0, 0.0, 0.0, 0.0],
                       [0.0, 1.0, 0.0, 0.0],
                       [0.0, 0.0, 1.0, 0.0]], dtype=jnp.float64)
        A = A.at[0].set(jnp.stack([-b[1], -b[2], -b[3], -b[4]]))

        # G[t] = e0^T A^(t+1) (row recurrence r <- r@A); h[d] = (A^d)[0,0]
        def gstep(r, _):
            return jnp.dot(r, A, precision=jax.lax.Precision.HIGHEST), r
        _, G = jax.lax.scan(gstep, A[0], None, length=B)      # [B, 4]
        h = jnp.concatenate([jnp.ones((1,), jnp.float64), G[:B - 1, 0]])
        ti = jnp.arange(B)
        d = ti[:, None] - ti[None, :]
        T = jnp.where(d >= 0, h[jnp.clip(d, 0, B - 1)], 0.0)  # [B, B]
        # trailing-4 rows give the carry recurrence s' = AB @ s + v
        # (rows newest-first to match the state layout)
        Wv = T[B - 4:][::-1]                                  # [4, B]
        AB = G[B - 4:][::-1]                                  # [4, 4]
        # carry power tables (see _carry_power_tables), built in-graph
        Q = _IIR_SUPER
        def pstep(p, _):
            return jnp.dot(p, AB, precision=jax.lax.Precision.HIGHEST), p
        ABQ, PW = jax.lax.scan(pstep, jnp.eye(4, dtype=jnp.float64),
                               None, length=Q)                # PW[d]=AB^d
        qi = jnp.arange(Q)
        dmat = qi[:, None] - 1 - qi[None, :]
        W = jnp.where((dmat >= 0)[:, :, None, None],
                      PW[jnp.clip(dmat, 0, Q - 1)], 0.0)      # [Q,Q,4,4]
        WQ = PW[::-1]                                         # [Q,4,4]

    fb = fp.reshape(nb, B, Sp)
    # One wide matmul instead of nb batched [B,B]x[B,Sp] products with a
    # tiny Sp-wide output each: flattening (block, stream) into one axis
    # runs the same flops as [B, B] x [B, nb*Sp]; each output column's
    # contraction is unchanged (same j-order), so per-stream results stay
    # independent of the batch width (the sharded == single-device
    # bit-identity contract).
    F2 = fb.transpose(1, 0, 2).reshape(B, nb * Sp)            # [j, k*s]
    Y2 = _iir_core_F2(F2, yh, (T, G, Wv, AB, PW, W, WQ, ABQ), nb, Sp)
    y = Y2.reshape(B, nb, Sp).transpose(1, 0, 2)
    return y.reshape(nb * B, Sp)[:n, :S]


def _iir_core_F2(F2, yh, tables, nb: int, Sp: int):
    """The block-IIR solve in the dense F2 layout: forcing [B, nb*Sp]
    (row = in-block time, column = block*stream) -> Y2 [B, nb*Sp].  This
    is _iir_y's computational core; the [n, S] wrapper only adds the
    pad/reshape.  Kept layout-native so the refined solve can run its
    pointwise residuals here rather than on [n, 6]-shaped arrays with a
    tiny minor dimension."""
    T, G, Wv, AB, PW, W, WQ, ABQ = tables
    B = T.shape[0]
    dt = F2.dtype
    hi = jax.lax.Precision.HIGHEST
    v2 = jnp.dot(Wv, F2, precision=hi)                        # [4, nb*Sp]
    v = v2.reshape(4, nb, Sp).transpose(1, 0, 2)              # [nb, 4, Sp]

    # Carry recurrence e_{k+1} = AB e_k + v_k, SOLVED IN BLOCKS: a naive
    # nb-step lax.scan of tiny [4,4] dots is as deep as the chunk is
    # long; nb/Q outer steps with closed-form inner contributions through
    # the precomputed AB powers cut the sequential depth Q=64-fold at
    # trivial extra flops.
    #   e_{bQ+q} = AB^q e_{bQ} + sum_{j<q} AB^(q-1-j) v_{bQ+j}
    Q = W.shape[0]
    nsb = -(-nb // Q)
    if nsb * Q != nb:
        v = jnp.concatenate(
            [v, jnp.zeros((nsb * Q - nb, 4, Sp), dt)], axis=0)
    vsb = v.reshape(nsb, Q, 4, Sp)
    inner = jnp.einsum("qjab,kjbs->kqas", W, vsb, precision=hi)
    u = jnp.einsum("jab,kjbs->kas", WQ, vsb, precision=hi)

    def sstep(e, ub):
        return jnp.dot(ABQ, e, precision=hi) + ub, e
    _, E = jax.lax.scan(sstep, yh, u)                         # [nsb, 4, Sp]
    sks = (jnp.einsum("qab,kbs->kqas", PW, E, precision=hi)
           + inner).reshape(nsb * Q, 4, Sp)[:nb]              # [nb, 4, Sp]

    S2 = sks.transpose(1, 0, 2).reshape(4, nb * Sp)
    # ONE fused dot [T|G] @ [F2; S2] instead of T@F2 + G@S2: one pass
    # over the [B, N] output instead of two
    TG = jnp.concatenate([T, G], axis=1)                      # [B, B+4]
    FS = jnp.concatenate([F2, S2], axis=0)                    # [B+4, N]
    return jnp.dot(TG, FS, precision=hi)


def _shift_F2(Y, j: int, yh_oldfirst, B: int, Sp: int):
    """Time-shift by j (1..4) in the F2 layout [B, nb*Sp]: rows t >= j
    come from the same block j rows up; rows t < j come from the
    PREVIOUS block's trailing rows = the same rows shifted one
    block (Sp columns) right, with the chunk boundary history filling
    block 0.  yh_oldfirst [4, Sp] is the boundary y oldest-first
    (y_{-4}..y_{-1})."""
    top = jnp.concatenate([yh_oldfirst[4 - j:], Y[B - j:, :-Sp]], axis=1)
    return jnp.concatenate([top, Y[:B - j]], axis=0)


def _iir_y_refined(f, b, yh, tables32, sp=None, passes: int = 2):
    """Mixed-precision _iir_y: f32 block solves + float64 pointwise
    5-tap residuals against the TRUE f64 recurrence.

    The system is linear, so iterative refinement applies: solve in f32
    (error ~2^-24 * gain), form r = f - (y + sum b_j y_{t-j}) in f64
    (pointwise, cheap), solve the residual in f32, add.  Two passes land
    at the exact solve's own accuracy class (~5e-15 rel at the config-4
    geometry incl. streaming carries; one pass reaches ~3e-12).  It was
    built for a device without native f64 dots; whether it still beats
    the exact f64 solve on the H100 is not yet measured.

    Everything runs in the dense F2 layout [B, nb*Sp] (shifts are static
    row/column slices, _shift_F2), never on [n, S]-shaped arrays with a
    tiny minor dimension.

    Every correction solve starts from ZERO state: each residual is
    formed with the EXACT f64 boundary substituted into the shifted
    terms (_shift_F2(..., yh_old)), so the remaining correction's own
    pre-chunk values are identically zero.  (An earlier version seeded
    pass 1 with yh - f32(yh) — the residual-against-y1's-own-boundary
    formulation's seed — which injected a spurious ~2^-24*|yh| chunk
    transient; caught in review.  Zero seeding took one-pass streaming
    error from ~1e-7 to ~3e-12 and two-pass to ~5e-15.)"""
    n, S = f.shape
    B = tables32[0].shape[0]
    nb = -(-n // B)
    Sp = sp if sp is not None else -(-S // 8) * 8
    assert Sp >= S and Sp % 2 == 0, (Sp, S)
    if Sp != S:
        f = jnp.concatenate(
            [f, jnp.zeros((n, Sp - S), f.dtype)], axis=1)
        yh = jnp.concatenate(
            [yh, jnp.zeros((4, Sp - S), yh.dtype)], axis=1)
    fp = jnp.concatenate(
        [f, jnp.zeros((nb * B - n, Sp), f.dtype)], axis=0)
    F2d = fp.reshape(nb, B, Sp).transpose(1, 0, 2).reshape(B, nb * Sp)
    Y = _refine_F2(F2d, b, yh, tables32, nb, Sp, passes)
    y = Y.reshape(B, nb, Sp).transpose(1, 0, 2)
    return y.reshape(nb * B, Sp)[:n, :S]


def _refine_F2(F2d, b, yh, tables32, nb: int, Sp: int, passes: int = 2):
    """The refinement loop on an F2-layout f64 forcing (shared by
    _iir_y_refined and assoc_core_full_T): f32 solve, then ``passes``
    rounds of exact-boundary f64 residual + zero-state f32 correction
    solve.  Returns Y2 [B, nb*Sp] f64."""
    B = tables32[0].shape[0]
    Y = _iir_core_F2(F2d.astype(jnp.float32), yh.astype(jnp.float32),
                     tables32, nb, Sp).astype(jnp.float64)
    z32 = jnp.zeros((4, Sp), jnp.float32)
    yh_old = yh[::-1]                        # oldest-first f64 boundary
    for _ in range(passes):
        R = F2d - (Y
                   + b[1] * _shift_F2(Y, 1, yh_old, B, Sp)
                   + b[2] * _shift_F2(Y, 2, yh_old, B, Sp)
                   + b[3] * _shift_F2(Y, 3, yh_old, B, Sp)
                   + b[4] * _shift_F2(Y, 4, yh_old, B, Sp))
        E = _iir_core_F2(R.astype(jnp.float32), z32, tables32, nb, Sp)
        Y = Y + E.astype(jnp.float64)
    return Y


def _to_F2(x_sn, nb: int, B: int, Sp: int):
    """[S, n] channel-major input -> dense F2 [B, nb*Sp] without ever
    materializing a [n, S] array with a tiny minor dimension."""
    S, n = x_sn.shape
    if Sp != S:
        x_sn = jnp.concatenate(
            [x_sn, jnp.zeros((Sp - S, n), x_sn.dtype)], axis=0)
    if nb * B != n:
        x_sn = jnp.concatenate(
            [x_sn, jnp.zeros((Sp, nb * B - n), x_sn.dtype)], axis=1)
    return x_sn.reshape(Sp, nb, B).transpose(2, 1, 0).reshape(B, nb * Sp)


def _from_F2(Y2, nb: int, B: int, Sp: int, S: int, n: int):
    """F2 [B, nb*Sp] -> [S, n] channel-major (inverse of _to_F2)."""
    y = Y2.reshape(B, nb, Sp).transpose(2, 1, 0).reshape(Sp, nb * B)
    return y[:S, :n]


def _pick_rows_F2(Z2, n: int, B: int, Sp: int):
    """The last 4 valid time rows (t = n-4..n-1) of an F2-layout array,
    returned newest-first [4, Sp] — static row/column picks."""
    rows = []
    for t in (n - 1, n - 2, n - 3, n - 4):
        k, r = t // B, t % B
        rows.append(jax.lax.slice(Z2, (r, k * Sp), (r + 1, (k + 1) * Sp)))
    return jnp.concatenate(rows, axis=0)


def assoc_core_full_T(x_sn, a, b, xh, yh, tables=None, sp=None,
                      tables32=None):
    """assoc_core_full with channel-major [S, n] input/output and the
    ENTIRE computation in the dense F2 layout: FIR prologue, solve, and
    state extraction all avoid [n, S]-shaped intermediates with a tiny
    minor dimension.  Same products/sums per element as assoc_core_full,
    so outputs and state are bitwise-identical."""
    S, n = x_sn.shape
    dt = x_sn.dtype
    B = tables[0].shape[0] if tables is not None else (
        tables32[0].shape[0] if tables32 is not None else _IIR_BLOCK)
    nb = -(-n // B)
    Sp = sp if sp is not None else -(-S // 8) * 8
    assert Sp >= S and Sp % 2 == 0, (Sp, S)
    a = jnp.asarray(a, jnp.float64)
    b = jnp.asarray(b, jnp.float64)
    xh = jnp.asarray(xh, jnp.float64)
    yh = jnp.asarray(yh, jnp.float64)
    if Sp != S:
        zpad = jnp.zeros((4, Sp - S), jnp.float64)
        xh = jnp.concatenate([xh, zpad], axis=1)
        yh = jnp.concatenate([yh, zpad], axis=1)
    X2 = _to_F2(x_sn.astype(jnp.float64), nb, B, Sp)
    xh_old = xh[::-1]
    f = (a[0] * X2
         + a[1] * _shift_F2(X2, 1, xh_old, B, Sp)
         + a[2] * _shift_F2(X2, 2, xh_old, B, Sp)
         + a[3] * _shift_F2(X2, 3, xh_old, B, Sp)
         + a[4] * _shift_F2(X2, 4, xh_old, B, Sp))
    if tables32 is not None:
        Y2 = _refine_F2(f, b, yh, tables32, nb, Sp)
    else:
        if tables is None:
            raise NotImplementedError(
                "assoc_core_full_T needs precomputed iir_tables")
        Y2 = _iir_core_F2(f, yh, tables, nb, Sp)
    # state after n samples: last 4 valid x / y, newest-first (covers
    # n >= 4; the streaming engines never call with shorter chunks)
    xh_n = _pick_rows_F2(X2, n, B, Sp)[:, :S]
    yh_n = _pick_rows_F2(Y2, n, B, Sp)[:, :S]
    return _from_F2(Y2, nb, B, Sp, S, n).astype(dt), xh_n, yh_n


def _pick_time_F2(Z2, boundary_old, t, B: int, Sp: int):
    """One [Sp] row at DYNAMIC time t of an F2-layout array, falling back
    to the boundary history (oldest-first [4, Sp], time -4..-1) for
    t < 0.  t is a traced int32 scalar in [-4, n)."""
    tc = jnp.maximum(t, 0)
    k, r = tc // B, tc % B
    row = jax.lax.dynamic_slice(Z2, (r, k * Sp), (1, Sp))
    brow = jax.lax.dynamic_slice(
        boundary_old, (jnp.maximum(t + 4, 0), jnp.int32(0)), (1, Sp))
    return jnp.where(t < 0, brow, row)


def assoc_core_masked_T(x_sn, a, b, xh, yh, K, tables=None, sp=None,
                        tables32=None):
    """assoc_core_masked with channel-major [S, n] input/output, F2-native
    like assoc_core_full_T (no [n, S]-shaped intermediates): the validity
    mask is the static iota comparison (k*B + t) < K in F2 coordinates,
    and the state-after-K extraction picks 4 dynamic time rows
    (_pick_time_F2, boundary fallback for K < 4).  Same products/sums
    per element as assoc_core_masked — outputs and state bitwise-equal
    (tests/test_biquad.py)."""
    S, n = x_sn.shape
    dt = x_sn.dtype
    B = tables[0].shape[0] if tables is not None else (
        tables32[0].shape[0] if tables32 is not None else _IIR_BLOCK)
    nb = -(-n // B)
    Sp = sp if sp is not None else -(-S // 8) * 8
    assert Sp >= S and Sp % 2 == 0, (Sp, S)
    a = jnp.asarray(a, jnp.float64)
    b = jnp.asarray(b, jnp.float64)
    xh = jnp.asarray(xh, jnp.float64)
    yh = jnp.asarray(yh, jnp.float64)
    if Sp != S:
        zpad = jnp.zeros((4, Sp - S), jnp.float64)
        xh = jnp.concatenate([xh, zpad], axis=1)
        yh = jnp.concatenate([yh, zpad], axis=1)
    X2 = _to_F2(x_sn.astype(jnp.float64), nb, B, Sp)
    trow = jnp.arange(B, dtype=jnp.int32)[:, None]
    kblk = (jnp.arange(nb * Sp, dtype=jnp.int32) // Sp)[None, :]
    active = (kblk * B + trow) < K
    X2 = jnp.where(active, X2, 0.0)
    xh_old = xh[::-1]
    f = (a[0] * X2
         + a[1] * _shift_F2(X2, 1, xh_old, B, Sp)
         + a[2] * _shift_F2(X2, 2, xh_old, B, Sp)
         + a[3] * _shift_F2(X2, 3, xh_old, B, Sp)
         + a[4] * _shift_F2(X2, 4, xh_old, B, Sp))
    f = jnp.where(active, f, 0.0)
    if tables32 is not None:
        Y2 = _refine_F2(f, b, yh, tables32, nb, Sp)
    else:
        if tables is None:
            raise NotImplementedError(
                "assoc_core_masked_T needs precomputed iir_tables")
        Y2 = _iir_core_F2(f, yh, tables, nb, Sp)
    Y2 = jnp.where(active, Y2, 0.0)
    # state after exactly K samples: times K-4..K-1, newest-first
    # (boundary history covers K < 4)
    yh_old = yh[::-1]
    xh_n = jnp.concatenate(
        [_pick_time_F2(X2, xh_old, K - 1 - i, B, Sp) for i in range(4)],
        axis=0)[:, :S]
    yh_n = jnp.concatenate(
        [_pick_time_F2(Y2, yh_old, K - 1 - i, B, Sp) for i in range(4)],
        axis=0)[:, :S]
    return _from_F2(Y2, nb, B, Sp, S, n).astype(dt), xh_n, yh_n


def assoc_core_masked(x, a, b, xh, yh, K, tables=None, sp=None,
                      tables32=None):
    """Pure masked block-IIR biquad for the fused device pipeline.

    x [n, S] (rows at k >= K ignored); a/b [5]; xh/yh [4, S] newest-first;
    ``tables`` optional precomputed iir_tables(b) (else built
    in-graph).  Forcing beyond K is zeroed, so y below K is exact
    and the state extraction at K advances the filter by exactly K samples
    on ragged chunks.  Runs in float64 internally (see module docstring);
    returns (y [n, S] in x.dtype, zeroed beyond K, and the newest-first
    xh'/yh' after K samples)."""
    n, S = x.shape
    dt = x.dtype
    active = (jnp.arange(n, dtype=jnp.int32) < K)[:, None]
    xm = jnp.where(active, x, 0).astype(jnp.float64)
    a = jnp.asarray(a, jnp.float64)
    b = jnp.asarray(b, jnp.float64)
    xh = jnp.asarray(xh, jnp.float64)
    yh = jnp.asarray(yh, jnp.float64)

    xpad = jnp.concatenate([xh[::-1], xm], axis=0)
    f = (a[0] * xpad[4:] + a[1] * xpad[3:-1] + a[2] * xpad[2:-2]
         + a[3] * xpad[1:-3] + a[4] * xpad[:-4])
    f = jnp.where(active, f, 0.0)

    if tables32 is not None:
        y = _iir_y_refined(f, b, yh, tables32, sp)
    else:
        y = _iir_y(f, b, yh, tables, sp)
    y = jnp.where(active, y, 0.0)

    # state after exactly K samples: the last 4 valid x / y values
    # (carry-in history covers K < 4)
    jx = jnp.concatenate([xh[::-1], xm], axis=0)       # oldest..newest
    jy = jnp.concatenate([yh[::-1], y], axis=0)
    xh_n = jax.lax.dynamic_slice(jx, (K, jnp.int32(0)), (4, S))[::-1]
    yh_n = jax.lax.dynamic_slice(jy, (K, jnp.int32(0)), (4, S))[::-1]
    return y.astype(dt), xh_n, yh_n


def assoc_core_full(x, a, b, xh, yh, tables=None, sp=None, tables32=None):
    """assoc_core_masked for the K == n (whole-chunk-valid) case: the
    validity masks vanish and the state extraction is a static slice.
    Bitwise-identical outputs/state to the masked form at K == n (the
    masks multiply by 1.0 there) without its f64 pointwise where-passes
    — the steady-state streaming cascade shape
    (DeviceBiquadCascade.process on full chunks)."""
    n, S = x.shape
    dt = x.dtype
    xm = x.astype(jnp.float64)
    a = jnp.asarray(a, jnp.float64)
    b = jnp.asarray(b, jnp.float64)
    xh = jnp.asarray(xh, jnp.float64)
    yh = jnp.asarray(yh, jnp.float64)
    xpad = jnp.concatenate([xh[::-1], xm], axis=0)
    f = (a[0] * xpad[4:] + a[1] * xpad[3:-1] + a[2] * xpad[2:-2]
         + a[3] * xpad[1:-3] + a[4] * xpad[:-4])
    if tables32 is not None:
        y = _iir_y_refined(f, b, yh, tables32, sp)
    else:
        y = _iir_y(f, b, yh, tables, sp)
    xh_n = xpad[n:][::-1]
    yh_n = jnp.concatenate([yh[::-1], y], axis=0)[n:][::-1]
    return y.astype(dt), xh_n, yh_n


@functools.partial(jax.jit, static_argnames=("sp",))
def _cascade2_step(x, a1, b1, xh1, yh1, a2, b2, xh2, yh2, K, t1, t2,
                   sp=None, t1_32=None, t2_32=None):
    """Two cascaded masked block-IIR sections in one dispatch (the ART
    CLI's pre/post filter is always a 2-section cascade, reference
    art.c:847-876).  t1/t2: precomputed iir_tables per section;
    t*_32: optional f32 tables selecting the refined solve."""
    y1, xh1n, yh1n = assoc_core_masked(x, a1, b1, xh1, yh1, K, t1, sp,
                                       t1_32)
    y2, xh2n, yh2n = assoc_core_masked(y1, a2, b2, xh2, yh2, K, t2, sp,
                                       t2_32)
    return y2, xh1n, yh1n, xh2n, yh2n


@functools.partial(jax.jit, static_argnames=("sp",))
def _cascade2_step_full(x, a1, b1, xh1, yh1, a2, b2, xh2, yh2, t1, t2,
                        sp=None, t1_32=None, t2_32=None):
    """_cascade2_step for full-chunk calls (K == n): see assoc_core_full."""
    y1, xh1n, yh1n = assoc_core_full(x, a1, b1, xh1, yh1, t1, sp, t1_32)
    y2, xh2n, yh2n = assoc_core_full(y1, a2, b2, xh2, yh2, t2, sp, t2_32)
    return y2, xh1n, yh1n, xh2n, yh2n


@functools.partial(jax.jit, static_argnames=("sp",))
def _comb4_step(x, a, b, xh, yh, K, t, sp=None, t32=None):
    """One combined order-4 section, masked (see combine_biquads)."""
    return assoc_core_masked(x, a, b, xh, yh, K, t, sp, t32)


@functools.partial(jax.jit, static_argnames=("sp",))
def _comb4_step_full(x, a, b, xh, yh, t, sp=None, t32=None):
    """One combined order-4 section, full-chunk."""
    return assoc_core_full(x, a, b, xh, yh, t, sp, t32)


@functools.partial(jax.jit, static_argnames=("sp",))
def _cascade2_step_T(x_sn, a1, b1, xh1, yh1, a2, b2, xh2, yh2, K, t1,
                     t2, sp=None, t1_32=None, t2_32=None):
    """_cascade2_step on channel-major [S, n] data (masked F2-native
    fast path, assoc_core_masked_T)."""
    y1, xh1n, yh1n = assoc_core_masked_T(x_sn, a1, b1, xh1, yh1, K, t1,
                                         sp, t1_32)
    y2, xh2n, yh2n = assoc_core_masked_T(y1, a2, b2, xh2, yh2, K, t2,
                                         sp, t2_32)
    return y2, xh1n, yh1n, xh2n, yh2n


@functools.partial(jax.jit, static_argnames=("sp",))
def _comb4_step_T(x_sn, a, b, xh, yh, K, t, sp=None, t32=None):
    """One combined order-4 section, masked, channel-major [S, n]."""
    return assoc_core_masked_T(x_sn, a, b, xh, yh, K, t, sp, t32)


@functools.partial(jax.jit, static_argnames=("sp",))
def _cascade2_step_full_T(x_sn, a1, b1, xh1, yh1, a2, b2, xh2, yh2, t1,
                          t2, sp=None, t1_32=None, t2_32=None):
    """_cascade2_step_full on channel-major [S, n] data — the F2-native
    fast path (assoc_core_full_T): no [n, S]-shaped intermediates."""
    y1, xh1n, yh1n = assoc_core_full_T(x_sn, a1, b1, xh1, yh1, t1, sp,
                                       t1_32)
    y2, xh2n, yh2n = assoc_core_full_T(y1, a2, b2, xh2, yh2, t2, sp,
                                       t2_32)
    return y2, xh1n, yh1n, xh2n, yh2n


@functools.partial(jax.jit, static_argnames=("sp",))
def _comb4_step_full_T(x_sn, a, b, xh, yh, t, sp=None, t32=None):
    """One combined order-4 section, full-chunk, channel-major [S, n]."""
    return assoc_core_full_T(x_sn, a, b, xh, yh, t, sp, t32)


def combine_biquads(bq1, bq2):
    """Combine a 2-section biquad cascade into ONE order-4 section.

    The companion-matrix block-IIR kernel is already order-4, so the
    ART -p cascade (reference art.c:847-876, always two biquads) can run
    as a single section with the polynomial products
    a_c = a1 * a2 (feed-forward) and b_c = b1 * b2 (feedback): HALF the
    Toeplitz/FIR work.

    Parity class: mathematically identical transfer function; the
    rounded coefficient products + the reassociated order-4 recurrence
    sit at ~2.4e-13 relative vs the sequential cascade (the cascade form
    itself sits at ~1e-14 vs the host pair) — documented in PARITY.md.
    The combined state is (input history, FINAL output history); the
    cascade's internal section-1 output history is not represented, so a
    combined engine cannot hand state back to a host Biquad PAIR
    mid-stream (DeviceBiquadCascade.pull_to raises).
    """
    a1, b1 = np.asarray(bq1.a, np.float64), np.asarray(bq1.b, np.float64)
    a2, b2 = np.asarray(bq2.a, np.float64), np.asarray(bq2.b, np.float64)
    # the product of two order<=2 sections is the order-4 ceiling of the
    # companion kernel; an order-3/4 input section would be silently
    # truncated by the [:3] slices below, so refuse it
    for a, b in ((a1, b1), (a2, b2)):
        if np.any(a[3:] != 0.0) or np.any(b[3:] != 0.0):
            raise ValueError(
                "combine_biquads needs order<=2 sections (their product "
                "is order 4, the block-IIR kernel's ceiling); got an "
                "order-3/4 section — run it as a separate cascade stage")
    ac = np.convolve(a1[:3], a2[:3])
    bc = np.convolve(np.concatenate([[1.0], b1[1:3]]),
                     np.concatenate([[1.0], b2[1:3]]))
    bc[0] = 0.0                                        # b[0] unused
    return ac, bc


class DeviceBiquadCascade:
    """Two cascaded biquad sections applied device-side via the masked
    block-Toeplitz IIR, with streaming filter state carried device-resident
    and exact state interchange with the host ``engines.biquad.Biquad``
    pair (the CLI's -p post filter between the device resample and
    decimate stages; reference art.c:1052-1058).

    Parity class: the kernel computes in float64 and rounds each output once
    to the data dtype, while the host path rounds every intermediate at
    dtype — outputs agree at the dtype rounding floor (documented in
    PARITY.md), counts exactly.

    ``combined=True`` runs the cascade as ONE order-4 section (see
    combine_biquads: half the Toeplitz/FIR work) at the ~2.4e-13
    parity class; its state cannot be handed back
    to a host PAIR mid-stream (pull_to raises — use the default cascade
    form where the CLI's host/device interleaving needs exact handoff).

    ``refine`` (default True) solves each section by mixed-precision
    iterative refinement (_iir_y_refined: f32 solves + f64 pointwise
    residuals in the dense F2 layout) instead of the f64 Toeplitz dot —
    the same accuracy class as the exact solve (~1e-14 rel, incl.
    streaming carries).  It was chosen where f64 dots were emulated; on
    the H100, which has native f64, the two are not yet compared.
    ``refine=False`` keeps the exact f64 solve."""

    def __init__(self, bq1, bq2, combined: bool = False,
                 refine: bool = True):
        self._combined = bool(combined)
        t32 = ((lambda b: iir_tables(b, dtype=np.float32)) if refine
               else (lambda b: None))
        if combined:
            ac, bc = combine_biquads(bq1, bq2)
            self._coef = (jnp.asarray(ac), jnp.asarray(bc))
            self._tabs = (iir_tables(bc),)
            self._tabs32 = (t32(bc),)
        else:
            self._coef = tuple(
                jnp.asarray(np.asarray(v, np.float64))
                for v in (bq1.a, bq1.b, bq2.a, bq2.b))
            self._tabs = (iir_tables(bq1.b), iir_tables(bq2.b))
            self._tabs32 = (t32(bq1.b), t32(bq2.b))
        self._state = None                 # (xh1, yh1, xh2, yh2) on device

    def push_from(self, bq1, bq2) -> None:
        """Adopt the host pair's streaming state (device takes over).
        Combined form: the order-4 state is (cascade input history,
        final output history) = (bq1.xh, bq2.yh)."""
        if self._combined:
            self._state = (jnp.asarray(np.asarray(bq1.xh, np.float64)),
                           jnp.asarray(np.asarray(bq2.yh, np.float64)))
            return
        self._state = tuple(
            jnp.asarray(np.asarray(v, np.float64))
            for v in (bq1.xh, bq1.yh, bq2.xh, bq2.yh))

    def pull_to(self, bq1, bq2) -> None:
        """Hand the streaming state back to the host pair."""
        if self._combined:
            raise NotImplementedError(
                "the combined order-4 form does not carry the cascade's "
                "internal section-1 output history; use "
                "DeviceBiquadCascade(combined=False) where mid-stream "
                "host handoff is needed")
        xh1, yh1, xh2, yh2 = (np.asarray(s) for s in self._state)
        bq1.xh = xh1.astype(bq1.xh.dtype)
        bq1.yh = yh1.astype(bq1.yh.dtype)
        bq2.xh = xh2.astype(bq2.xh.dtype)
        bq2.yh = yh2.astype(bq2.yh.dtype)
        self._state = None

    def process(self, dev_out, K: int):
        """Filter dev_out [ch, cap] (first K columns valid) through both
        sections; returns the filtered [ch, cap] device array."""
        # stream pad = the channel count padded even (this engine is the
        # unsharded CLI path, so the global width IS ch; see _iir_y)
        sp = -(-dev_out.shape[0] // 2) * 2
        if self._combined:
            a, b = self._coef
            xh, yh = self._state
            (t,) = self._tabs
            (t32,) = self._tabs32
            if K == dev_out.shape[1]:
                # F2-native full-chunk path: no [n, ch]-shaped arrays
                y, xh, yh = _comb4_step_full_T(dev_out, a, b, xh, yh, t,
                                               sp=sp, t32=t32)
            else:
                y, xh, yh = _comb4_step_T(dev_out, a, b, xh, yh,
                                          jnp.int32(K), t, sp=sp, t32=t32)
            self._state = (xh, yh)
            return y
        a1, b1, a2, b2 = self._coef
        xh1, yh1, xh2, yh2 = self._state
        t1, t2 = self._tabs
        t1_32, t2_32 = self._tabs32
        if K == dev_out.shape[1]:
            # whole chunk valid (the steady-state streaming shape): the
            # F2-native maskless path — no masks, no [n, ch]-shaped
            # intermediates; bitwise-identical values to the masked form
            y, xh1, yh1, xh2, yh2 = _cascade2_step_full_T(
                dev_out, a1, b1, xh1, yh1, a2, b2, xh2, yh2, t1, t2,
                sp=sp, t1_32=t1_32, t2_32=t2_32)
        else:
            y, xh1, yh1, xh2, yh2 = _cascade2_step_T(
                dev_out, a1, b1, xh1, yh1, a2, b2, xh2, yh2,
                jnp.int32(K), t1, t2, sp=sp, t1_32=t1_32, t2_32=t2_32)
        self._state = (xh1, yh1, xh2, yh2)
        return y


@jax.jit
def _assoc_run(x, a, b, xh, yh):
    # FIR part: f_n = sum_i a[i] * x_{n-i}, with the carried input history
    xpad = jnp.concatenate([xh[::-1], x], axis=0)      # [4+n, ch], oldest..
    f = (a[0] * xpad[4:] + a[1] * xpad[3:-1] + a[2] * xpad[2:-2]
         + a[3] * xpad[1:-3] + a[4] * xpad[:-4])       # [n, ch]
    return _iir_y(f.astype(jnp.float64), b.astype(jnp.float64),
                  yh.astype(jnp.float64)).astype(x.dtype)
