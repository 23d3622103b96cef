"""The production chunk pipeline, fused and shardable.

One device step = resample (block-Toeplitz matmuls, the production
formulation from parallel/streams.py) -> TPDF dither (closed-form LCG,
device uint32 math) -> noise-shaped quantization (lax.scan with the
reference's float op order) -> little-endian byte packing, with streaming
state (history, LCG states, shaper histories, error feedback) carried as
pure inputs/outputs.  Bit-exactness of the quantization stages matches the
host decimator (tests/test_pipeline.py); the resample stage sits at the f32
matmul floor of the host engine like the rest of the device path.

Multi-chip: ``make_sharded_step`` shard_maps the same math over a
(streams x taps) mesh — streams (channels / concurrent clips / sessions)
are data-parallel with no hot-path collectives; the polyphase contraction
is tensor-parallel over its shift blocks with one psum; clip counts and
output power reduce over the mesh like the reference's summed per-channel
returns (reference decimator.c:114-149, resampler.c:441-484).  The same
step with a 1x1 mesh is the single-device path, so sharded == single-device
is testable directly (the multi-device analog of the reference's
threaded == unthreaded guarantee).
"""

from __future__ import annotations

import functools

import numpy as np

from .._jaxinit import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import decimate_device as dd


def residue_window_dots(win, P_local, *, M: int, nb_rs: int, qn_pad: int,
                        qn_local: int, q0, precise: bool = False,
                        defer_round: bool = False):
    """Residue-split block-Toeplitz contraction.

    Output block i needs window elements [i*M, i*M + qn_pad*M) of the
    padded window buffer; splitting blocks by residue r = i mod qn_pad
    makes each residue class's windows a CONTIGUOUS stride-(qn_pad*M)
    view — a pure reshape of a static slice, no gather and no operand
    blowup.  The contraction then runs as qn_pad dots of K = qn_pad*M
    over nb_rs/qn_pad rows instead of qn_pad dots of K = M over nb_rs
    rows: identical FLOPs and element reads, with a deeper K per dot
    (chosen on the earlier accelerator; not yet measured on the H100).

    ``win``: [S, (nb_rs + qn_pad) * M] padded window buffer; ``nb_rs``
    must be a multiple of qn_pad.  Each taps-rank contracts rows
    [q0*M, (q0+qn_local)*M) of the full [qn_pad*M, L2] phase matrix
    (``P_local``); the caller psums over the taps axis to complete the
    dot.  Returns [S, nb_rs, L2] (partial sums when qn_local < qn_pad).

    ``precise=True`` (f32 data only) accumulates each dot in float64 and
    rounds ONCE to the data dtype: an f32-accumulated HIGHEST dot leaves
    the round-trip diff RMS about a dB above the C reference's -142.29 dB,
    while f64 accumulation lands below it — the within-0.1-dB operating
    point for clients that need it.  Under taps sharding each rank's dot
    is only a PARTIAL K contraction, so rounding it here would add f32
    partials across ranks and defeat the accumulate-in-f64-round-once
    guarantee: such callers pass ``defer_round=True`` to receive the f64
    partials and round AFTER the psum (caught in review).
    """
    if isinstance(P_local, OzakiPlan):
        # int8 fixed-point mode (precise="int8"): single-shard only —
        # the engines gate mesh configurations out before reaching here
        assert qn_local == qn_pad
        return ozaki_window_dots(win, P_local, M=M, nb_rs=nb_rs,
                                 qn_pad=qn_pad)
    if precise == "int8":
        raise TypeError("precise='int8' needs an OzakiPlan operand; this "
                        "path received a raw matrix (unsupported "
                        "combination — engine gates should prevent this)")
    S = win.shape[0]
    nr = nb_rs // qn_pad
    KQ = qn_pad * M
    acc_dt = jnp.float64 if precise is True else win.dtype
    if qn_pad > 1 and qn_local == qn_pad:
        # ONE banded-wide dot instead of qn_pad anchor dots, for EVERY
        # full (single-shard) contraction: the qn_pad anchors' columns
        # fuse into one [*, qn_pad * L2] dot against a banded phase matrix
        # (anchor r's P rows offset by r*M, zeros elsewhere), trading
        # structural-zero flops for one operand pass and one wide output
        # instead of qn_pad narrow ones; the flat row-major order of the
        # [S, nr, qn_pad*L2] result IS the output sample order, so
        # delivery forms materialize with no physical relayout (chosen on
        # the earlier accelerator; not yet measured on the H100).  f32
        # values move at the dot's reassociation floor vs the per-anchor
        # form (~5e-7 abs at 0.5 scale — the documented f32 parity class);
        # f64 accumulation is unchanged (zeros add exactly 0 in sequential
        # K order).  The overlapped operand is a concat of two pure reshape
        # views.
        L2 = P_local.shape[1]
        KW = KQ + (qn_pad - 1) * M
        Va = jax.lax.slice(win, (0, 0), (S, nr * KQ)).reshape(S, nr, KQ)
        Vb = jax.lax.slice(win, (0, KQ), (S, KQ + nr * KQ)) \
            .reshape(S, nr, KQ)[:, :, :KW - KQ]
        V = jnp.concatenate([Va, Vb], axis=2)             # [S, nr, KW]
        Pb = jnp.zeros((KW, qn_pad * L2), dtype=P_local.dtype)
        for r in range(qn_pad):
            Pb = jax.lax.dynamic_update_slice(Pb, P_local,
                                              (r * M, r * L2))
        d = _acc_dot(V, Pb, acc_dt)
        if precise and not defer_round:
            d = d.astype(win.dtype)
        # [S, nr, qn_pad * L2]: col block r is anchor r = the stack-axis
        # layout of the per-anchor path; i = j*qn_pad + r, pure reshape
        return d.reshape(S, nb_rs, L2)
    outs = []
    for r in range(qn_pad):
        Vr = jax.lax.slice(win, (0, r * M), (S, r * M + nr * KQ)) \
            .reshape(S, nr, KQ)
        if qn_local != qn_pad:
            Vr = jax.lax.dynamic_slice_in_dim(Vr, q0 * M, qn_local * M,
                                              axis=2)
        d = _acc_dot(Vr, P_local, acc_dt)
        outs.append(d.astype(win.dtype) if precise and not defer_round
                    else d)
    # [S, nr, qn_pad, L2] -> [S, nb_rs, L2]; i = j*qn_pad + r, pure reshape
    return jnp.stack(outs, axis=2).reshape(S, nb_rs, -1)


def _acc_dot(V, P, acc_dt):
    """V [S, n, K] . P [K, N] at HIGHEST precision, accumulated in acc_dt.
    The operands are cast to acc_dt first: f32 -> f64 is exact, so an f64
    acc_dt is f64 accumulation of the exact f32 products — and the only
    form GPU GEMM libraries accept (there is no f32 x f32 -> f64 GEMM)."""
    return jax.lax.dot_general(
        V.astype(acc_dt), P.astype(acc_dt),
        dimension_numbers=(((2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)


class OzakiPlan:
    """Per-anchor operands for the int8 fixed-point (Ozaki-split)
    contraction — see ozaki_window_dots.  ``Pstack`` int8 [ndv*rows,
    NW*L2] stacks the static P digit planes so weight group w's column
    block sums digit pairs (i, j = w - i) exactly in the dot's int32
    accumulator; ``P32`` is the f32 matrix for the residual dot; ``wts``
    the group significances.  Registered as a pytree (leaves: Pstack,
    P32) so plans flow through the existing jitted chunk steps in the
    P-matrix operand slot."""

    SV = 19          # |input| < 2 headroom; vi = round(v * 2^SV) int32
    NDV = 3          # 21-bit V capture, 3 signed base-128 digits
    NDP = 5          # 35-bit P capture; the w=4 group is REQUIRED
    NW = 5           # groups w = 0..4 (w >= 5 are <= 2^-35-relative)

    def __init__(self, Pstack, P32, wts):
        self.Pstack, self.P32, self.wts = Pstack, P32, tuple(wts)

    @classmethod
    def scale_for(cls, max_abs: float) -> int:
        """Largest sp with round(p * 2^sp) inside the NDP-digit range for
        |p| <= max_abs (the +0.5 rint overshoot covered by the -1)."""
        lim = 1 << (7 * cls.NDP - 1)         # leading digit fits int8
        maxp = max(float(max_abs), 2.0 ** -40)
        sp = int(np.floor(np.log2((lim - 1) / maxp)))
        while np.rint(maxp * 2.0 ** sp) >= lim:
            sp -= 1
        return sp

    @classmethod
    def weights(cls, sp: int):
        return tuple(
            np.float32(2.0 ** (7 * (cls.NDV - 1) + 7 * (cls.NDP - 1)
                               - 7 * w - cls.SV - sp))
            for w in range(cls.NW))

    @classmethod
    def from_host(cls, P_np: np.ndarray, sp: int | None = None):
        rows, L2 = P_np.shape
        if sp is None:
            sp = cls.scale_for(np.abs(P_np).max())
        pi = np.rint(P_np.astype(np.float64) * 2.0 ** sp).astype(np.int64)
        assert np.abs(pi).max() < (1 << (7 * cls.NDP - 1))
        eds, rem = [], pi
        for _ in range(cls.NDP - 1):
            low = ((rem + 64) & 127) - 64
            eds.append(low)
            rem = (rem - low) >> 7
        eds.append(rem)
        eds = eds[::-1]                       # most significant first
        stack = np.zeros((cls.NDV * rows, cls.NW * L2), np.int8)
        for w in range(cls.NW):
            for i in range(cls.NDV):
                j = w - i
                if 0 <= j < cls.NDP:
                    stack[i * rows:(i + 1) * rows,
                          w * L2:(w + 1) * L2] = eds[j]
        return cls(jnp.asarray(stack), jnp.asarray(P_np.astype(np.float32)),
                   cls.weights(sp))

    @classmethod
    def from_device(cls, P_dev, sp: int):
        """Build the digit stack ON DEVICE from an f32 matrix already
        there (one-time per anchor/pattern; avoids re-uploading ~MB digit
        planes).  The f64 pointwise split is exact for |pi| < 2^53 and
        runs once, off the hot path."""
        Pstack = _ozaki_pstack_dev(P_dev, sp)
        return cls(Pstack, P_dev.astype(jnp.float32), cls.weights(sp))


def _ozaki_plan_flatten(p):
    return (p.Pstack, p.P32), p.wts


def _ozaki_plan_unflatten(wts, leaves):
    return OzakiPlan(leaves[0], leaves[1], wts)


jax.tree_util.register_pytree_node(OzakiPlan, _ozaki_plan_flatten,
                                   _ozaki_plan_unflatten)


@functools.partial(jax.jit, static_argnames=("sp",))
def _ozaki_pstack_dev(P_dev, sp: int):
    """Device-side P digit-plane builder (see OzakiPlan.from_device)."""
    rows, L2 = P_dev.shape
    pi = jnp.rint(P_dev.astype(jnp.float64) * 2.0 ** sp)
    eds, rem = [], pi
    for _ in range(OzakiPlan.NDP - 1):
        low = jnp.mod(rem + 64.0, 128.0) - 64.0
        eds.append(low)
        rem = (rem - low) * (1.0 / 128.0)
    eds.append(rem)
    eds = [e.astype(jnp.int32).astype(jnp.int8) for e in eds[::-1]]
    stack = jnp.zeros((OzakiPlan.NDV * rows, OzakiPlan.NW * L2), jnp.int8)
    for w in range(OzakiPlan.NW):
        for i in range(OzakiPlan.NDV):
            j = w - i
            if 0 <= j < OzakiPlan.NDP:
                stack = jax.lax.dynamic_update_slice(
                    stack, eds[j], (i * rows, w * L2))
    return stack


def _two_sum(a, b):
    """Knuth branch-free exact addition (adds/subs only — no FMA
    contraction hazard).  XLA:CPU can corrupt EFT chains
    graph-shape-dependently (CLAUDE.md), so CPU tests bound the int8 mode
    at f32-class tolerances; its round-trip bound is checked on the
    accelerator (chip_smoke.py)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _ds_round_once(parts):
    """Sum parts (descending significance) with a double-single
    accumulator and round once: the combine contributes ~2^-48-class
    error, so the mode's total error is the single output rounding plus
    the tiny residual-dot noise."""
    hi = parts[0]
    lo = jnp.zeros_like(hi)
    for p in parts[1:]:
        hi, e = _two_sum(hi, p)
        lo = lo + e
    return hi + lo


def ozaki_window_dots(win, plan: OzakiPlan, *, M: int, nb_rs: int,
                      qn_pad: int):
    """Residue-split block-Toeplitz contraction at the int8 fixed-point
    (Ozaki-split) operating point: ~the f64-accumulate single-rounding
    floor (round-trip lands BETTER than the C reference).  The f32
    accumulator noise of a HIGHEST dot is not reduced by splitting K, so
    the escape is EXACT accumulation: V rides as 3
    signed base-128 digits of round(v*2^19) through ONE int8 [.., 3K] @
    [3K, 5*L2] -> int32 dot whose col block w sums digit pairs i+j == w
    (each block <= 3*K*64^2 < 2^24: int32 accumulation and the
    int32->f32 convert are both exact); P rides as 5 static digits
    (the w=4 group is required — dropping it costs 6.1x); the exact f32
    remainder Vr = v - vi*2^-19 contracts against the f32 matrix in one
    DEFAULT-precision dot (bf16 or TF32 by backend: its noise enters at
    2^-20 relative times the dot's own ~2^-11); the
    weighted groups + residual combine through a two_sum chain and round
    once.  Single-shard form (qn_local == qn_pad).

    Returns [S, nb_rs, L2] f32 — same contract as residue_window_dots.
    """
    S = win.shape[0]
    nr = nb_rs // qn_pad
    KQ = qn_pad * M
    L2 = plan.P32.shape[1]
    rows = nb_rs + qn_pad
    assert win.shape[1] == rows * M, (win.shape, nb_rs, qn_pad, M)
    # Dense 3D digit planes ([S, rows, M] int8, row r = window columns
    # r*M..(r+1)*M) with 2D-flattened dots (the layout chosen on the
    # earlier accelerator; not yet measured on the H100) — anchor r's
    # operand view is rows r..r+nr*qn (the same pure reshape-of-slice
    # residue_window_dots uses, one row = one M-sample shift).
    w3 = win.reshape(S, rows, M)
    sv = OzakiPlan.SV
    lim = (1 << (7 * OzakiPlan.NDV - 1)) - 1
    vi = jnp.clip(jnp.rint(w3 * np.float32(2.0 ** sv)),
                  -lim, lim).astype(jnp.int32)
    digs, rem = [], vi
    for _ in range(OzakiPlan.NDV - 1):
        low = ((rem + 64) & 127) - 64
        digs.append(low)
        rem = (rem - low) >> 7
    digs.append(rem)
    digs = [d.astype(jnp.int8) for d in digs[::-1]]   # most significant 1st
    vr = w3 - vi.astype(jnp.float32) * np.float32(2.0 ** -sv)

    def view(p3, r):
        return jax.lax.slice(
            p3, (0, r, 0), (S, r + nr * qn_pad, M)).reshape(S * nr, KQ)

    outs = []
    for r in range(qn_pad):
        V8 = jnp.concatenate([view(d, r) for d in digs], axis=1)
        blk = jax.lax.dot_general(
            V8, plan.Pstack, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        t2 = jax.lax.dot_general(
            view(vr, r), plan.P32,
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT)
        parts = [blk[:, w * L2:(w + 1) * L2].astype(jnp.float32)
                 * plan.wts[w] for w in range(OzakiPlan.NW)]
        outs.append(_ds_round_once(parts + [t2]).reshape(S, nr, L2))
    # [S, nr, qn_pad, L2] -> [S, nb_rs, L2]; i = j*qn_pad + r, pure reshape
    return jnp.stack(outs, axis=2).reshape(S, nb_rs, -1)


def _window_and_hist(x, hist, start, xlen: int, hist_len: int):
    """Shared chunk prologue/epilogue: history concat -> padded window
    slice at ``start`` (the block-Toeplitz operand view) and the advanced
    history (last hist_len columns of history+input)."""
    S = x.shape[0]
    buf = jnp.concatenate([hist, x], axis=1)
    pad = jnp.zeros((S, xlen), dtype=x.dtype)
    win = jax.lax.dynamic_slice(
        jnp.concatenate([buf, pad], axis=1), (jnp.int32(0), start),
        (S, xlen))
    new_hist = jax.lax.dynamic_slice(
        buf, (0, buf.shape[1] - hist_len), (S, hist_len))
    return win, new_hist


def _mask_outputs(out, K, S: int, nb: int, L: int):
    """Flatten [S, nb, L] output blocks and zero entries beyond K."""
    out = jax.lax.slice(out, (0, 0, 0), (S, nb, L)).reshape(S, nb * L)
    valid = (jnp.arange(nb * L, dtype=jnp.int32) < K).astype(out.dtype)
    return out * valid[None, :]


def _resample_block(x, hist, P_local, start, K, *, M: int, L: int, nb: int,
                    qn_pad: int, qn_local: int, hist_len: int, q0,
                    taps_axis: str | None, precise: bool = False):
    """Block-Toeplitz resample chunk over a local range of shift blocks.

    Each taps-rank holds shift blocks [q0, q0 + qn_local) of the padded
    [qn_pad * M, L] phase matrix; the residue-split contraction
    (residue_window_dots) computes its partial dots and the psum over
    ``taps_axis`` completes them (the single-device caller passes
    taps_axis=None, q0=0, qn_local=qn_pad).
    Returns (out [S, nb*L] masked beyond K, new_hist)."""
    S = x.shape[0]
    nb_rs = -(-nb // qn_pad) * qn_pad
    win, new_hist = _window_and_hist(x, hist, start,
                                     (nb_rs + qn_pad) * M, hist_len)
    defer = precise and taps_axis is not None
    out = residue_window_dots(win, P_local, M=M, nb_rs=nb_rs,
                              qn_pad=qn_pad, qn_local=qn_local, q0=q0,
                              precise=precise, defer_round=defer)
    if taps_axis is not None:
        out = jax.lax.psum(out, taps_axis)
    if defer:
        out = out.astype(x.dtype)
    return _mask_outputs(out, K, S, nb, L), new_hist


def pipeline_chunk(x, hist, P_local, start, K, gens, fb, xh, yh,
                   A, V0, V1, *, M: int, L: int, nb: int, qn_pad: int,
                   qn_local: int, hist_len: int, scaler: float,
                   highclip: int, lowclip: int, dither_type,
                   shaper_a, shaper_b, output_bits: int, output_bytes: int,
                   streams_axis: str | None = None,
                   taps_axis: str | None = None,
                   post_bq=None, bq_state=None, post_bq_tables=None,
                   post_bq_tables32=None, bq_sp_mult: int = 1):
    """One full production chunk: resample -> [biquad post-filter cascade]
    -> dither -> shaped quantize -> pack.  Pure; state flows through.
    ``post_bq``: optional ((a1, b1), (a2, b2)) cascade coefficients (the
    CLI -p post filter, reference art.c:1052-1058) with ``bq_state`` =
    (xh1, yh1, xh2, yh2) each [4, S]; filtered via the masked block-Toeplitz
    IIR (ops/biquad_kernel.assoc_core_masked), per-stream and therefore
    shard-transparent over the streams axis.  Returns
    (packed u8 [nK, S*output_bytes], new_hist, new_gens, fb', xh', yh',
     clips i32, power[, bq_state'])."""
    q0 = jnp.int32(0)
    if taps_axis is not None:
        q0 = jax.lax.axis_index(taps_axis).astype(jnp.int32) * qn_local
    out, new_hist = _resample_block(
        x, hist, P_local, start, K, M=M, L=L, nb=nb, qn_pad=qn_pad,
        qn_local=qn_local, hist_len=hist_len, q0=q0, taps_axis=taps_axis)
    nK = nb * L

    new_bq_state = None
    if post_bq is not None:
        from ..ops.biquad_kernel import assoc_core_masked
        (a1, b1), (a2, b2) = post_bq
        t1, t2 = post_bq_tables if post_bq_tables is not None else (None,
                                                                    None)
        xh1, yh1, xh2, yh2 = bq_state
        # block-IIR lane pad = the GLOBAL stream count padded even (the
        # same constant on every mesh width, so sharded == single-device
        # stays bit-for-bit; see _iir_y)
        sp = -(-(x.shape[0] * bq_sp_mult) // 2) * 2
        t1_32, t2_32 = (post_bq_tables32 if post_bq_tables32 is not None
                        else (None, None))
        y, xh1, yh1 = assoc_core_masked(out.T, a1, b1, xh1, yh1, K,
                                        tables=t1, sp=sp, tables32=t1_32)
        y, xh2, yh2 = assoc_core_masked(y, a2, b2, xh2, yh2, K, tables=t2,
                                        sp=sp, tables32=t2_32)
        out = y.T
        new_bq_state = (xh1, yh1, xh2, yh2)

    dither = None
    new_gens = gens
    if dither_type is not None:
        d, seq = dd.tpdf_dither_dev(gens, A, V0, V1, dither_type, nK)
        new_gens = dd.advance_states(gens, seq, K)
        dither = d.T                                       # [nK, S]

    samples = out.T                                        # [nK, S]
    if shaper_a is not None:
        outv, clipf, fb, xh, yh = dd.quantize_shaped_dev(
            samples, dither, scaler, fb, shaper_a, shaper_b, xh, yh,
            K, highclip, lowclip)
    else:
        outv, clipf = dd.quantize_flat_dev(samples, dither, scaler, fb,
                                           highclip, lowclip)
        kmask = jnp.arange(nK, dtype=jnp.int32)[:, None] < K
        outv = jnp.where(kmask, outv, 0)
        clipf = clipf & kmask

    clips = jnp.sum(clipf).astype(jnp.int32)
    power = jnp.sum(out * out)
    if streams_axis is not None:
        clips = jax.lax.psum(clips, streams_axis)
        power = jax.lax.psum(power, streams_axis)
    packed = dd.pack_bytes_dev(outv, output_bits, output_bytes)
    if post_bq is not None:
        return (packed, new_hist, new_gens, fb, xh, yh, clips, power,
                new_bq_state)
    return packed, new_hist, new_gens, fb, xh, yh, clips, power


def make_sharded_step(mesh: Mesh, *, M: int, L: int, nb: int, qn: int,
                      hist_len: int, scaler: float, highclip: int,
                      lowclip: int, dither_type=-1, shaper_a=None,
                      shaper_b=None, output_bits: int = 16,
                      output_bytes: int = 2, post_bq=None,
                      bq_refine: bool = False):
    """Jitted multi-device production step over a (streams x taps) mesh.

    Global input shapes: x [S, n], hist [S, hist_len], Pmat [qn_pad*M, L]
    (qn padded up to a taps-axis multiple; pad rows are zero), start/K
    scalars, gens u32 [S], fb [S], xh/yh [4, S], A/V0/V1 u32 [5*nb*L].
    With ``post_bq`` (cascade coefficients, see pipeline_chunk) the step
    additionally takes bq_state = (xh1, yh1, xh2, yh2) each f64 [4, S] and
    returns the advanced tuple.
    """
    ntap = mesh.shape["taps"]
    qn_pad = -(-qn // ntap) * ntap
    qn_local = qn_pad // ntap
    post_bq_tables = post_bq_tables32 = None
    if post_bq is not None:
        # the cascade coefficients are host constants at step-build time:
        # precompute the block-IIR tables once here instead of re-running
        # the B-step table scan in-graph on every chunk (iir_tables)
        from ..ops.biquad_kernel import iir_tables
        post_bq_tables = (iir_tables(np.asarray(post_bq[0][1])),
                          iir_tables(np.asarray(post_bq[1][1])))
        if bq_refine:
            post_bq_tables32 = (
                iir_tables(np.asarray(post_bq[0][1]), dtype=np.float32),
                iir_tables(np.asarray(post_bq[1][1]), dtype=np.float32))
    kw = dict(M=M, L=L, nb=nb, qn_pad=qn_pad, qn_local=qn_local,
              hist_len=hist_len, scaler=scaler, highclip=highclip,
              lowclip=lowclip, dither_type=dither_type, shaper_a=shaper_a,
              shaper_b=shaper_b, output_bits=output_bits,
              output_bytes=output_bytes, streams_axis="streams",
              taps_axis="taps", post_bq=post_bq,
              post_bq_tables=post_bq_tables,
              post_bq_tables32=post_bq_tables32,
              bq_sp_mult=mesh.shape["streams"])

    base_in = (P("streams", None), P("streams", None), P("taps", None),
               P(), P(), P("streams"), P("streams"), P(None, "streams"),
               P(None, "streams"), P(), P(), P())
    base_out = (P(None, "streams"), P("streams", None), P("streams"),
                P("streams"), P(None, "streams"), P(None, "streams"),
                P(), P())
    if post_bq is None:
        def step(x, hist, Pmat, start, K, gens, fb, xh, yh, A, V0, V1):
            return pipeline_chunk(x, hist, Pmat, start, K, gens, fb, xh, yh,
                                  A, V0, V1, **kw)
        in_specs, out_specs = base_in, base_out
    else:
        def step(x, hist, Pmat, start, K, gens, fb, xh, yh, A, V0, V1,
                 bq_state):
            return pipeline_chunk(x, hist, Pmat, start, K, gens, fb, xh, yh,
                                  A, V0, V1, bq_state=bq_state, **kw)
        bq_spec = (P(None, "streams"),) * 4
        in_specs = base_in + (bq_spec,)
        out_specs = base_out + (bq_spec,)

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=in_specs, out_specs=out_specs,
        check_vma=False)
    return jax.jit(mapped)


def pad_phase_matrix(Pmat: np.ndarray, M: int, L: int, qn: int,
                     qn_pad: int, dtype) -> np.ndarray:
    """Zero-pad a [<=qn*M, L] phase matrix to [qn_pad*M, L]."""
    out = np.zeros((qn_pad * M, L), dtype=dtype)
    out[:Pmat.shape[0], :] = Pmat
    return out
