"""Multi-chip sharding for batched stream processing.

The reference's only parallel axis is a per-channel worker-thread pool
(reference workers.[ch]); the device scale-out story is a 2D device mesh
(on GPUs every device reaches every other at the same rate, so the mesh
follows the algorithm alone):

  - ``streams`` axis (data parallel): independent audio streams — channels,
    clips, or ASRC sessions — sharded across devices; stream processing is
    embarrassingly parallel, so no hot-path collectives.
  - ``taps`` axis (tensor parallel): the polyphase contraction dimension is
    sharded, each device computing a partial dot over its slice of the
    [qn*M, L] phase matrix, combined with a single psum.  This is how a
    filter too large for one device (or a latency-critical wide config)
    would be split.

Statistics reductions (clip counts, stream power — the ARTEST analog) psum
over both axes.  The same step function runs single-device when the mesh has
one entry; __graft_entry__.dryrun_multichip exercises it on a virtual CPU
mesh, and ``chip_smoke.py --four`` on four GPUs.
"""

from __future__ import annotations

from .._jaxinit import ensure_jax

jax = ensure_jax()
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def make_mesh(n_streams_shards: int, n_tap_shards: int = 1,
              devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    devices = devices[:n_streams_shards * n_tap_shards]
    return Mesh(devices.reshape(n_streams_shards, n_tap_shards),
                ("streams", "taps"))


def batched_pipeline_step(mesh: Mesh, *, M: int, L: int, nb: int, qn: int,
                          hist_len: int, scaler: float, highclip: int,
                          lowclip: int):
    """Build the jitted multi-device step for a batch of streams.

    Step inputs (global shapes):
      x      [S, chunk]          input chunk per stream (chunk = nbq*M - ...)
      hist   [S, hist_len]       per-stream history
      Pmat   [qn*M, L]           phase matrix (sharded over its rows)
      start  scalar int32        window origin (shared; equal-phase streams)

    Returns (out [S, nb*L], new_hist, clip_count scalar, power scalar).
    The quantization stage is the flat-dither-free decimator core
    (reference decimator.c:152-194) — enough to give the step a real
    elementwise + collective epilogue.

    NOTE: this is the minimal pedagogical sharded step (kept for its
    direct sharded == single-device test); the PRODUCTION sharded pipeline
    — full TPDF dither, ATH noise shaping, byte packing, the same engines
    the CLI ships — is parallel/pipeline.make_sharded_step, which
    __graft_entry__.dryrun_multichip exercises.  Do not benchmark this
    one.
    """
    nbq = nb + qn
    xlen = nbq * M

    def step(x, hist, Pmat, start):
        buf = jnp.concatenate([hist, x], axis=1)
        pad = jnp.zeros((x.shape[0], xlen), dtype=x.dtype)
        win = jax.lax.dynamic_slice(
            jnp.concatenate([buf, pad], axis=1), (jnp.int32(0), start),
            (x.shape[0], xlen))
        W2 = win.reshape(x.shape[0], nbq, M)
        X = jnp.stack([W2[:, q:q + nb] for q in range(qn)], axis=2)
        X = X.reshape(x.shape[0], nb, qn * M)
        # taps-parallel contraction: each device holds a row slice of Pmat
        # and the matching column slice of X; psum completes the dot
        ntap = mesh.shape["taps"]
        tap_idx = jax.lax.axis_index("taps")
        sl = (qn * M) // ntap
        zero = jnp.zeros((), tap_idx.dtype)
        Xs = jax.lax.dynamic_slice(X, (zero, zero, tap_idx * sl),
                                   (X.shape[0], nb, sl))
        partial_out = jnp.einsum("bns,sl->bnl", Xs, Pmat,
                                 preferred_element_type=x.dtype,
                                 precision=jax.lax.Precision.HIGHEST)
        out = jax.lax.psum(partial_out, "taps")
        out = out.reshape(x.shape[0], nb * L)

        # quantization epilogue + global stats
        code = out * out.dtype.type(scaler)
        q = jnp.floor(code.astype(jnp.float64) + 0.5).astype(jnp.int32)
        # `out` is already taps-replicated by the psum above, so the clip
        # count only reduces over streams
        clips_local = jnp.sum((q > highclip) | (q < lowclip))
        clips = jax.lax.psum(clips_local, "streams")
        power = jax.lax.psum(jnp.sum(out * out), "streams")
        new_hist = jax.lax.dynamic_slice(
            buf, (0, buf.shape[1] - hist_len), (x.shape[0], hist_len))
        return out, new_hist, clips, power

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("streams", None), P("streams", None),
                  P("taps", None), P()),
        out_specs=(P("streams", None), P("streams", None), P(), P()),
        check_vma=False)
    return jax.jit(mapped)


def example_batch(mesh: Mesh, *, M: int = 3, L: int = 2, nb: int = 4,
                  qn: int = 4, hist_len: int = 32, chunk: int = 64,
                  n_streams: int | None = None, dtype=jnp.float32):
    """Tiny example inputs aligned to the mesh, for dry runs and tests."""
    S = n_streams or mesh.shape["streams"] * 2
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (S, chunk), dtype=dtype) * 0.25
    hist = jnp.zeros((S, hist_len), dtype=dtype)
    Pmat = jax.random.normal(jax.random.PRNGKey(1), (qn * M, L),
                             dtype=dtype) * 0.1
    # window origin near the history/input seam so outputs see live data
    return x, hist, Pmat, jnp.int32(hist_len - 8)
