"""Polyphase matmul path: fixed-ratio resampling as a strided convolution.

For a reduced fixed-ratio resampler (num_filters == L, ratio == L/M after gcd
reduction — reference resampler.c:310-356) with a snap-aligned offset, the
phase sequence is *exactly* periodic: output l of every L-output block uses
phase (j0 + l*M) mod L and a window shifted by carry(l) = (j0 + l*M) // L
input samples, and each block consumes exactly M inputs.  Folding the phase
bank into a dense [L, M + T] block matrix turns the whole steady state into

    out[ch, j, l] = sum_s P[l, s] * x[ch, j*M + s]

i.e. a stride-M convolution with L output features — a pure matmul chain
on the device, instead of the reference's per-output-sample dot products
(reference resampler.c:1029-1044).  At preset -3 44.1k->48k this is
[160, 527] against windows of 527 samples.

The reference's passthrough shortcut (allpass + integer phase returns the raw
sample, reference resampler.c:1141-1142) becomes a one-hot row, which a
matmul reproduces bit-exactly.

Positions are anchored rationally ((j0 + k*M) mod L) rather than through the
reference's fl(k/ratio) float recurrence; the two can disagree only when the
float recurrence lands within ~1e-9 of a grid point, where the reference's
rotated extra filter makes the results equivalent up to its zeroed outlier
tap.  Counts always come from the float-faithful accounting.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# jax is imported lazily (device uploads / jitted conv only happen on the
# jax backend); see _jaxinit.ensure_jax


class PolyphaseMatrix:
    """Dense block matrix for one (bank, L, M, j0) anchor."""

    def __init__(self, bank: np.ndarray, L: int, M: int, j0: int,
                 include_lowpass: bool):
        T = bank.shape[1]
        half = T // 2
        S = M + T
        P = np.zeros((L, S), dtype=bank.dtype)
        carry = ((j0 + np.arange(L) * M) // L).astype(np.int64)
        phase = ((j0 + np.arange(L) * M) % L).astype(np.int64)
        for l in range(L):
            if not include_lowpass and phase[l] == 0:
                # passthrough: one-hot at the sample under the filter center
                P[l, carry[l] + half - 1] = 1.0
            else:
                P[l, carry[l]:carry[l] + T] = bank[phase[l]]
        self.P = P
        self.L, self.M, self.S, self.T = L, M, S, T
        self.carry = carry
        self._dev = None

    def device(self):
        if self._dev is None:
            from .._jaxinit import ensure_jax
            ensure_jax()
            import jax.numpy as jnp
            self._dev = jnp.asarray(self.P)
        return self._dev


@functools.lru_cache(maxsize=None)
def _jit_conv(L: int, M: int, S: int, dtype_name: str):
    from .._jaxinit import ensure_jax
    jax = ensure_jax()
    import jax.numpy as jnp  # noqa: F401
    @jax.jit
    def run(x, P):
        # x: [ch, xlen] with xlen == (nb-1)*M + S;  P: [L, S]
        # precision pinned to HIGHEST: a default-precision f32 dot may run
        # in bf16 or TF32, which silently costs tens of dB of output SNR
        # (same pin as streams.py and every other device contraction in
        # the package)
        out = jax.lax.conv_general_dilated(
            x[:, None, :], P[:, None, :], window_strides=(M,),
            padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=x.dtype,
            precision=jax.lax.Precision.HIGHEST)
        # out: [ch, L, nb] -> [ch, nb*L] interleaving blocks
        ch, _, nb = out.shape
        return out.transpose(0, 2, 1).reshape(ch, nb * L)
    return run


class PolyphaseKernel:
    """Caches per-anchor matrices and jitted convs for an engine instance."""

    def __init__(self, bank: np.ndarray, num_filters: int,
                 include_lowpass: bool, ratio: float):
        self.bank = bank
        self.L = num_filters
        self.include_lowpass = include_lowpass
        # recover M from the ratio (ratio == L/M exactly by construction)
        self.M = int(round(self.L / ratio))
        self._mats: dict[int, PolyphaseMatrix] = {}

    def matrix(self, j0: int) -> PolyphaseMatrix:
        m = self._mats.get(j0)
        if m is None:
            m = PolyphaseMatrix(self.bank, self.L, self.M, j0,
                                self.include_lowpass)
            self._mats[j0] = m
        return m

    def eligible(self, output_offset: float, n_positions: int) -> bool:
        """Usable when the offset fraction sits on the 1/L grid (always true
        after a snap-offset call or at init) and the call is big enough to
        amortize."""
        if self.L < 2 or n_positions < 4 * self.L:
            return False
        frac = output_offset - math.floor(output_offset)
        j0 = round(frac * self.L)
        return abs(frac * self.L - j0) < 1e-9

    def apply(self, Lbuf: np.ndarray, output_offset: float, K: int,
              dtype) -> np.ndarray:
        """Compute K outputs starting at position output_offset over Lbuf."""
        T = self.bank.shape[1]
        half = T // 2
        ipos0 = math.floor(output_offset)
        j0 = round((output_offset - ipos0) * self.L) % self.L
        if round((output_offset - ipos0) * self.L) == self.L:
            ipos0 += 1
        mat = self.matrix(j0)
        L, M, S = mat.L, mat.M, mat.S
        nb = -(-K // L)
        start = ipos0 - half + 1
        xlen = (nb - 1) * M + S
        ch = Lbuf.shape[0]
        x = np.zeros((ch, xlen), dtype=dtype)
        # defensive (reference defect #5 class, PARITY.md): a window start
        # before the buffer reads leading silence, never a Python
        # negative-index wrapped slice
        src0 = max(0, start)
        dst0 = src0 - start
        avail = min(xlen - dst0, Lbuf.shape[1] - src0)
        if avail > 0:
            x[:, dst0:dst0 + avail] = Lbuf[:, src0:src0 + avail]
        import jax.numpy as jnp
        out = _jit_conv(L, M, S, np.dtype(dtype).name)(
            jnp.asarray(x), mat.device())
        return np.asarray(out)[:, :K]
