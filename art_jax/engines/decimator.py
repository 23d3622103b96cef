"""Float->integer decimation with TPDF dither and noise-shaped error feedback.

Engine-level port of the reference decimator (reference decimator.[ch]):
``Decimator`` carries per-channel state (error feedback, dither LCG states,
noise-shaper biquads — reference decimator.h:42-60) and quantizes float
streams to 4..24-bit little-endian packed bytes, returning the clipped-sample
count.  The stateless inverse helper ``float_integers`` mirrors
floatIntegersLE.

Noise-shaping curves (reference decimator.c:62-89): the Gesemann/Lame ATH
4th-order coefficient sets for the five standard rates, binomial
(1-z^-1)^n generic shapers, and the direct-form N(z) -> decoupled H(z)
refactor a[k] = b[k+1] - a[k+1] (reference decimator.c:389-409).

Compute paths: the dither sequence is always precomputed in closed form
(bit-exact, vectorized); shaped quantization runs as a channels-vectorized
scan (host numpy for parity / lax.scan on device); unshaped quantization is
one fused elementwise pass.
"""

from __future__ import annotations

import numpy as np

from ..core.flags import (DITHER_ENABLED, DITHER_FLAT, DITHER_HIGHPASS,
                          DITHER_LOWPASS, SHAPING_1ST_ORDER,
                          SHAPING_2ND_ORDER, SHAPING_3RD_ORDER,
                          SHAPING_ATH_CURVE, SHAPING_ENABLED)
from ..ops import decimate_kernel as dk
from .biquad import Biquad, BiquadCoefficients

# ATH noise-shaping N(z) coefficient sets (reference decimator.c:70-78):
# rate -> (a1..a4, b1..b4) with a0 == 1.
_ATH_CURVES = {
    32000: (-0.780459, +0.569358, -0.348221, +0.466316,
            +0.950797, +0.282052, +0.004337, +1.76209e-5),
    44100: (-1.1474, 0.5383, -0.3530, 0.3475,
            1.0587, 0.0676, -0.6054, -0.2738),
    48000: (-1.3344, 0.7455, -0.4602, 0.4363,
            0.9030, 0.0116, -0.5853, -0.2571),
    88200: (-2.150679, +2.1402057, -1.042712, +0.206838,
            +0.67433, +1.017047, +0.4028633, +0.098656),
    96000: (-2.16994, +2.01986, -0.894857, +0.1557738,
            +0.517789, +1.1062189, +0.4825786, +0.244994),
}
_FIRST_ORDER = (-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_SECOND_ORDER = (-2.0, +1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_THIRD_ORDER = (-3.0, +3.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def _shaper_coeffs(a1, a2, a3, a4, b1, b2, b3, b4) -> BiquadCoefficients:
    """N(z) -> decoupled H(z) (reference decimator.c:389-409)."""
    return BiquadCoefficients(a0=b1 - a1, a1=b2 - a2, a2=b3 - a3, a3=b4 - a4,
                              b1=b1, b2=b2, b3=b3, b4=b4)


class Decimator:
    """Streaming quantizer; one instance per stream."""

    def __init__(self, num_channels: int, output_bits: int, output_bytes: int,
                 output_gain: float, sample_rate: int, flags: int, *,
                 dtype=np.float32, backend: str = "numpy"):
        self.num_channels = num_channels
        self.output_bits = output_bits
        self.output_bytes = output_bytes
        self.output_gain = output_gain
        self.sample_rate = sample_rate
        self.flags = flags
        self.dtype = np.dtype(dtype)
        self.backend = backend

        self.feedback = np.zeros(num_channels, dtype=self.dtype)
        self.tpdf_generators = None
        self.dither_type = 0
        if flags & DITHER_ENABLED:
            self.tpdf_generators = dk.seed_generators(num_channels)
            if flags & DITHER_HIGHPASS:
                self.dither_type = -1
            elif flags & DITHER_LOWPASS:
                self.dither_type = 1
            elif flags & DITHER_FLAT:
                self.dither_type = 0

        self.noise_shaper = None
        if flags & SHAPING_ENABLED:
            if flags & SHAPING_ATH_CURVE:
                curve = _ATH_CURVES.get(sample_rate, _FIRST_ORDER)
            elif flags & SHAPING_1ST_ORDER:
                curve = _FIRST_ORDER
            elif flags & SHAPING_2ND_ORDER:
                curve = _SECOND_ORDER
            else:
                curve = _THIRD_ORDER
            self.noise_shaper = Biquad.init(_shaper_coeffs(*curve), 1.0,
                                            channels=num_channels,
                                            dtype=self.dtype)

        # quantization constants (reference decimator.c:152-157)
        self.scaler = self.dtype.type((1 << output_bits) / 2.0 * output_gain)
        self.highclip = (1 << (output_bits - 1)) - 1
        self.lowclip = ~self.highclip

    # ----------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return dict(feedback=self.feedback.copy(),
                    tpdf=None if self.tpdf_generators is None
                    else self.tpdf_generators.copy(),
                    shaper=None if self.noise_shaper is None
                    else self.noise_shaper.copy())

    def load_state(self, state: dict) -> None:
        self.feedback = state["feedback"].copy()
        if state["tpdf"] is not None:
            self.tpdf_generators = state["tpdf"].copy()
        if state["shaper"] is not None:
            self.noise_shaper = state["shaper"].copy()

    # --------------------------------------------------------------- process
    def process(self, inputs: np.ndarray) -> tuple[np.ndarray, int]:
        """Planar quantize: inputs [channels, n] -> (bytes [n, ch*bytes],
        clipped count).  Mirrors decimateProcessLE semantics."""
        return self._run(np.ascontiguousarray(np.asarray(inputs).T))

    def process_interleaved(self, inputs: np.ndarray) -> tuple[np.ndarray, int]:
        """Interleaved quantize: inputs [n, channels]
        (decimateProcessInterleavedLE)."""
        return self._run(np.asarray(inputs))

    def _run(self, frames: np.ndarray) -> tuple[np.ndarray, int]:
        n = frames.shape[0]
        frames = frames.astype(self.dtype, copy=False)

        if self.backend == "native" and n:
            from .. import native
            if native.available():
                gens = self.tpdf_generators \
                    if self.flags & DITHER_ENABLED else None
                fused = native.quantize_pack(
                    np.ascontiguousarray(frames), self.scaler, self.feedback,
                    gens, self.dither_type, self.noise_shaper,
                    self.highclip, self.lowclip, self.output_bits,
                    self.output_bytes)
                if fused is not None:
                    return fused
                outv, clipped = native.quantize(
                    np.ascontiguousarray(frames), self.scaler, self.feedback,
                    gens, self.dither_type, self.noise_shaper,
                    self.highclip, self.lowclip)
                packed = native.pack_le(outv, self.output_bits,
                                        self.output_bytes)
                return packed.reshape(n, -1), clipped

        dither = None
        if self.flags & DITHER_ENABLED and n:
            dither, self.tpdf_generators = dk.tpdf_dither_block(
                self.tpdf_generators, self.dither_type, n)
        if self.noise_shaper is not None and n:
            if self.backend == "jax":
                outv, clipped, self.feedback = dk.quantize_shaped_jax(
                    frames, dither, self.scaler, self.feedback,
                    self.noise_shaper, self.highclip, self.lowclip)
            else:
                outv, clipped, self.feedback = dk.quantize_shaped_numpy(
                    frames, dither, self.scaler, self.feedback,
                    self.noise_shaper, self.highclip, self.lowclip)
        else:
            outv, clipped, self.feedback = dk.quantize_flat(
                frames, dither, self.scaler, self.feedback,
                self.highclip, self.lowclip)
        packed = dk.pack_bytes(outv, self.output_bits, self.output_bytes)
        return packed, clipped


def float_integers(data, gain: float, input_bits: int, input_bytes: int,
                   dtype=np.float32) -> np.ndarray:
    """Stateless int->float conversion (floatIntegersLE,
    reference decimator.c:416-450)."""
    return dk.unpack_bytes(np.asarray(data, dtype=np.uint8), gain,
                           input_bits, input_bytes, dtype)


class DeviceDecimator:
    """Device-resident decimator: dither + (shaped) quantization + LE byte
    pack fused into one jitted step per chunk; only the packed bytes and the
    clip count cross device->host (at 16-bit that is half the d2h traffic of
    fetching float32 samples).

    Bit-exact vs the host ``Decimator`` for identical input samples (each
    stage proven in tests/test_pipeline.py); ragged chunks advance the LCG /
    shaper state by exactly K frames.  Mirrors decimateProcessInterleavedLE
    (reference decimator.c:205-291); per-channel state layout per reference
    decimator.h:42-60."""

    def __init__(self, num_channels: int, output_bits: int,
                 output_bytes: int, output_gain: float, sample_rate: int,
                 flags: int, *, dtype=np.float32):
        from .._jaxinit import ensure_jax
        self._jax = ensure_jax()
        import jax.numpy as jnp
        host = Decimator(num_channels, output_bits, output_bytes,
                         output_gain, sample_rate, flags, dtype=dtype)
        self.num_channels = num_channels
        self.output_bits = output_bits
        self.output_bytes = output_bytes
        self.dtype = np.dtype(dtype)
        self.scaler = host.scaler
        self.highclip, self.lowclip = host.highclip, host.lowclip
        self.dithered = bool(flags & DITHER_ENABLED)
        self.dither_type = host.dither_type
        self.shaped = host.noise_shaper is not None
        self.gens = jnp.asarray(host.tpdf_generators) if self.dithered \
            else jnp.zeros(num_channels, jnp.uint32)
        self.fb = jnp.asarray(host.feedback)
        if self.shaped:
            sh = host.noise_shaper
            self._a = jnp.asarray(np.asarray(sh.a, self.dtype))
            self._b = jnp.asarray(np.asarray(sh.b, self.dtype))
            self.xh = jnp.asarray(np.asarray(sh.xh, self.dtype))
            self.yh = jnp.asarray(np.asarray(sh.yh, self.dtype))
        else:
            self._a = self._b = jnp.zeros(5, self.dtype)
            self.xh = self.yh = jnp.zeros((4, num_channels), self.dtype)
        self._tables = {}

    def _tables_for(self, n: int):
        import jax.numpy as jnp
        if n not in self._tables:
            from ..ops import decimate_device as dd
            self._tables[n] = tuple(jnp.asarray(t)
                                    for t in dd.dither_tables(n))
        return self._tables[n]

    def state_dict(self) -> dict:
        """Streaming state (reference decimator.h:42-60 analog): LCG
        states, error feedback, shaper histories — host arrays, so a
        checkpoint is portable across backends."""
        return {
            "gens": np.asarray(self.gens),
            "feedback": np.asarray(self.fb),
            "xh": np.asarray(self.xh),
            "yh": np.asarray(self.yh),
        }

    def load_state(self, state: dict) -> None:
        import jax.numpy as jnp
        self.gens = jnp.asarray(np.asarray(state["gens"], np.uint32))
        self.fb = jnp.asarray(np.asarray(state["feedback"],
                                         self.dtype.type))
        self.xh = jnp.asarray(np.asarray(state["xh"], self.dtype.type))
        self.yh = jnp.asarray(np.asarray(state["yh"], self.dtype.type))

    def process_chunk(self, samples, K: int):
        """samples: [n, channels] array (device or host; n is a static jit
        bucket); the first K frames are quantized and the state advances by
        exactly K.  Returns (packed uint8 [K, channels*output_bytes] numpy,
        clipped count)."""
        dev = self.process_chunk_async(samples, K)
        if dev is None:
            return np.zeros((0, self.num_channels * self.output_bytes),
                            np.uint8), 0
        packed, clipped = dev
        return np.asarray(packed)[:K], int(clipped)

    def process_chunk_async(self, samples, K: int):
        """process_chunk without the device->host fetch: returns
        (packed_dev uint8 [n, channels*output_bytes], clipped_dev scalar)
        still on device (None for an empty chunk).  The engine state has
        already advanced, so the caller may dispatch the next chunk and
        fetch this one's bytes concurrently, overlapping the d2h copy
        with the next chunk's compute."""
        import jax.numpy as jnp
        n = int(samples.shape[0])
        if n == 0 or K == 0:
            return None
        A, V0, V1 = self._tables_for(n)
        packed, clipped, self.gens, self.fb, self.xh, self.yh = \
            _device_decimate_step(
                jnp.asarray(samples, self.dtype.type), jnp.int32(K),
                self.gens, self.fb, self._a, self._b, self.xh, self.yh,
                A, V0, V1, self.dtype.type(self.scaler), n,
                self.dither_type if self.dithered else None,
                self.output_bits, self.output_bytes, self.highclip,
                self.lowclip, self.shaped)
        return packed, clipped


_DEVICE_STEP_CACHE: list = []


def _device_decimate_step(y, K, gens, fb, a, b, xh, yh, A, V0, V1, scaler,
                          n, dither_type, bits, nbytes, highclip, lowclip,
                          shaped):
    """Lazily-built jitted fused step (jax imports stay off the host-only
    import path, like ops/decimate_kernel)."""
    if not _DEVICE_STEP_CACHE:
        import functools

        from .._jaxinit import ensure_jax
        jax = ensure_jax()
        import jax.numpy as jnp

        from ..ops import decimate_device as dd

        @functools.partial(jax.jit, static_argnames=(
            "n", "dither_type", "bits", "nbytes", "highclip", "lowclip",
            "shaped"))
        def fn(y, K, gens, fb, a, b, xh, yh, A, V0, V1, scaler, n,
               dither_type, bits, nbytes, highclip, lowclip, shaped):
            if dither_type is not None:
                dither, seq = dd.tpdf_dither_dev(gens, A, V0, V1,
                                                 dither_type, n)
                dither = dither.T                           # [n, S]
                new_gens = dd.advance_states(gens, seq, K)
            else:
                dither, new_gens = None, gens
            if shaped:
                outv, clipf, fb, xh, yh = dd.quantize_shaped_dev(
                    y, dither, scaler, fb, a, b, xh, yh, K, highclip,
                    lowclip)
            else:
                outv, clipf = dd.quantize_flat_dev(y, dither, scaler, fb,
                                                   highclip, lowclip)
                clipf = clipf & (jnp.arange(n, dtype=jnp.int32)
                                 < K)[:, None]
            packed = dd.pack_bytes_dev(outv, bits, nbytes)
            clipped = jnp.sum(clipf.astype(jnp.int32))
            return packed, clipped, new_gens, fb, xh, yh

        _DEVICE_STEP_CACHE.append(fn)
    return _DEVICE_STEP_CACHE[0](
        y, K, gens, fb, a, b, xh, yh, A, V0, V1, scaler, n, dither_type,
        bits, nbytes, highclip, lowclip, shaped)
