"""ART-JAX: an audio resampling framework for accelerators, in JAX.

A ground-up JAX/XLA redesign with the full capability surface of the
reference C library (dbry/audio-resampler): windowed-sinc resampling with a
phase bank (interpolated or exact fixed-ratio), float->integer decimation with
TPDF dither and ATH noise shaping, biquad IIR filtering, LPC endpoint
extrapolation, TDHS time stretching, WAV container I/O, and the ART/ARTEST
command-line tools.

Numeric width is a dtype parameter (float32 / float64) instead of the
reference's compile-time PATH_WIDTH typedef.
"""

from __future__ import annotations

# jax is imported lazily (see _jaxinit.ensure_jax): importing it costs
# ~2.5 s of startup that host-only paths (stretch, decimate, numpy
# resampling) never need.  x64 is enabled on first jax use.

from .core import flags  # noqa: E402
from .core.flags import *  # noqa: F401,F403,E402
from .engines.resampler import Resampler, ResampleResult  # noqa: E402
from .engines.decimator import Decimator  # noqa: E402
from .engines.biquad import Biquad, BiquadCoefficients  # noqa: E402
from .engines.extrapolator import (extrapolate_forward,  # noqa: E402
                                   extrapolate_reverse)
from .engines.stretch import Stretcher  # noqa: E402

__version__ = "0.1.0"
