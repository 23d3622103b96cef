"""Deferred JAX initialization.

Importing jax costs ~2.5 s of process startup; stretch/decimate/host-numpy
CLI runs never need it.  Every module that uses jax calls ``ensure_jax()``
(at its own import or first use), which imports jax on demand and applies
the package's global config exactly once:

- the 64-bit data path: float64 offsets/queries and the f64 engine path
  need x64, and all kernels are explicitly dtyped so the f32 fast paths are
  unaffected (the PATH_WIDTH analog, see package docstring);
- the persistent compilation cache: where ``JAX_COMPILATION_CACHE_DIR`` is
  set, jax reads it itself and nothing here overrides it; otherwise the
  cache lives at ``<repo>/.jax_cache`` (a fixed path, so later processes on
  the same checkout find what earlier ones compiled).
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

_configured = False


def cache_dir_to_set(environ=os.environ) -> str | None:
    """The compilation-cache directory ensure_jax sets, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set and jax's own reading of it
    governs."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(REPO_CACHE_DIR)


def ensure_jax():
    """Import jax (on first call) with the package's global config applied."""
    global _configured
    import jax
    if not _configured:
        jax.config.update("jax_enable_x64", True)
        cache = cache_dir_to_set()
        if cache is not None:
            jax.config.update("jax_compilation_cache_dir", cache)
        _configured = True
    return jax
