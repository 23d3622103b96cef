"""Randomized consistency fuzz over the batched-ASRC surfaces:
per-stream flush/teardown, f32+f64, mixed geometries and ratio regimes --
every call checked against independent per-stream host engines (counts
exact, samples at the documented floor, positions bit-equal).

Usage: fuzz_asrc_roundtrip.py [seed] [rounds]
"""
import os
import sys

import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
from art_jax.parallel.asrc import BatchedASRC
from art_jax.engines.resampler import Resampler
from art_jax.core.flags import SUBSAMPLE_INTERPOLATE, BLACKMAN_HARRIS

rng = np.random.default_rng(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 25

for it in range(rounds):
    if it and it % 10 == 0:
        # every round jits fresh geometries; past ~35 rounds the
        # accumulated XLA:CPU executables crash LLVM's JIT allocator
        # ("Cannot allocate memory") — drop the caches periodically
        jax.clear_caches()
    S = 8
    taps = int(rng.choice([16, 48, 104, 380]))
    filters = int(rng.choice([32, 64, 380, 129]))
    dtype = np.float64 if rng.random() < 0.25 else np.float32
    b = BatchedASRC(S, taps, filters, dtype=dtype)
    b.advance_position(float(taps // 2))
    singles = []
    for _ in range(S):
        r = Resampler(1, taps, filters, 0.0,
                      SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS,
                      backend="numpy", dtype=dtype)
        r.advance_position(float(taps // 2))
        singles.append(r)
    ended = set()
    ncalls = int(rng.integers(3, 7))
    for t in range(ncalls):
        n = int(rng.integers(64, 700))
        x = (rng.standard_normal((S, n)) * 0.7).astype(dtype)
        mode = rng.random()
        if mode < 0.5:
            ratios = 1.0 + rng.uniform(-0.012, 0.012, S)
        elif mode < 0.8:
            ratios = rng.uniform(0.5, 2.0, S)
        else:
            ratios = rng.uniform(0.26, 3.5, S)
        out, Ks = b.process(jnp.asarray(x), ratios)
        out = np.asarray(out)
        for s in range(S):
            if s in ended:
                assert Ks[s] == 0, (it, t, s)
                continue
            ho, res = singles[s].process(x[s:s+1], n, 4 * n + 4 * taps + 64,
                                         float(ratios[s]))
            assert res.output_generated == Ks[s], \
                (it, t, s, taps, filters, dtype, ratios[s])
            if Ks[s]:
                md = np.abs(ho[0] - out[s, :Ks[s]]).max()
                assert md < 3e-6, (it, t, s, md, taps, filters, dtype)
            assert b.get_position()[s] == singles[s].get_position(), \
                (it, t, s)
        # randomly end a stream
        if rng.random() < 0.3 and len(ended) < S - 2:
            victim = int(rng.integers(0, S))
            if victim not in ended:
                fr = 1.0 + rng.uniform(-0.01, 0.01, S)
                m = np.zeros(S, bool); m[victim] = True
                fo, fK = b.flush(fr, m)
                ho, res = singles[victim].process(None, -1, 4*taps + 2048,
                                                  float(fr[victim]))
                assert res.output_generated == fK[victim], (it, t, victim)
                if fK[victim]:
                    md = np.abs(ho[0] - np.asarray(fo)[victim, :fK[victim]]).max()
                    assert md < 3e-6, (it, t, victim, md)
                ended.add(victim)
    print(f"round {it}: taps={taps} F={filters} {np.dtype(dtype).name} ok")
print("FUZZ OK")
