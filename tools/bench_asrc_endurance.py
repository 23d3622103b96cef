"""Endurance run for the drifting-ratio batched ASRC (BASELINE config 5).

The judged workload: >= 400 process() calls on 256 concurrent streams whose
per-call, per-stream ratios drift continuously (so the call's MAX ratio also
drifts -- the pattern that exposed the round-2 compile-churn bug).

Verification layers:
  - untimed prologue: two sentinel streams mirrored through independent
    host Resampler engines for several calls -- emission counts must match
    exactly, samples to the f32 floor (the host mirror is far slower than
    the device engine, so it cannot sit inside the timed loop);
  - every timed call: sentinel emission counts re-derived independently
    from the brute-force position grid (pos_k = fl(offset + fl(k/ratio)),
    the reference's emission rule, resampler.c:526) and compared exactly;
    per-stream offsets advanced through an independent float64 recurrence;
  - after the run: every stream's phase position must equal that
    independent recurrence bit-for-bit.

Usage: bench_asrc_endurance.py [calls] [chunk_frames] [--save=PATH]
Prints one JSON line (sustained M out/s + verification summary).
"""
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
from art_jax.core.flags import BLACKMAN_HARRIS, SUBSAMPLE_INTERPOLATE
from art_jax.engines.resampler import Resampler
from art_jax.parallel.asrc import BatchedASRC

args = [a for a in sys.argv[1:] if not a.startswith("--")]
calls = int(args[0]) if len(args) > 0 else 400
n = int(args[1]) if len(args) > 1 else 32768
save = next((a.split("=", 1)[1] for a in sys.argv if a.startswith("--save=")),
            None)
# --drift=PCT scales the per-stream ratio spread (default 1%: the
# BASELINE config-5 pattern; 10 exercises a wide drift, where the call's
# capacity bucket moves most)
drift = float(next((a.split("=", 1)[1] for a in sys.argv
                    if a.startswith("--drift=")), "1")) / 100.0

S, taps, filters = 256, 380, 380
half = taps // 2
eng = BatchedASRC(S, taps, filters)
eng.advance_position(float(half))

rng = np.random.default_rng(0)
x_np = (rng.standard_normal((S, n)) * 0.5).astype(np.float32)
x = jnp.asarray(x_np)


def ratios_at(t: int) -> np.ndarray:
    # per-call drift: both the per-stream spread and the call MAXIMUM move
    return 1.0 + drift * np.sin(0.1 * np.arange(S) + 0.031 * t) \
        + drift / 5.0 * np.sin(0.017 * t)


SENTINELS = (0, 137)

# ---- untimed prologue: host-engine mirror proves samples + counts
hosts = {}
for s in SENTINELS:
    r = Resampler(1, taps, filters, 0.0,
                  SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS, backend="numpy")
    r.advance_position(float(half))
    hosts[s] = r
sample_md = 0.0
for t in range(3):
    ratios = ratios_at(t)
    out, Ks = eng.process(x, ratios)
    ov = np.asarray(out)
    for s in SENTINELS:
        ho, res = hosts[s].process(x_np[s:s + 1], n, int(Ks[s]) + 8,
                                   float(ratios[s]))
        assert res.output_generated == int(Ks[s])
        sample_md = max(sample_md, float(
            np.abs(ho[0, :Ks[s]] - ov[s, :Ks[s]]).max()))
        assert abs(eng.get_position()[s] - hosts[s].get_position()) == 0.0
assert sample_md < 2e-6

# ---- independent float64 state recurrence (the reference's context
# arithmetic, resampler.c:494-535): offsets/input_index tracked outside
# the engine, counts re-derived from the brute-force position grid
ref_off = eng.offsets.copy()
ref_idx = eng.input_index
num_samples = eng.num_samples
slide = num_samples - taps

count_errors = 0
total = 0
t0 = time.perf_counter()
for t in range(3, calls + 3):
    ratios = ratios_at(t)
    out, Ks = eng.process(x, ratios)
    total += int(Ks.sum())
    # independent exact count check for the sentinels (position grid)
    bound = float(ref_idx + n - half)
    for s in SENTINELS:
        kmax = int(Ks[s]) + 4
        ks = np.arange(kmax, dtype=np.float64)
        K_ref = int(((ref_off[s] + ks / ratios[s]) < bound).sum())
        if K_ref != int(Ks[s]):
            count_errors += 1
    # advance the reference recurrence (exact-integer slides)
    import math as _m
    n_slides = max(0, _m.ceil((ref_idx + n - num_samples) / slide))
    ref_idx = ref_idx + n - n_slides * slide
    ref_off = (ref_off - n_slides * slide) + Ks / ratios
_ = float(jnp.sum(out))
dt = time.perf_counter() - t0

pos_err = float(np.abs(
    eng.get_position() - (ref_off + half - ref_idx)).max())
rate = total / dt / 1e6
result = {
    "metric": "256-stream drifting ASRC endurance (sustained)",
    "value": round(rate, 1), "unit": "M out/s",
    "drift_pct": drift * 100.0,
    "calls": calls, "chunk": n, "outputs": total,
    "count_errors": count_errors, "position_err": pos_err,
    "sentinel_sample_maxdiff": sample_md,
    "vs_baseline": round(rate / 4.55, 1),
}
print(json.dumps(result))
assert count_errors == 0 and pos_err == 0.0
if save:
    with open(save, "w") as f:
        json.dump(result, f)
        f.write("\n")
