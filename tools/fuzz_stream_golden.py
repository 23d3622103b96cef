"""Extended golden-parity fuzz: drive the test-suite's randomized stream
config generator (tests/test_fuzz_golden.test_fuzz_stream_parity) over an
arbitrary fresh seed range, f32 or f64 data path.

This is the idle-time bug hunter that found the slide-tie count bug
(seed 5113, fixed by accounting._ring_floor): the in-suite fuzz pins a
fixed seed set for CI determinism; this tool explores beyond it.  Run it
on any host (needs no accelerator).

Usage: fuzz_stream_golden.py LO HI [--f64] [--query]
  seeds [LO, HI) are offset by +1000 like the suite (suite covers
  0..31 + a few hand-picked finds; start at ~5000 for fresh ground).
  --query fuzzes the DRY-RUN queries (GetRequiredSamples /
  GetExpectedOutput incl. flush simulation) against the live C functions
  at streamed states instead of the process stream itself.
Requires the golden harness (tools/build_golden.sh -> /tmp/art_golden).
"""
import pathlib
import subprocess
import os
import sys
import traceback

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

from art_jax.core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                                INCLUDE_LOWPASS, NO_FILTER_REDUCTION,
                                SUBSAMPLE_INTERPOLATE)
from helpers import compare_stream
from test_fuzz_golden import RATE_PAIRS

F64 = "--f64" in sys.argv
QUERY = "--query" in sys.argv
args = [a for a in sys.argv[1:] if not a.startswith("--")]
lo, hi = int(args[0]), int(args[1])


def compare_queries(golden, *, chans, taps, filters, flags, mode, src, dst,
                    lowpass, ratio, block, nblocks, advance, dtype, nq=8):
    """Drive the golden `query` subcommand and mirror it with the engine's
    simulate_* dry-run queries at every streamed state (exact parity)."""
    from art_jax.engines.resampler import Resampler
    from art_jax.utils.testsig import NoiseLCG

    raw = subprocess.run(
        [str(golden), "query", str(chans), str(taps), str(filters),
         format(flags, "x"), str(mode), str(src), str(dst), str(lowpass),
         repr(ratio), str(block), str(nblocks), repr(advance), str(nq)],
        capture_output=True, check=True).stdout
    vals = np.frombuffer(raw, dtype=np.uint32)
    assert len(vals) == nblocks * (2 + 2 * nq + 1)

    if mode:
        r = Resampler.fixed_ratio(chans, taps, filters, src, dst,
                                  int(lowpass), flags, dtype=dtype)
    else:
        r = Resampler(chans, taps, filters, lowpass, flags, dtype=dtype)
    if advance:
        r.advance_position(advance)
    lcg = NoiseLCG()
    outcap = int((block + taps) * max(ratio, 1.0)
                 * max(dst / src if src else 1.0, 1.0)) + taps + 64
    off = 0
    for b in range(nblocks):
        inp = lcg.fill(block * chans, dtype).reshape(block, chans)
        out, res = r.process_interleaved(inp, block, outcap, ratio)
        assert (res.input_used, res.output_generated) == \
            (int(vals[off]), int(vals[off + 1])), f"block {b} counts"
        off += 2
        for i in range(nq):
            assert r.get_required_samples(1 + i * 7, ratio) == \
                int(vals[off]), f"block {b} req[{i}]"
            assert r.get_expected_output(1 + i * 11, ratio) == \
                int(vals[off + 1]), f"block {b} exp[{i}]"
            off += 2
        assert r.get_expected_output(-1, ratio) == int(vals[off]), \
            f"block {b} flush-exp"
        off += 1
golden = pathlib.Path("/tmp/art_golden/golden_dump" + ("64" if F64 else ""))
if not golden.exists():
    sys.exit("build the golden harness first: sh tools/build_golden.sh")

fails = 0
for seed in range(lo, hi):
    # EXACTLY the suite's config generator (same rng consumption order)
    rng = np.random.default_rng(1000 + seed)
    taps = int(rng.integers(1, 40)) * 4
    filters = int(rng.integers(1, 200))
    chans = int(rng.integers(1, 5))
    mode = int(rng.integers(0, 2))
    flags = BLACKMAN_HARRIS if rng.random() < 0.7 else 0
    if rng.random() < 0.8:
        flags |= SUBSAMPLE_INTERPOLATE
    if rng.random() < 0.3:
        flags |= NO_FILTER_REDUCTION
    if rng.random() < 0.3:
        flags |= EXTRAPOLATE_ENDPOINTS
    block = int(rng.integers(64, 3000))
    nblocks = int(rng.integers(2, 5))
    if mode:
        src, dst = RATE_PAIRS[int(rng.integers(0, len(RATE_PAIRS)))]
        lowpass, ratio = 0, dst / src
        flags |= INCLUDE_LOWPASS
    else:
        src = dst = 1
        ratio = float(rng.uniform(0.3, 3.0))
        lowpass = float(rng.uniform(0.3, 0.95)) if rng.random() < 0.5 else 0.0
    advance = float(rng.integers(0, taps))
    if flags & SUBSAMPLE_INTERPOLATE and rng.random() < 0.5:
        from art_jax.core.filters import plan_fixed_ratio
        keeps_interp = (mode == 0) or bool(
            plan_fixed_ratio(taps, filters, src, dst, lowpass, flags).flags
            & SUBSAMPLE_INTERPOLATE)
        if keeps_interp:
            advance += 0.25
    if F64:
        atol = 1e-12                    # suite's f64 floor (GEMM sum order)
    else:
        atol = 8e-7 if flags & EXTRAPOLATE_ENDPOINTS else 2e-7
    try:
        if QUERY:
            compare_queries(golden, chans=chans, taps=taps, filters=filters,
                            flags=flags, mode=mode, src=src, dst=dst,
                            lowpass=lowpass, ratio=ratio, block=block,
                            nblocks=nblocks, advance=advance,
                            dtype=np.float64 if F64 else np.float32)
        else:
            # extrapolating configs get 4x headroom on block 0 only: the
            # prefill window's magnitude is not visible in the dump
            afirst = (4 * atol if flags & EXTRAPOLATE_ENDPOINTS else None)
            compare_stream(golden, chans=chans, taps=taps, filters=filters,
                           flags=flags, mode=mode, src=src, dst=dst,
                           lowpass=lowpass, ratio=ratio, block=block,
                           nblocks=nblocks, advance=advance, atol=atol,
                           atol_first=afirst,
                           dtype=np.float64 if F64 else np.float32)
    except Exception:
        fails += 1
        print(f"FAIL seed={seed}")
        traceback.print_exc()
    if (seed - lo) % 50 == 49:
        print(f"...{seed - lo + 1} done, {fails} fails", flush=True)
print(f"DONE {hi - lo} seeds, {fails} fails")
sys.exit(1 if fails else 0)
