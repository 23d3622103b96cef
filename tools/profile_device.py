"""Device profile of two bring-up questions, on whatever backend JAX has.

1. The batched ASRC step (parallel/asrc._asrc_step) at config-5 shapes —
   256 streams, 380 taps x 380 filters, 32768-frame calls, ratios 1 +- 1% —
   in float32 and float64: warm milliseconds per call (median over calls,
   each ended by block_until_ready), XLA's cost analysis (flops, bytes
   accessed; a while loop's body counts once, not per trip) and the top
   device operations of a profiler trace.
2. How the fixed-ratio contraction lowers in each precision mode (f32,
   int8, f64-accumulate): the custom calls and fusions that carry the dots
   in the compiled flat-group step, with their operand types.

    python tools/profile_device.py [--out DIR] [--streams S] [--frames N]

Prints one JSON object; the trace goes under DIR/trace_<dtype>.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from art_jax._jaxinit import ensure_jax  # noqa: E402

jax = ensure_jax()
import jax.numpy as jnp  # noqa: E402


def _cost(compiled) -> dict:
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return {k: float(ca[k]) for k in ("flops", "bytes accessed")
            if k in ca}


def top_device_ops(trace_dir: str, k: int = 12) -> dict:
    """Sum device-event durations by name over the trace's GPU planes."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        return {"error": "no xplane.pb written"}
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(sorted(paths)[-1])
    per = defaultdict(float)
    busy = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                per[ev.name] += ev.duration_ns / 1e6
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    total = sum(per.values())
    # device busy time = union of event intervals
    busy.sort()
    union, cur = 0.0, None
    for s, e in busy:
        if cur is None or s > cur[1]:
            if cur is not None:
                union += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        union += cur[1] - cur[0]
    top = sorted(per.items(), key=lambda kv: -kv[1])[:k]
    return {"device_event_ms": total, "device_busy_ms": union / 1e6,
            "top": [{"name": n[:120], "ms": ms} for n, ms in top]}


def profile_asrc(out_dir: str, S: int, n: int, calls: int = 8) -> dict:
    from art_jax.parallel.asrc import BatchedASRC, _asrc_step

    res = {}
    rng = np.random.default_rng(0)
    for dt in (np.float32, np.float64):
        eng = BatchedASRC(S, 380, 380, dtype=dt)
        eng.advance_position(190.0)
        x = jnp.asarray(rng.uniform(-0.5, 0.5, (S, n)).astype(dt))
        steps = []
        orig = eng._run_step

        def timed_step(*a, **kw):
            t0 = time.perf_counter()
            h, o = orig(*a, **kw)
            o.block_until_ready()
            steps.append(time.perf_counter() - t0)
            return h, o

        eng._run_step = timed_step
        ratios = [1.0 + 0.01 * np.sin(np.arange(S) * 0.1 + 0.031 * t)
                  for t in range(2 * calls + 1)]
        outs = 0
        t_first = time.perf_counter()
        eng.process(x, ratios[0])
        t_first = time.perf_counter() - t_first
        steps.clear()
        t0 = time.perf_counter()
        for t in range(1, calls + 1):
            _, Ks = eng.process(x, ratios[t])
            outs += int(Ks.sum())
        wall = time.perf_counter() - t0
        # the step's own compiled form at this call's shapes
        k_max = eng._bucketed_k_max(None, int(np.ceil((n + 2) * 1.01)) + 2)
        compiled = _asrc_step.lower(
            eng.hist, x, eng._bank_dev, jnp.asarray(eng.offsets),
            jnp.asarray(ratios[0]), jnp.zeros((S,), jnp.int32),
            jnp.int32(eng.num_samples - eng.input_index),
            num_taps=380, num_filters=380, k_max=k_max,
            hist_len=eng.num_samples).compile()
        eng._run_step = orig
        tdir = os.path.join(out_dir, f"trace_{np.dtype(dt).name}")
        with jax.profiler.trace(tdir):
            for t in range(calls + 1, calls + 4):
                _, Ks = eng.process(x, ratios[t])
            jax.block_until_ready(eng.hist)
        ms = sorted(steps)[len(steps) // 2] * 1e3
        cost = _cost(compiled)
        row = {"first_call_s": t_first, "step_ms_median": ms,
               "step_ms_all": [s * 1e3 for s in steps],
               "outputs_per_s": outs / wall, "k_max": k_max,
               "cost": cost, "trace": top_device_ops(tdir)}
        if "bytes accessed" in cost:
            row["achieved_GBps"] = cost["bytes accessed"] / (ms * 1e-3) / 1e9
        res[np.dtype(dt).name] = row
    return res


_CALL = re.compile(r'custom_call_target="([^"]+)"')


def dot_lowering(frames: int) -> dict:
    """Custom-call targets and dot-carrying fusions of the compiled
    flat-group delivery step, per precision mode."""
    from art_jax.core import flags as F
    from art_jax.parallel.streams import (DeviceStreamResampler,
                                          _chunk_group_static_out)

    IB = F.SUBSAMPLE_INTERPOLATE | F.BLACKMAN_HARRIS
    res = {}
    for mode, precise in (("f32", False), ("int8", "int8"),
                          ("f64acc", True)):
        eng = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB,
                                    precise=precise)
        eng.advance_position(190)
        chunk = max(1, round(frames / eng.M)) * eng.M
        G = 2
        x = jnp.zeros((2, (G + 1) * chunk), jnp.float32)
        eng.process(x[:, :chunk], chunk)
        flat = x[:, chunk:]
        G, K0, start0, nb, Pm, fracv, _ = eng._flat_plan(flat, chunk)
        text = _chunk_group_static_out.lower(
            eng.hist, flat, Pm, fracv, int(start0), int(K0), G, chunk,
            eng.M, eng.L, nb, eng.qn, eng.num_samples,
            eng._precise).compile().as_text()
        targets = defaultdict(int)
        for t in _CALL.findall(text):
            targets[t] += 1
        lines = [ln.strip()[:240] for ln in text.splitlines()
                 if ("custom-call" in ln or " dot(" in ln
                     or "__triton_gemm" in ln or "kind=kCustom" in ln)
                 and "ENTRY" not in ln]
        res[mode] = {"custom_call_targets": dict(targets),
                     "dot_lines": lines[:40]}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile")
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--frames", type=int, default=32768)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dev = jax.devices()[0]
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind}}
    sections = (("asrc_step", lambda: profile_asrc(args.out, args.streams,
                                                   args.frames)),
                ("dot_lowering", lambda: dot_lowering(1 << 16)))
    for name, fn in sections:
        result[name] = fn()
        # written after each section, so a later failure keeps the earlier
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
