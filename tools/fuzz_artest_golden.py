"""Randomized ARTEST differential fuzz: random option combos, our artest
vs the strict-IEEE reference build, compared with the committed matrix
contract (tests/test_artest_matrix.py): every stats line present on both
sides, every count exact, the input line bit-identical, clipped counts
exact when the decimator input is bit-identical (w2 checksum match;
otherwise +-2 for dithered clip-boundary ties — see PARITY.md),
per-stream RMS one-sided within 0.5 dB (ours may be better via
float64 convolution accumulation, never materially worse).

Usage: fuzz_artest_golden.py LO HI [--f64]
Idle-time companion to fuzz_cli_golden.py (the ART file-conversion
fuzzer); needs no accelerator.
"""
import contextlib
import io as _io
import pathlib
import re
import subprocess
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
import numpy as np

REF = pathlib.Path("/root/reference")
OUT = pathlib.Path("/tmp/art_golden")
RATES = ["8k", "16k", "22.05k", "32k", "44.1k", "48k", "64k", "96k",
         "44100", "44101"]

_LINE = re.compile(r"(\w+) \(-w(\d)\): count =\s*(\d+), checksum = (\w+), "
                   r"range = ([-\d.a-z]+) to ([-\d.a-z]+), RMS = "
                   r"([-\d.a-z]+) dB")


F64 = "--f64" in sys.argv


def build_ref() -> pathlib.Path:
    out = OUT / ("artest_ref64" if F64 else "artest_ref")
    if not out.exists():
        srcs = [REF / s for s in ["artest.c", "resampler.c",
                                  "extrapolator.c", "decimator.c",
                                  "workers.c", "biquad.c"]]
        OUT.mkdir(exist_ok=True)
        cmd = ["gcc", "-O2", "-ffp-contract=off", "-DENABLE_THREADS",
               "-DENABLE_EXTRAPOLATION", f"-I{REF}"]
        if F64:
            cmd.append("-DPATH_WIDTH=64")
        subprocess.run(cmd + [*map(str, srcs), "-lm", "-pthread",
                              "-o", str(out)], check=True,
                       capture_output=True)
    return out


def parse(text):
    out = {}
    for line in text.splitlines():
        m = _LINE.search(line)
        if m:
            out[m.group(2)] = dict(count=int(m.group(3)),
                                   checksum=m.group(4),
                                   rms=m.group(7), raw=line.strip())
        if "decimate (-w3)" in line:
            m2 = re.search(r"count =\s*(\d+), checksum = (\w+), clipped "
                           r"samples = (\d+)", line)
            if m2:
                out["3"] = dict(count=int(m2.group(1)),
                                checksum=m2.group(2),
                                clipped=int(m2.group(3)), raw=line.strip())
    return out


def gen_trial(rng):
    opts = []
    preset = rng.choice(["-1", "-2", "-3", "none", "ft"],
                        p=[.35, .25, .2, .1, .1])
    if preset == "ft":
        opts += [f"-t{int(rng.integers(1, 65)) * 4}",
                 f"-f{int(rng.integers(1, 257))}"]
    elif preset != "none":
        opts.append(str(preset))
    opts.append(f"-s{rng.choice(RATES)}")
    opts.append(f"-d{rng.choice(RATES)}")
    opts.append(f"-n{int(rng.integers(1, 3))}")
    opts.append(f"-c{int(rng.choice([1, 1, 2, 2, 3, 4, 6, 8]))}")
    if rng.random() < 0.4:
        opts.append(f"-b{int(rng.choice([256, 777, 1024, 4096, 16384]))}")
    if rng.random() < 0.3:
        opts.append(f"-o{int(rng.integers(4, 25))}")
    if rng.random() < 0.25:
        opts.append(f"-h{int(rng.integers(100, 8000))}")
    if rng.random() < 0.2:
        opts.append("-l16k")
    for fl, p in [("-e", .5), ("-i", .6), ("-a", .25), ("-x", .25),
                  ("-z", .25), ("-m", .2), ("-v", .2)] \
            + ([] if F64 else [("-p", .15)]):
        if rng.random() < p:
            opts.append(fl)
    return opts


def run_trial(seed, ref_bin):
    rng = np.random.default_rng(seed)
    opts = gen_trial(rng)
    rp = subprocess.run([str(ref_bin), *opts], capture_output=True,
                        text=True, timeout=900)
    from art_jax.cli import artest as at
    buf = _io.StringIO()
    rc = 0
    with contextlib.redirect_stderr(buf):
        try:
            rc = at.main(list(opts) + (["--f64"] if F64 else []))
        except SystemExit as e:
            if isinstance(e.code, str):
                buf.write(e.code + "\n")
                rc = 1
            else:
                rc = int(e.code or 0)
    mstderr = buf.getvalue()

    fails = []
    if rp.returncode < 0:
        # KNOWN REFERENCE DEFECT: artest uses resampleFixedRatioInit /
        # resampleInit returns unchecked (artest.c:380-437); a validation
        # failure (e.g. lowpass >= destination Nyquist, resampler.c:317)
        # prints its line and then segfaults on the NULL context.  Ours
        # must exit cleanly with the same validation line.
        rl = rp.stderr.strip().splitlines()[-1:] or [""]
        ml = mstderr.strip().splitlines()[-1:] or [""]
        if rc == 0 or rl != ml:
            fails.append(f"ref crash rc={rp.returncode} line{rl}; "
                         f"mine rc={rc} line{ml}")
        return opts, fails
    if (rp.returncode != 0) != (rc != 0):
        fails.append(f"rc {rp.returncode} vs {rc}: "
                     f"ref[{rp.stderr.strip().splitlines()[-1:]}] "
                     f"mine[{mstderr.strip().splitlines()[-1:]}]")
        return opts, fails
    if rp.returncode != 0:
        return opts, fails                 # both rejected the options

    ref, mine = parse(rp.stderr), parse(mstderr)
    if set(ref) != set(mine):
        fails.append(f"stream sets differ: {sorted(ref)} vs {sorted(mine)}")
        return opts, fails
    if "1" in ref and ref["1"]["raw"] != mine["1"]["raw"]:
        fails.append(f"input line: ref[{ref['1']['raw']}] "
                     f"mine[{mine['1']['raw']}]")
    for key in ref:
        if ref[key]["count"] != mine[key]["count"]:
            fails.append(f"w{key} count {ref[key]['count']} vs "
                         f"{mine[key]['count']}")
        if "clipped" in ref[key] and \
                ref[key]["clipped"] != mine[key].get("clipped"):
            # clipped counts are exact ONLY when the decimator INPUT is
            # bit-identical (w2 checksum match).  When w2 differs at the
            # accepted f32 convolution floor, a sample whose dithered
            # code sits within ~1 ulp of the clip decision boundary can
            # legitimately flip (measured: a 1-ulp input perturbation
            # moves seed 30338's count 497 -> 495; dither + error
            # feedback make the quantizer serial, so one tie can shift
            # nearby decisions too).  The tie population scales with the
            # clip count: at seed 63118 (-o4, 18851 clips) the REFERENCE'S
            # OWN two builds (strict IEEE vs stock -fassociative-math)
            # differ by 10 and ours by 14 — the proportional rate (0.07%)
            # is BELOW the 0.4% measured on the small-count seed.  Allow
            # max(2, 0.1%) for the boundary-tie class.
            delta = abs(ref[key]["clipped"] - mine[key].get("clipped", 0))
            allowed = max(2, int(0.001 * ref[key]["clipped"]))
            w2_same = "2" in ref and "2" in mine and \
                ref["2"]["checksum"] == mine["2"]["checksum"]
            if w2_same or delta > allowed:
                fails.append(f"w{key} clipped {ref[key]['clipped']} vs "
                             f"{mine[key].get('clipped')}")
            else:
                print(f"seed {seed}: w{key} clipped off by {delta} with "
                      "f32-floor-different decimator input (boundary-tie "
                      "class, PARITY.md) — accepted")
        if "rms" in ref[key]:
            try:
                rr, mm = float(ref[key]["rms"]), float(mine[key]["rms"])
            except ValueError:             # degenerate '-nan' streams
                if ref[key]["rms"] != mine[key]["rms"]:
                    fails.append(f"w{key} rms {ref[key]['rms']} vs "
                                 f"{mine[key]['rms']}")
                continue
            if rr < -180.0 and mm < -180.0:
                # both at numerical perfection (e.g. same-rate passthrough
                # round trips near -360 dB): the one-sided check would
                # flag meaningless last-ulp differences
                continue
            if mm - rr > 0.5:              # one-sided: ours may be better
                # SAME-RATE TONE DIFF CLASS (PARITY.md): at
                # ratio exactly 1.0 every output applies the SAME filter
                # phase, so our exactly-rounded outputs carry a rounding
                # error partially COHERENT with a tone — it adds linearly
                # across the round trip's two legs, while the reference's
                # 1.57x LARGER f32-accumulation noise is decorrelated and
                # adds in quadrature.  Ours is strictly more accurate per
                # leg (95.8% exactly-rounded vs 54.5%); the diff-stream
                # RMS can still read up to ~1 dB "worse".  Accept <=1.5 dB
                # at the error floor for this configuration class only.
                def hz(v):
                    return float(v[:-1]) * 1000 if v.endswith("k") \
                        else float(v)
                srate = next((hz(o[2:]) for o in opts
                              if o.startswith("-s")), None)
                drate = next((hz(o[2:]) for o in opts
                              if o.startswith("-d")), None)
                tone = any(o.startswith("-h") for o in opts)
                if key == "5" and tone and srate == drate \
                        and rr <= -140.0 and mm <= -140.0 \
                        and mm - rr <= 1.5:
                    print(f"seed {seed}: w5 rms {rr} vs {mm} at ratio 1.0 "
                          "on a tone (coherent-rounding class, "
                          "PARITY.md) — accepted")
                else:
                    fails.append(f"w{key} rms {rr} vs {mm} (worse by "
                                 f"{mm - rr:.2f} dB)")
    if fails:
        # KNOWN REFERENCE DEFECT (PARITY.md "flush out-of-bounds read"):
        # some configs make the reference read heap memory before its ring
        # during flush, so its OWN stats vary run to run (w2 range/RMS/
        # checksum, w3 clipped).  Detect by re-running the reference: if it
        # disagrees with itself, the comparison is void — require only
        # that our side is deterministic and finite.
        rp2 = subprocess.run([str(ref_bin), *opts], capture_output=True,
                             text=True, timeout=900)
        if rp2.stderr != rp.stderr:
            ref2 = parse(rp2.stderr)
            nondet = sorted(k for k in ref
                            if ref[k]["raw"] != ref2.get(k, {}).get("raw"))
            finite = all("inf" not in mine[k]["raw"]
                         and "nan" not in mine[k]["raw"] for k in mine)
            print(f"seed {seed}: REF-NONDETERMINISTIC on w{nondet} "
                  f"(flush OOB-read defect, PARITY.md) — comparison void; "
                  f"ours finite={finite}")
            return opts, ([] if finite else
                          ["ours non-finite on ref-defect config"])
    return opts, fails


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    lo, hi = int(args[0]), int(args[1])
    ref_bin = build_ref()
    nfail = 0
    for seed in range(lo, hi):
        try:
            opts, fails = run_trial(seed, ref_bin)
        except Exception as e:  # noqa: BLE001 — report and continue
            rng = np.random.default_rng(seed)
            print(f"seed {seed}: {gen_trial(rng)} EXC {e!r}")
            nfail += 1
            continue
        if fails:
            nfail += 1
            print(f"seed {seed}: {opts}")
            for f in fails:
                print(f"   {f}")
        if (seed - lo + 1) % 25 == 0:
            print(f"...{seed - lo + 1} done, {nfail} fails", flush=True)
    print(f"DONE {hi - lo} seeds, {nfail} fails")
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())
