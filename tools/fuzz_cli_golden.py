"""Differential CLI fuzz: random WAV fixtures x random option combos,
our `art` CLI vs the strict-IEEE reference build (same recipe as the
test-suite's art_ref fixture — the parity target is the reference's math,
not its -fassociative-math build artifacts).

Per trial the comparison is class-aware (PARITY.md's parity classes):
  - exit code: always exact; on error the final stderr line must match.
  - WAV header fields + frame counts: always exact.
  - samples: byte-exact when no resampler sits in the chain (gain,
    stretch, decimate-only — the deterministic-dither classes); at the
    f32 conversion floor when a resampler does (rel RMS bounds from the
    committed test classes: PCM -60 dB, float -110 dB).
  - clip-count warnings: exact in the byte-exact classes.

This is the CLI bug hunter (host-only, needs no accelerator),
complementing tools/fuzz_stream_golden.py which fuzzes the library
surface.  Usage: fuzz_cli_golden.py LO HI [--f64]
"""
import contextlib
import io as _io
import math
import pathlib
import re
import subprocess
import os
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
import numpy as np

REF = pathlib.Path("/root/reference")
OUT = pathlib.Path("/tmp/art_golden")
RATES = [8000, 16000, 22050, 32000, 44100, 44101, 48000, 64000, 96000]

F64 = "--f64" in sys.argv
if __name__ == "__main__":
    _args = [a for a in sys.argv[1:] if not a.startswith("--")]
    lo, hi = int(_args[0]), int(_args[1])


def build_ref(name: str, f64: bool) -> pathlib.Path:
    out = OUT / name
    if not out.exists():
        srcs = [REF / s for s in ["art.c", "stretch.c", "resampler.c",
                                  "extrapolator.c", "decimator.c",
                                  "workers.c", "biquad.c"]]
        OUT.mkdir(exist_ok=True)
        cmd = ["gcc", "-O2", "-ffp-contract=off", "-DENABLE_THREADS",
               "-DENABLE_EXTRAPOLATION", f"-I{REF}"]
        if f64:
            cmd.append("-DPATH_WIDTH=64")
        subprocess.run(cmd + [*map(str, srcs), "-lm", "-pthread",
                              "-o", str(out)], check=True,
                       capture_output=True)
    return out


def write_wav(path, data, rate, bits):
    from art_jax.io import wavfile
    n, ch = data.shape
    mask = (0x5 - ch) if ch <= 2 else (1 << ch) - 1
    with open(path, "wb") as f:
        wavfile.write_wav_header(f, bits=bits, num_channels=ch,
                                 num_frames=n, sample_rate=rate,
                                 channel_mask=mask)
        if bits >= 32:
            f.write(data.astype("<f8" if bits == 64 else "<f4").tobytes())
        else:
            scale = 1 << (bits - 1)
            q = np.clip(np.round(data * scale), -scale, scale - 1)
            flat = (q.astype(np.int64) + (1 << bits)).reshape(-1)
            nbytes = (bits + 7) // 8
            raw = np.zeros((flat.size, nbytes), np.uint8)
            for i in range(nbytes):
                raw[:, i] = (flat >> (8 * i)) & 0xFF
            f.write(raw.tobytes())


def read_wav(path):
    from art_jax.io import wavfile
    with open(path, "rb") as f:
        try:
            info = wavfile.read_wav_header(f)
        except wavfile.WavFormatError:
            # zero-output-frame conversions write a 0-sample WAV the
            # strict reader rejects; compare those files whole
            f.seek(0)
            return None, f.read()
        data = f.read()
    return info, data


def decode(info, data):
    """Linear decode for diff measurement (any bijective map works: both
    files are decoded identically)."""
    bps, bits = info.bytes_per_sample, info.bits_per_sample
    n = len(data) // bps
    if info.is_float:
        return np.frombuffer(data, "<f8" if bits == 64 else "<f4",
                             count=n).astype(np.float64)
    raw = np.frombuffer(data, np.uint8,
                        count=n * bps).reshape(-1, bps).astype(np.int64)
    v = sum(raw[:, i] << (8 * i) for i in range(bps))
    if bits <= 8:
        return v.astype(np.float64) - 128.0 * (1 << (8 * (bps - 1)))
    top = 8 * bps
    v = np.where(v >= (1 << (top - 1)), v - (1 << top), v)
    return v.astype(np.float64)


def gen_trial(rng, f64):
    ch = int(rng.choice([1, 1, 2, 2, 2, 3, 4, 6]))
    rate = int(rng.choice(RATES))
    n = int(rng.choice([0, 1, 7, 100, 3000, 8000, 20000],
                       p=[.03, .03, .06, .18, .3, .3, .1]))
    fmt = str(rng.choice(["i16", "i24", "f32"] + (["f64"] if f64 else [])))
    amp = float(rng.choice([0.25, 0.9, 1.1], p=[.5, .35, .15]))

    opts = []
    preset = rng.choice(["-1", "-2", "-3", "none", "ft"],
                        p=[.3, .2, .2, .2, .1])
    if preset == "ft":
        opts += [f"-t{int(rng.integers(1, 65)) * 4}",
                 f"-f{int(rng.integers(1, 257))}"]
    elif preset != "none":
        opts.append(str(preset))
    has_resample = False
    if rng.random() < 0.75:
        tgt = int(rng.choice(RATES))
        if tgt != rate:
            has_resample = True
        opts.append(f"-r{tgt}")
    if rng.random() < 0.25:
        opts.append(f"-g{rng.uniform(-6, 6):.2f}")
    if rng.random() < 0.15:
        opts.append(f"-s{rng.uniform(-300, 300):.1f}")
        has_resample = True
    if rng.random() < 0.15:
        opts.append(f"-l{int(rng.integers(1000, rate // 2 + 1))}")
        has_resample = True
    obits = rng.choice(["16", "16", "24", "32", "8", "5", "20", "none"])
    if obits != "none":
        opts.append(f"-o{obits}")
    if rng.random() < 0.4:
        opts.append(f"-d{int(rng.integers(0, 3))}")
    if rng.random() < 0.4:
        opts.append(f"-n{int(rng.integers(0, 4))}")
    for fl, p in [("-a", .1), ("-b", .2), ("-h", .15), ("-x", .2),
                  ("-p", .2), ("-e", .1), ("-m", .15)]:
        if rng.random() < p:
            opts.append(fl)
    if rng.random() < 0.25:
        if rng.random() < 0.5:
            opts.append(f"--pitch={int(rng.integers(-2400, 2401))}")
            has_resample = True
        else:
            opts.append(f"--tempo={rng.uniform(0.25, 4.0):.3f}")
    out_is_float = obits in ("none", "32") and fmt.startswith("f") \
        or obits == "32"
    if f64:
        opts.append("--f64")
    return dict(ch=ch, rate=rate, n=n, fmt=fmt, amp=amp, opts=opts,
                resample=has_resample, float_out=out_is_float)


CLIP_RE = re.compile(r"warning: (\d+) samples? (?:were|was) clipped")


def run_mine(argv):
    """In-process CLI invocation (one interpreter for the whole sweep)."""
    from art_jax.cli import art as artcli
    err = _io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            rc = artcli.main(list(argv))
        except SystemExit as e:          # argument errors may sys.exit
            if isinstance(e.code, str):  # sys.exit("msg"): msg -> stderr, rc 1
                err.write(e.code + "\n")
                rc = 1
            else:
                rc = int(e.code or 0)
    return rc, err.getvalue()


def run_trial(seed, ref_bin, f64, tdir):
    rng = np.random.default_rng(seed)
    t = gen_trial(rng, f64)
    data = rng.standard_normal((t["n"], t["ch"])) * t["amp"] * 0.5
    bits = {"i16": 16, "i24": 24, "f32": 32, "f64": 64}[t["fmt"]]
    wav_in = tdir / f"in{seed}.wav"
    write_wav(wav_in, data, t["rate"], bits)
    ref_out, my_out = tdir / f"r{seed}.wav", tdir / f"m{seed}.wav"

    rp = subprocess.run([str(ref_bin),
                         *[o for o in t["opts"] if o != "--f64"],
                         "-y", "-q", str(wav_in), str(ref_out)],
                        capture_output=True, text=True, timeout=600)
    mrc, mstderr = run_mine([*t["opts"], "-y", "-q", str(wav_in),
                             str(my_out)])
    fails = []
    if rp.returncode < 0 and "invalid periods" in (rp.stderr or ""):
        # KNOWN REFERENCE DEFECT: stretchInit rejects rate//350 <
        # MIN_PERIOD (rates under ~8.4k), prints 'invalid periods!' and
        # returns NULL; art.c:786 then dereferences it.  Ours must print
        # the same line and exit cleanly.
        if mrc == 0 or "stretchInit(): invalid periods!" not in mstderr:
            fails.append(f"ref invalid-periods crash; mine rc={mrc} "
                         f"stderr={mstderr.strip()[:80]!r}")
        return t, fails
    if rp.returncode < 0 and "-p" in t["opts"] and \
            any(o.startswith("--pitch") or o.startswith("--tempo")
                for o in t["opts"]):
        # KNOWN REFERENCE DEFECT: with a stretcher + pre-filter, the
        # biquad walks the RAW read buffer with the STRETCHED count
        # (art.c:1011-1017) — a heap overflow that segfaults when the
        # stretched count runs far past BUFFER_SAMPLES (silent corruption
        # otherwise), and the filtered data is discarded anyway.  Ours
        # makes -p a documented no-op under stretch and must succeed.
        if mrc != 0:
            fails.append(f"ref crashed (known -p+stretch bug) but mine "
                         f"rc={mrc}")
        return t, fails
    if rp.returncode < 0 and "-m" in t["opts"]:
        # KNOWN REFERENCE DEFECT: the threaded decimator dereferences
        # tpdf_generators[ch] / noise_shapers[ch] unconditionally
        # (decimator.c:129-131), but decimateInit only allocates them
        # under DITHER_ENABLED / SHAPING_ENABLED (decimator.c:41,73) —
        # `art -m -d0` or `-m -n0` segfaults (both builds).  Ours must
        # simply succeed.
        if mrc != 0:
            fails.append(f"ref crashed (known -m bug) but mine rc={mrc}")
        return t, fails
    if (rp.returncode != 0) != (mrc != 0):
        fails.append(f"rc {rp.returncode} vs {mrc}: "
                     f"ref[{rp.stderr.strip().splitlines()[-1:]}] "
                     f"mine[{mstderr.strip().splitlines()[-1:]}]")
        return t, fails
    if rp.returncode != 0:
        rl = rp.stderr.strip().splitlines()[-1:] or [""]
        ml = mstderr.strip().splitlines()[-1:] or [""]
        if rl != ml:
            fails.append(f"err line: ref{rl} mine{ml}")
        return t, fails

    ri, rd = read_wav(ref_out)
    mi, md = read_wav(my_out)
    if ri is None or mi is None:        # zero-sample outputs: whole-file
        if not (ri is None and mi is None and rd == md):
            fails.append("zero-sample output files differ")
        return t, fails
    for f in ("num_channels", "num_frames", "sample_rate",
              "bits_per_sample", "bytes_per_sample", "channel_mask"):
        if getattr(ri, f) != getattr(mi, f):
            fails.append(f"header {f}: {getattr(ri, f)} vs {getattr(mi, f)}")
    if fails:
        return t, fails

    byte_exact = not t["resample"]
    if byte_exact:
        if rd != md:
            va, vb = decode(ri, rd), decode(mi, md)
            k = min(len(va), len(vb))
            dmax = float(np.abs(va[:k] - vb[:k]).max()) if k else -1.0
            nd = int((va[:k] != vb[:k]).sum())
            fails.append(f"bytes differ in exact class "
                         f"(max LSB {dmax}, {nd}/{k} samples)")
    else:
        va, vb = decode(ri, rd), decode(mi, md)
        if len(va) != len(vb):
            fails.append(f"sample count {len(va)} vs {len(vb)}")
        elif len(va):
            d = va - vb
            rms = math.sqrt(float((d ** 2).mean()))
            if ri.is_float:
                sig = math.sqrt(float((va ** 2).mean())) or 1e-30
                rel_db = 20 * math.log10(rms / sig) if rms > 0 else -999.0
                if rel_db >= -110.0 and rms > 1e-12:
                    fails.append(f"rel rms {rel_db:.1f} dB >= -110")
            else:
                # PCM after a resampler: a single f32-ulp tie flip
                # decorrelates the two streams' shaped quantization
                # errors, so the diff legitimately reaches
                # sqrt(2) x shaped-error rms (several code LSB, flat-
                # measured).  A real bug (wrong filter/offset) shows up
                # at SIGNAL scale — thousands of LSB — so bound in code-
                # LSB units, far above flip noise, far below signal.
                lsb = float(1 << ((24 - ri.bits_per_sample) % 8))
                if rms / lsb > 64.0:
                    fails.append(f"PCM diff rms {rms / lsb:.1f} LSB > 64")
    rc = CLIP_RE.search(rp.stderr or "")
    mc = CLIP_RE.search(mstderr or "")
    if byte_exact and (rc.group(1) if rc else None) != \
            (mc.group(1) if mc else None):
        fails.append(f"clip counts: ref {rc and rc.group(1)} "
                     f"vs {mc and mc.group(1)}")
    return t, fails


def main():
    ref_bin = build_ref("art_ref64" if F64 else "art_ref", F64)
    nfail = 0
    with tempfile.TemporaryDirectory() as td:
        tdir = pathlib.Path(td)
        for seed in range(lo, hi):
            try:
                t, fails = run_trial(seed, ref_bin, F64, tdir)
            except Exception as e:  # noqa: BLE001 — report and continue
                print(f"seed {seed}: EXC {e!r}")
                nfail += 1
                continue
            if fails:
                nfail += 1
                print(f"seed {seed}: {t['opts']} fmt={t['fmt']} "
                      f"ch={t['ch']} n={t['n']} rate={t['rate']}")
                for f in fails:
                    print(f"   {f}")
            if (seed - lo + 1) % 25 == 0:
                print(f"...{seed - lo + 1} done, {nfail} fails", flush=True)
    print(f"DONE {hi - lo} seeds, {nfail} fails")
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())
