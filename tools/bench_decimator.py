"""Host decimator bench: our native runtime vs the C reference decimator.

Builds the reference decimator (with the reference's own release flags,
-O3 -mavx2, reference Makefile:10) as a shared lib into /tmp/art_golden and
times decimateProcessInterleavedLE against our Decimator engine on the same
signal: stereo 44.1k, 16-bit, highpass TPDF dither + ATH shaping (the ART
CLI default path, reference art.c:84).
"""
import ctypes
import subprocess
import time
from pathlib import Path

import numpy as np

REF = Path("/root/reference")
LIB = Path("/tmp/art_golden/libdecimator_ref.so")


def build_ref():
    if LIB.exists():
        return
    LIB.parent.mkdir(exist_ok=True)
    subprocess.run(
        ["gcc", "-O3", "-mavx2", "-fno-signed-zeros", "-fno-trapping-math",
         "-fassociative-math", "-fPIC", "-shared", f"-I{REF}",
         str(REF / "decimator.c"), str(REF / "biquad.c"), "-lm",
         "-o", str(LIB)], check=True, capture_output=True)


def main():
    build_ref()
    lib = ctypes.CDLL(str(LIB))
    lib.decimateInit.restype = ctypes.c_void_p
    lib.decimateInit.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_int, ctypes.c_int]
    lib.decimateProcessInterleavedLE.restype = ctypes.c_int
    lib.decimateProcessInterleavedLE.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]

    n, ch, reps = 1 << 20, 2, 20
    rng = np.random.default_rng(0)
    x = (rng.random((n, ch)).astype(np.float32) - 0.5) * 1.6
    flags = 0x1 | 0x800     # DITHER_HIGHPASS | SHAPING_ATH_CURVE (decimator.h)
    cxt = lib.decimateInit(ch, 16, 2, 1.0, 44100, flags)
    out = np.empty(n * ch * 2, dtype=np.uint8)
    xp = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    op = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.decimateProcessInterleavedLE(cxt, xp, n, op)    # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        lib.decimateProcessInterleavedLE(cxt, xp, n, op)
    dt_ref = (time.perf_counter() - t0) / reps

    from art_jax.engines.decimator import Decimator
    from art_jax.core import flags as fl
    d = Decimator(ch, 16, 2, 1.0, 44100,
                  fl.DITHER_HIGHPASS | fl.SHAPING_ATH_CURVE,
                  backend="native")
    d.process_interleaved(x[:4096])                     # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        d.process_interleaved(x)
    dt_us = (time.perf_counter() - t0) / reps

    print(f"C reference (-O3 -mavx2): {n/dt_ref/1e6:7.1f} Mframes/s")
    print(f"art_jax native runtime:   {n/dt_us/1e6:7.1f} Mframes/s "
          f"({dt_ref/dt_us:.2f}x C)")


if __name__ == "__main__":
    main()
