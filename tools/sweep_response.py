"""Frequency-response sweep of the resampler (the in-repo analog of the
hydrogenaudio / Infinite Wave external validations, reference
README.md:42-46).

Downsampling 96k -> 44.1k: tones above the target Nyquist must alias at
the filter's stopband attenuation (auto-lowpass design target ~98 dB for
long filters, reference resampler.c:337-338); tones below 20 kHz measure
passband ripple.  Upsampling 44.1k -> 96k: image rejection.

Prints one JSON line per preset with the measured numbers.
"""
import json
import math
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
import jax

jax.config.update("jax_platforms", "cpu")

from art_jax.core import flags as F
from art_jax.engines.resampler import Resampler

IB = F.SUBSAMPLE_INTERPOLATE | F.BLACKMAN_HARRIS | F.INCLUDE_LOWPASS


def goertzel_amp(x, freq, rate):
    n = len(x)
    k = round(freq * n / rate)
    w = 2 * math.pi * k / n
    coeff = 2 * math.cos(w)
    s0 = s1 = 0.0
    for v in x:
        s0, s1 = v + coeff * s0 - s1, s0
    power = s1 * s1 + s0 * s0 - coeff * s0 * s1
    return math.sqrt(max(power, 0.0)) * 2 / n


NA = 16384            # analysis window (output samples, steady state)


def measure(taps, filters, src, dst, freqs):
    out_rows = []
    grid = dst / NA
    for f0 in freqs:
        # snap the tone to the output analysis grid: both the direct
        # response and any fold |f0 - k*dst| then land exactly on Goertzel
        # bins (otherwise half-bin scalloping costs up to ~3.9 dB)
        f0 = round(f0 / grid) * grid
        r = Resampler.fixed_ratio(1, taps, filters, src, dst, 0, IB,
                                  dtype=np.float64)
        r.advance_position(taps // 2)
        n = int(src * 0.6)
        t = np.arange(n) / src
        x = (0.5 * np.sin(2 * math.pi * f0 * t))[None, :]
        out, res = r.process(x, n, int(n * dst / src) + 64, 0.0)
        y = out[0][taps * 2:taps * 2 + NA]      # steady state
        assert len(y) == NA
        if f0 < dst / 2:
            amp = goertzel_amp(y, f0, dst)      # direct response
        else:
            alias = abs(f0 - round(f0 / dst) * dst)
            amp = goertzel_amp(y, alias, dst)   # folded image
        out_rows.append((round(f0), 20 * math.log10(max(amp / 0.5,
                                                        1e-12))))
    return out_rows


def main():
    for preset, taps, filters in ((1, 48, 48), (3, 380, 380)):
        # the auto-lowpass cuts at ~(1 - 7.5/taps/ratio) of the target
        # Nyquist (reference resampler.c:340-348), so 18-20 kHz is the
        # transition band BY DESIGN (identical filters to the C reference,
        # golden-tested in test_filters.py) — passband is measured below
        # 0.8x target Nyquist, transition droop reported separately
        freqs_pass = [100, 1000, 5000, 10000, 15000, 17000]
        freqs_trans = [19000, 21000]
        freqs_stop = [23000, 26000, 30000, 36000, 42000]
        rows = measure(taps, filters, 96000, 44100,
                       freqs_pass + freqs_trans + freqs_stop)
        pb = [db for f, db in rows[:len(freqs_pass)]]
        sb = [db for f, db in rows[-len(freqs_stop):]]
        print(json.dumps({
            "preset": preset, "conversion": "96k->44.1k",
            "passband_ripple_db": round(max(pb) - min(pb), 3),
            "worst_passband_dev_db": round(max(abs(d) for d in pb), 3),
            "transition_droop_db": [
                (f, round(db, 2)) for f, db in
                rows[len(freqs_pass):len(freqs_pass) + len(freqs_trans)]],
            "stopband_attenuation_db": round(-max(sb), 1),
            "rows": [(f, round(db, 2)) for f, db in rows],
        }))


if __name__ == "__main__":
    main()
