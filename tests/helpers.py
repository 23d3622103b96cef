"""Shared helpers for golden comparisons against the reference harness."""

import subprocess

import numpy as np

from art_jax.engines.resampler import Resampler
from art_jax.utils.testsig import NoiseLCG


def parse_resample_dump(raw: bytes, chans: int, nblocks: int,
                        dtype=np.float32):
    """Parse golden_dump resample output: per-block counts + samples + pos."""
    itemsize = np.dtype(dtype).itemsize
    off = 0
    blocks = []
    for _ in range(nblocks + 1):
        iu, og = np.frombuffer(raw, dtype=np.uint32, count=2, offset=off)
        off += 8
        data = np.frombuffer(raw, dtype=dtype, count=int(og) * chans,
                             offset=off).reshape(int(og), chans)
        off += int(og) * chans * itemsize
        blocks.append((int(iu), int(og), data))
    pos = float(np.frombuffer(raw, dtype=np.float64, count=1, offset=off)[0])
    return blocks, pos


def run_golden_resample(golden_bin, *, chans, taps, filters, flags, mode,
                        src, dst, lowpass, ratio, block, nblocks, advance,
                        dtype=np.float32):
    args = [str(golden_bin), "resample", str(chans), str(taps), str(filters),
            format(flags, "x"), str(mode), str(src), str(dst), str(lowpass),
            repr(ratio), str(block), str(nblocks), repr(advance)]
    raw = subprocess.run(args, capture_output=True, check=True).stdout
    return parse_resample_dump(raw, chans, nblocks, dtype)


def compare_stream(golden_bin, *, chans, taps, filters, flags, mode, src, dst,
                   lowpass, ratio, block, nblocks, advance, atol,
                   atol_first=None, dtype=np.float32, backend="numpy"):
    """Run the same chunked stream through C and art_jax; assert count and
    position parity exactly, sample parity within atol.  Returns maxdiff.

    ``atol_first``: optional looser bound for block 0 only — the
    prefill-extrapolation window can contain input samples far larger
    than any dumped OUTPUT (seed 7183: ~13 f32 ulps at the first
    emission from a window the dump cannot expose), so extrapolating
    configs need headroom there that the steady state must not get."""
    ref_blocks, ref_pos = run_golden_resample(
        golden_bin, chans=chans, taps=taps, filters=filters, flags=flags,
        mode=mode, src=src, dst=dst, lowpass=lowpass, ratio=ratio,
        block=block, nblocks=nblocks, advance=advance, dtype=dtype)

    if mode:
        r = Resampler.fixed_ratio(chans, taps, filters, src, dst, lowpass,
                                  flags, dtype=dtype, backend=backend)
    else:
        r = Resampler(chans, taps, filters, lowpass, flags, dtype=dtype,
                      backend=backend)
    if advance:
        r.advance_position(advance)

    lcg = NoiseLCG()
    rr = max(ratio, 1.0) if ratio else 1.0
    if src and dst:
        rr = max(rr, dst / src)
    outcap = int((block + taps) * rr) + taps + 64
    maxdiff = 0.0
    half = taps // 2
    num_samples = taps * 16
    for b in range(nblocks + 1):
        k_skip = 0
        if b < nblocks:
            inp = lcg.fill(block * chans, dtype).reshape(block, chans)
            out, res = r.process_interleaved(inp, block, outcap, ratio)
        else:
            # KNOWN REFERENCE DEFECT (resampler.c:663-685): when the flush
            # postfill slides the ring, outputOffset can land closer than
            # half a filter to the ring start, and subsample() then reads
            # up to half-1 samples BEFORE the buffer — heap garbage.  Our
            # engine keeps the full history and computes those samples
            # correctly, so they cannot (and should not) match: exclude
            # exactly the outputs whose reference window underflows.
            eff = r.fixed_ratio if r.fixed_ratio else ratio
            o_ring = r.output_offset
            if num_samples - r.input_index < half:
                o_ring -= num_samples - taps
            out, res = r.process_interleaved(None, -1, outcap, ratio)
            k = np.arange(max(res.output_generated, 1), dtype=np.float64)
            lo = np.floor(o_ring + k / eff) - half + 1
            k_skip = int((lo < 0).sum())
        riu, rog, rdata = ref_blocks[b]
        assert (res.input_used, res.output_generated) == (riu, rog), \
            f"block {b}: counts {(res.input_used, res.output_generated)} " \
            f"!= ref {(riu, rog)}"
        if rog > k_skip:
            d = float(np.abs(out.astype(np.float64)[k_skip:]
                             - rdata.astype(np.float64)[k_skip:]).max())
            # float32 convolution noise is RELATIVE to the data magnitude:
            # extrapolated prefill can overshoot the +-1 noise range by
            # 30-370x (fuzz seeds 7004/7042/7183/7493), scaling the
            # absolute error floor with it.  Normalize per block by the
            # reference's own peak so atol keeps its ~ulps-at-|x|~1
            # meaning everywhere.
            scale = max(1.0, float(np.abs(rdata).max()))
            if b == 0 and atol_first is not None:
                maxdiff = max(maxdiff, d / scale * (atol / atol_first))
            else:
                maxdiff = max(maxdiff, d / scale)
    assert abs(r.get_position() - ref_pos) == 0.0, \
        f"position {r.get_position()} != ref {ref_pos}"
    assert maxdiff <= atol, f"maxdiff {maxdiff} > atol {atol}"
    return maxdiff
