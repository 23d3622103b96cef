/* golden_dump.c — test harness that drives the *reference* C library
 * (built out-of-tree from /root/reference, never copied into this repo) and
 * dumps ground-truth data for the art_jax golden tests.
 *
 * This file is original harness code for this project; it only calls the
 * reference's public APIs.
 *
 * Usage:
 *   golden_dump bank <taps> <filters> <lowpass_ratio> <bh 0|1> <interp 0|1>
 *       -> stdout: (filters+1)*taps float32 (or float64 for 64-bit build)
 *
 *   golden_dump resample <chans> <taps> <filters> <flags_hex> <mode> \
 *               <src_rate> <dst_rate> <lowpass> <ratio> <block> <nblocks> \
 *               <advance> <seed_lo_hex>
 *       mode: 0 = resampleInit (lowpass = ratio vs source nyquist)
 *             1 = resampleFixedRatioInit (lowpass = freq in Hz)
 *       input: LCG noise identical to art_jax.utils.testsig
 *       -> stdout per block: uint32 input_used, uint32 output_generated,
 *          then output_generated*chans samples; final flush block included.
 *
 *   golden_dump decimate <chans> <bits> <bytes> <gain> <rate> <flags_hex> \
 *               <nframes> <nblocks>
 *       -> stdout: uint32 clipped_total, then packed bytes.
 *
 *   golden_dump biquad <mode lowpass|highpass> <freq> <order_gain> <n>
 *       -> runs 2 cascaded biquads over LCG noise, dumps output samples.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "resampler.h"
#include "extrapolator.h"
#include "decimator.h"
#include "biquad.h"

static uint64_t lcg_state = 0x3141592653589793ULL;

static void noise_fill (artsample_t *data, int count)
{
    while (count--) {
        lcg_state = ((lcg_state << 4) - lcg_state) ^ 1;
        lcg_state = ((lcg_state << 4) - lcg_state) ^ 1;
        lcg_state = ((lcg_state << 4) - lcg_state) ^ 1;
        *data++ = (int32_t)(lcg_state >> 32) / 4294967296.0;
    }
}

static void dump_u32 (unsigned int v) { fwrite (&v, 4, 1, stdout); }

int main (int argc, char **argv)
{
    if (argc < 2) return 1;

    if (!strcmp (argv[1], "bank")) {
        int taps = atoi (argv[2]), filters = atoi (argv[3]);
        double lowpass = atof (argv[4]);
        int flags = (atoi (argv[5]) ? BLACKMAN_HARRIS : 0) |
                    (atoi (argv[6]) ? SUBSAMPLE_INTERPOLATE : 0);
        Resample *cxt = resampleInit (1, taps, filters, lowpass, flags);
        if (!cxt) return 1;
        /* the context layout is opaque; recover the bank by impulse probing:
         * instead, just re-run one process call per phase?  Simpler: the
         * header exposes the struct, use it directly. */
        for (int i = 0; i <= cxt->numFilters; ++i)
            fwrite (cxt->filters[i], sizeof (artsample_t), taps, stdout);
        resampleFree (cxt);
        return 0;
    }

    if (!strcmp (argv[1], "resample")) {
        int chans = atoi (argv[2]), taps = atoi (argv[3]), filters = atoi (argv[4]);
        int flags = (int) strtol (argv[5], NULL, 16);
        int mode = atoi (argv[6]);
        double src = atof (argv[7]), dst = atof (argv[8]);
        double lowpass = atof (argv[9]), ratio = atof (argv[10]);
        int block = atoi (argv[11]), nblocks = atoi (argv[12]);
        double advance = atof (argv[13]);
        if (argc > 14) lcg_state = strtoull (argv[14], NULL, 16);

        Resample *cxt = mode ?
            resampleFixedRatioInit (chans, taps, filters, src, dst, (int) lowpass, flags) :
            resampleInit (chans, taps, filters, lowpass, flags);
        if (!cxt) return 1;
        if (advance != 0.0)
            resampleAdvancePosition (cxt, advance);

        int outcap = (int) ((block + taps) * (ratio > 1 ? ratio : 1.0) *
                            (dst > src ? dst / src : 1.0)) + taps + 64;
        artsample_t *in = malloc (block * chans * sizeof (artsample_t));
        artsample_t *out = malloc (outcap * chans * sizeof (artsample_t));

        for (int b = 0; b < nblocks; ++b) {
            noise_fill (in, block * chans);
            ResampleResult res = resampleProcessInterleaved (cxt, in, block, out, outcap, ratio);
            dump_u32 (res.input_used);
            dump_u32 (res.output_generated);
            fwrite (out, sizeof (artsample_t) * chans, res.output_generated, stdout);
        }
        ResampleResult res = resampleProcessInterleaved (cxt, NULL, -1, out, outcap, ratio);
        dump_u32 (res.input_used);
        dump_u32 (res.output_generated);
        fwrite (out, sizeof (artsample_t) * chans, res.output_generated, stdout);

        /* trailing state for exact state-parity checks */
        double pos = resampleGetPosition (cxt);
        fwrite (&pos, sizeof (double), 1, stdout);
        resampleFree (cxt);
        return 0;
    }

    if (!strcmp (argv[1], "query")) {
        /* like "resample" but after each processed block dumps a sweep of
         * the DRY-RUN queries against the live context state:
         *   for i in 0..nq-1:  uint32 resampleGetRequiredSamples(1 + i*7)
         *                      uint32 resampleGetExpectedOutput(1 + i*11)
         *   then               uint32 resampleGetExpectedOutput(-1)  (flush)
         * (the queries accumulate offset += 1/ratio — a different float
         * sequence than the process loop — so they need their own golden) */
        int chans = atoi (argv[2]), taps = atoi (argv[3]), filters = atoi (argv[4]);
        int flags = (int) strtol (argv[5], NULL, 16);
        int mode = atoi (argv[6]);
        double src = atof (argv[7]), dst = atof (argv[8]);
        double lowpass = atof (argv[9]), ratio = atof (argv[10]);
        int block = atoi (argv[11]), nblocks = atoi (argv[12]);
        double advance = atof (argv[13]);
        int nq = argc > 14 ? atoi (argv[14]) : 8;

        Resample *cxt = mode ?
            resampleFixedRatioInit (chans, taps, filters, src, dst, (int) lowpass, flags) :
            resampleInit (chans, taps, filters, lowpass, flags);
        if (!cxt) return 1;
        if (advance != 0.0)
            resampleAdvancePosition (cxt, advance);

        int outcap = (int) ((block + taps) * (ratio > 1 ? ratio : 1.0) *
                            (dst > src ? dst / src : 1.0)) + taps + 64;
        artsample_t *in = malloc (block * chans * sizeof (artsample_t));
        artsample_t *out = malloc (outcap * chans * sizeof (artsample_t));

        for (int b = 0; b < nblocks; ++b) {
            noise_fill (in, block * chans);
            ResampleResult res = resampleProcessInterleaved (cxt, in, block, out, outcap, ratio);
            dump_u32 (res.input_used);
            dump_u32 (res.output_generated);
            for (int i = 0; i < nq; ++i) {
                dump_u32 (resampleGetRequiredSamples (cxt, 1 + i * 7, ratio));
                dump_u32 (resampleGetExpectedOutput (cxt, 1 + i * 11, ratio));
            }
            dump_u32 (resampleGetExpectedOutput (cxt, -1, ratio));
        }
        resampleFree (cxt);
        free (in);
        free (out);
        return 0;
    }

    if (!strcmp (argv[1], "resample_small")) {
        /* like "resample" but with a caller-chosen (small) output capacity:
         * unconsumed input is re-offered, exercising the output-limited
         * partial-consumption path.
         * args: chans taps filters flags_hex mode src dst lowpass ratio
         *       block nblocks advance outcap */
        int chans = atoi (argv[2]), taps = atoi (argv[3]), filters = atoi (argv[4]);
        int flags = (int) strtol (argv[5], NULL, 16);
        int mode = atoi (argv[6]);
        double src = atof (argv[7]), dst = atof (argv[8]);
        double lowpass = atof (argv[9]), ratio = atof (argv[10]);
        int block = atoi (argv[11]), nblocks = atoi (argv[12]);
        double advance = atof (argv[13]);
        int outcap = atoi (argv[14]);

        Resample *cxt = mode ?
            resampleFixedRatioInit (chans, taps, filters, src, dst, (int) lowpass, flags) :
            resampleInit (chans, taps, filters, lowpass, flags);
        if (!cxt) return 1;
        if (advance != 0.0)
            resampleAdvancePosition (cxt, advance);

        artsample_t *in = malloc ((block + 8) * chans * sizeof (artsample_t));
        artsample_t *out = malloc (outcap * chans * sizeof (artsample_t));
        int pending = 0;

        for (int b = 0; b < nblocks; ++b) {
            noise_fill (in + pending * chans, (block - pending) * chans);
            int avail = block;
            while (avail > 0) {
                ResampleResult res = resampleProcessInterleaved (cxt, in, avail, out, outcap, ratio);
                dump_u32 (res.input_used);
                dump_u32 (res.output_generated);
                fwrite (out, sizeof (artsample_t) * chans, res.output_generated, stdout);
                memmove (in, in + res.input_used * chans,
                         (avail - res.input_used) * chans * sizeof (artsample_t));
                avail -= res.input_used;
                if (!res.input_used && !res.output_generated) break;
            }
            pending = 0;
        }
        double pos = resampleGetPosition (cxt);
        fwrite (&pos, sizeof (double), 1, stdout);
        resampleFree (cxt);
        return 0;
    }

    if (!strcmp (argv[1], "extrap")) {
        /* extrap <mode fwd|rev> <nvalues> <n_extrap> <signal sine|noise> <freq> */
        int nvalues = atoi (argv[3]), nx = atoi (argv[4]);
        double freq = argc > 6 ? atof (argv[6]) : 0.05;
        artsample_t *buf = calloc (nvalues + nx + 4, sizeof (artsample_t));
        if (!strcmp (argv[5], "sine"))
            for (int i = 0; i < nvalues; ++i)
                buf [i] = 0.4 * sin (i * freq) + 0.1 * sin (i * freq * 3.1);
        else if (!strcmp (argv[5], "spike"))
            /* zeros + one trailing sample of amplitude <freq>: the class
               where the fl32-rounded values_rms exceeds the descent's
               double-exact trial error (extrapolator.c:95-107 vs 128-147)
               and the fit keeps a bare +/-step coefficient */
            buf [nvalues - 1] = freq;
        else
            noise_fill (buf, nvalues);

        if (!strcmp (argv[2], "rev")) {
            /* layout: [nx extrapolation area][nvalues real samples], pointer
               one past the real samples */
            artsample_t *area = calloc (nvalues + nx + 4, sizeof (artsample_t));
            for (int i = 0; i < nvalues; ++i)
                area [nx + i] = buf [i];
            extrapolate_reverse (area + nx + nvalues, nvalues, nx);
            fwrite (area, sizeof (artsample_t), nx, stdout);
        } else {
            extrapolate_forward (buf, nvalues, nx);
            fwrite (buf + nvalues, sizeof (artsample_t), nx, stdout);
        }
        return 0;
    }

    if (!strcmp (argv[1], "noise")) {
        int n = atoi (argv[2]);
        artsample_t *buf = malloc (n * sizeof (artsample_t));
        noise_fill (buf, n);
        fwrite (buf, sizeof (artsample_t), n, stdout);
        return 0;
    }

    if (!strcmp (argv[1], "decimate")) {
        int chans = atoi (argv[2]), bits = atoi (argv[3]), bytes = atoi (argv[4]);
        double gain = atof (argv[5]);
        int rate = atoi (argv[6]);
        int flags = (int) strtol (argv[7], NULL, 16);
        int nframes = atoi (argv[8]), nblocks = atoi (argv[9]);

        Decimate *cxt = decimateInit (chans, bits, bytes, gain, rate, flags);
        artsample_t *in = malloc (nframes * chans * sizeof (artsample_t));
        unsigned char *out = malloc (nframes * chans * bytes);
        unsigned int clipped = 0;

        /* first emit total clip count placeholder at the END instead: emit
         * per-block to keep streaming simple */
        for (int b = 0; b < nblocks; ++b) {
            noise_fill (in, nframes * chans);
            clipped += decimateProcessInterleavedLE (cxt, in, nframes, out);
            fwrite (out, bytes * chans, nframes, stdout);
        }
        dump_u32 (clipped);
        decimateFree (cxt);
        return 0;
    }

    if (!strcmp (argv[1], "biquad")) {
        BiquadCoefficients coeffs;
        double freq = atof (argv[3]);
        int n = atoi (argv[4]);
        if (!strcmp (argv[2], "highpass"))
            biquad_highpass (&coeffs, freq);
        else
            biquad_lowpass (&coeffs, freq);
        Biquad f1, f2;
        biquad_init (&f1, &coeffs, 1.0);
        biquad_init (&f2, &coeffs, 1.0);
        artsample_t *buf = malloc (n * sizeof (artsample_t));
        noise_fill (buf, n);
        biquad_apply_buffer (&f1, buf, n, 1);
        biquad_apply_buffer (&f2, buf, n, 1);
        fwrite (buf, sizeof (artsample_t), n, stdout);
        return 0;
    }

    return 1;
}
