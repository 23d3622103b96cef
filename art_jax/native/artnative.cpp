// artnative — host-side native runtime for ART-JAX.
//
// The accelerator owns the heavy math (resampling as matmuls); this library owns the
// strictly-sequential per-sample recurrences and byte-level packing that sit
// on the host side of the file pipeline, where Python loops are too slow and
// where bit-exact IEEE ordering matters:
//
//   * noise-shaped dithered quantization (the decimator engine's inner
//     recurrence; behavior per reference decimator.c:152-194, 370-409)
//   * biquad buffer filtering in both of the reference's summation orders
//     (reference biquad.c:78-163)
//   * 4..24-bit little-endian sample pack/unpack (reference
//     decimator.c:416-450)
//
// Build with strict IEEE flags (no -ffast-math, -ffp-contract=off): parity
// with the float32/float64 data paths depends on every product and sum
// rounding exactly once, in source order.
//
// Exposed as a plain C ABI consumed via ctypes (art_jax/native/__init__.py).

#include <cstdint>
#include <limits>
#include <cstring>
#include <cmath>
#include <vector>


// ---------------------------------------------------------------- dither

// One TPDF draw; 5 LCG steps per draw, type selects intersample correlation.
static inline double tpdf_draw(uint32_t *state, int type) {
    uint32_t g = *state;
    uint32_t r = g;
    r = ((r << 4) - r) ^ 1u;
    r = ((r << 4) - r) ^ 1u;
    uint32_t first;
    if (type < 0)       first = ~g;
    else if (type > 0)  first = g;
    else                first = ~r;
    r = ((r << 4) - r) ^ 1u;
    r = ((r << 4) - r) ^ 1u;
    r = ((r << 4) - r) ^ 1u;
    *state = r;
    return (((first >> 1) + (r >> 1)) / 2147483648.0) - 1.0;
}

// ------------------------------------------------------------- quantizer

// Interleaved shaped/dithered quantization, templated on the data path.
// in:        [n, ch] samples
// feedback:  [ch] error-feedback state
// gens:      [ch] dither LCG states (may be null -> no dither)
// a, b:      [5] decoupled-H(z) shaper coefficients (may be null -> no
//            shaping; then feedback stays constant)
// xh, yh:    [4, ch] shaper histories, newest first
// outv:      [n, ch] quantized values (pre-packing, post-clip)
// returns:   clipped-sample count
template <typename S>
static long long quantize_run_generic(const S *in, long long n, int ch,
                              S scaler,
                              S *feedback, uint32_t *gens, int dither_type,
                              const S *a, const S *b, S *xh, S *yh,
                              int32_t highclip, int32_t lowclip,
                              int32_t *outv) {
    long long clipped = 0;
    // circular history indexing (like the reference biquad's (i-k)&3,
    // reference biquad.c:78-102) instead of shifting 8 slots per sample;
    // slot (h + k) & 3 holds lag k, h starts at 0 = newest-first layout
    int h = 0;
    for (long long i = 0; i < n; ++i) {
        for (int c = 0; c < ch; ++c) {
            double dither = gens ? tpdf_draw(&gens[c], dither_type) : 0.0;
            S code = (S)(in[i * ch + c] * scaler) - feedback[c];
            // (code + dither) rounds at data-path precision, but the
            // trailing +0.5 is a double literal in the reference
            double t = (double)(S)(code + (S)dither) + 0.5;
            int32_t q = (int32_t)std::floor(t);
            if (a) {
                S err = (S)((S)q - code);
                S s = (S)(err * a[0]);
                s = (S)(s + (S)((S)(xh[((h + 3) & 3) * ch + c] * a[4]) -
                                (S)(b[4] * yh[((h + 3) & 3) * ch + c])));
                s = (S)(s + (S)((S)(xh[((h + 2) & 3) * ch + c] * a[3]) -
                                (S)(b[3] * yh[((h + 2) & 3) * ch + c])));
                s = (S)(s + (S)((S)(xh[((h + 1) & 3) * ch + c] * a[2]) -
                                (S)(b[2] * yh[((h + 1) & 3) * ch + c])));
                s = (S)(s + (S)((S)(xh[h * ch + c] * a[1]) -
                                (S)(b[1] * yh[h * ch + c])));
                xh[((h + 3) & 3) * ch + c] = err;
                yh[((h + 3) & 3) * ch + c] = s;
                feedback[c] = s;
            }
            if (q > highclip) { q = highclip; ++clipped; }
            else if (q < lowclip) { q = lowclip; ++clipped; }
            outv[i * ch + c] = q;
        }
        if (a) h = (h + 3) & 3;    // the just-written slot becomes lag 0
    }
    // rotate histories back to the newest-first layout the caller persists
    if (a && h) {
        S tx[4], ty[4];
        for (int c = 0; c < ch; ++c) {
            for (int k = 0; k < 4; ++k) {
                tx[k] = xh[((h + k) & 3) * ch + c];
                ty[k] = yh[((h + k) & 3) * ch + c];
            }
            for (int k = 0; k < 4; ++k) {
                xh[k * ch + c] = tx[k];
                yh[k * ch + c] = ty[k];
            }
        }
    }
    return clipped;
}

// Register-resident specialization for small channel counts (CH known at
// compile time, dither/shaping presence as template flags): all recurrence
// state lives in locals, the arithmetic order is identical to the generic
// loop above, so outputs stay bit-exact.
template <typename S, int CH, bool DITHER, bool SHAPE>
static long long quantize_run_smallch(const S *in, long long n, S scaler,
                              S *feedback, uint32_t *gens, int dither_type,
                              const S *a, const S *b, S *xh, S *yh,
                              int32_t highclip, int32_t lowclip,
                              int32_t *outv) {
    long long clipped = 0;
    uint32_t g[CH];
    S fb[CH], x1[CH], x2[CH], x3[CH], x4[CH], y1[CH], y2[CH], y3[CH], y4[CH];
    S a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0, b1 = 0, b2 = 0, b3 = 0, b4 = 0;
    if (SHAPE) {
        a0 = a[0]; a1 = a[1]; a2 = a[2]; a3 = a[3]; a4 = a[4];
        b1 = b[1]; b2 = b[2]; b3 = b[3]; b4 = b[4];
    }
    for (int c = 0; c < CH; ++c) {
        if (DITHER) g[c] = gens[c];
        fb[c] = feedback[c];
        if (SHAPE) {
            // caller layout is newest-first: slot k = lag k+1; x4 is the
            // newest (lag 1), x1 the oldest (lag 4)
            x4[c] = xh[0 * CH + c]; x3[c] = xh[1 * CH + c];
            x2[c] = xh[2 * CH + c]; x1[c] = xh[3 * CH + c];
            y4[c] = yh[0 * CH + c]; y3[c] = yh[1 * CH + c];
            y2[c] = yh[2 * CH + c]; y1[c] = yh[3 * CH + c];
        }
    }
    for (long long i = 0; i < n; ++i) {
        for (int c = 0; c < CH; ++c) {
            double dither = DITHER ? tpdf_draw(&g[c], dither_type) : 0.0;
            S code = (S)(in[i * CH + c] * scaler) - fb[c];
            double t = (double)(S)(code + (S)dither) + 0.5;
            int32_t q = (int32_t)std::floor(t);
            if (SHAPE) {
                S err = (S)((S)q - code);
                S s = (S)(err * a0);
                s = (S)(s + (S)((S)(x1[c] * a4) - (S)(b4 * y1[c])));
                s = (S)(s + (S)((S)(x2[c] * a3) - (S)(b3 * y2[c])));
                s = (S)(s + (S)((S)(x3[c] * a2) - (S)(b2 * y3[c])));
                s = (S)(s + (S)((S)(x4[c] * a1) - (S)(b1 * y4[c])));
                x1[c] = x2[c]; x2[c] = x3[c]; x3[c] = x4[c]; x4[c] = err;
                y1[c] = y2[c]; y2[c] = y3[c]; y3[c] = y4[c]; y4[c] = s;
                fb[c] = s;
            }
            if (q > highclip) { q = highclip; ++clipped; }
            else if (q < lowclip) { q = lowclip; ++clipped; }
            outv[i * CH + c] = q;
        }
    }
    for (int c = 0; c < CH; ++c) {
        if (DITHER) gens[c] = g[c];
        feedback[c] = fb[c];
        if (SHAPE) {
            // newest-first layout the caller persists: slot k = lag k
            xh[0 * CH + c] = x4[c]; xh[1 * CH + c] = x3[c];
            xh[2 * CH + c] = x2[c]; xh[3 * CH + c] = x1[c];
            yh[0 * CH + c] = y4[c]; yh[1 * CH + c] = y3[c];
            yh[2 * CH + c] = y2[c]; yh[3 * CH + c] = y1[c];
        }
    }
    return clipped;
}

template <typename S, int CH>
static long long quantize_run_ch(const S *in, long long n, S scaler,
                              S *feedback, uint32_t *gens, int dither_type,
                              const S *a, const S *b, S *xh, S *yh,
                              int32_t highclip, int32_t lowclip,
                              int32_t *outv) {
    if (gens && a)
        return quantize_run_smallch<S, CH, true, true>(
            in, n, scaler, feedback, gens, dither_type, a, b, xh, yh,
            highclip, lowclip, outv);
    if (gens)
        return quantize_run_smallch<S, CH, true, false>(
            in, n, scaler, feedback, gens, dither_type, a, b, xh, yh,
            highclip, lowclip, outv);
    if (a)
        return quantize_run_smallch<S, CH, false, true>(
            in, n, scaler, feedback, gens, dither_type, a, b, xh, yh,
            highclip, lowclip, outv);
    return quantize_run_smallch<S, CH, false, false>(
        in, n, scaler, feedback, gens, dither_type, a, b, xh, yh,
        highclip, lowclip, outv);
}

template <typename S>
static long long quantize_run(const S *in, long long n, int ch, S scaler,
                              S *feedback, uint32_t *gens, int dither_type,
                              const S *a, const S *b, S *xh, S *yh,
                              int32_t highclip, int32_t lowclip,
                              int32_t *outv) {
    switch (ch) {
    case 1: return quantize_run_ch<S, 1>(in, n, scaler, feedback, gens,
                        dither_type, a, b, xh, yh, highclip, lowclip, outv);
    case 2: return quantize_run_ch<S, 2>(in, n, scaler, feedback, gens,
                        dither_type, a, b, xh, yh, highclip, lowclip, outv);
    case 6: return quantize_run_ch<S, 6>(in, n, scaler, feedback, gens,
                        dither_type, a, b, xh, yh, highclip, lowclip, outv);
    default:
        return quantize_run_generic(in, n, ch, scaler, feedback, gens,
                        dither_type, a, b, xh, yh, highclip, lowclip, outv);
    }
}

// Fused quantize + little-endian pack: one pass over the samples, like the
// reference's decimateProcessLE loop (reference decimator.c:152-194), so the
// intermediate int32 values never round-trip through memory.
template <typename S, int CH, bool DITHER, bool SHAPE>
static long long quantize_pack_smallch(const S *in, long long n, S scaler,
                              S *feedback, uint32_t *gens, int dither_type,
                              const S *a, const S *b, S *xh, S *yh,
                              int32_t highclip, int32_t lowclip,
                              int output_bits, int output_bytes,
                              uint8_t *out) {
    long long clipped = 0;
    const int pre = output_bytes - ((output_bits + 7) / 8);
    const int shift = (24 - output_bits) % 8;
    const int32_t offset = (output_bits <= 8) ? 128 : 0;
    uint32_t g[CH];
    S fb[CH], x1[CH], x2[CH], x3[CH], x4[CH], y1[CH], y2[CH], y3[CH], y4[CH];
    S a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0, b1 = 0, b2 = 0, b3 = 0, b4 = 0;
    if (SHAPE) {
        a0 = a[0]; a1 = a[1]; a2 = a[2]; a3 = a[3]; a4 = a[4];
        b1 = b[1]; b2 = b[2]; b3 = b[3]; b4 = b[4];
    }
    for (int c = 0; c < CH; ++c) {
        if (DITHER) g[c] = gens[c];
        fb[c] = feedback[c];
        if (SHAPE) {
            x4[c] = xh[0 * CH + c]; x3[c] = xh[1 * CH + c];
            x2[c] = xh[2 * CH + c]; x1[c] = xh[3 * CH + c];
            y4[c] = yh[0 * CH + c]; y3[c] = yh[1 * CH + c];
            y2[c] = yh[2 * CH + c]; y1[c] = yh[3 * CH + c];
        }
    }
    uint8_t *p = out;
    for (long long i = 0; i < n; ++i) {
        for (int c = 0; c < CH; ++c) {
            double dither = DITHER ? tpdf_draw(&g[c], dither_type) : 0.0;
            S code = (S)(in[i * CH + c] * scaler) - fb[c];
            double t = (double)(S)(code + (S)dither) + 0.5;
            int32_t q = (int32_t)std::floor(t);
            if (SHAPE) {
                S err = (S)((S)q - code);
                S s = (S)(err * a0);
                s = (S)(s + (S)((S)(x1[c] * a4) - (S)(b4 * y1[c])));
                s = (S)(s + (S)((S)(x2[c] * a3) - (S)(b3 * y2[c])));
                s = (S)(s + (S)((S)(x3[c] * a2) - (S)(b2 * y3[c])));
                s = (S)(s + (S)((S)(x4[c] * a1) - (S)(b1 * y4[c])));
                x1[c] = x2[c]; x2[c] = x3[c]; x3[c] = x4[c]; x4[c] = err;
                y1[c] = y2[c]; y2[c] = y3[c]; y3[c] = y4[c]; y4[c] = s;
                fb[c] = s;
            }
            if (q > highclip) { q = highclip; ++clipped; }
            else if (q < lowclip) { q = lowclip; ++clipped; }
            for (int j = 0; j < pre; ++j) *p++ = 0;
            uint32_t v = ((uint32_t)q << shift) + (uint32_t)offset;
            *p++ = (uint8_t)v;
            if (output_bits > 8) {
                *p++ = (uint8_t)(v >> 8);
                if (output_bits > 16)
                    *p++ = (uint8_t)(v >> 16);
            }
        }
    }
    for (int c = 0; c < CH; ++c) {
        if (DITHER) gens[c] = g[c];
        feedback[c] = fb[c];
        if (SHAPE) {
            xh[0 * CH + c] = x4[c]; xh[1 * CH + c] = x3[c];
            xh[2 * CH + c] = x2[c]; xh[3 * CH + c] = x1[c];
            yh[0 * CH + c] = y4[c]; yh[1 * CH + c] = y3[c];
            yh[2 * CH + c] = y2[c]; yh[3 * CH + c] = y1[c];
        }
    }
    return clipped;
}

template <typename S, int CH>
static long long quantize_pack_ch(const S *in, long long n, S scaler,
                              S *feedback, uint32_t *gens, int dither_type,
                              const S *a, const S *b, S *xh, S *yh,
                              int32_t highclip, int32_t lowclip,
                              int obits, int obytes, uint8_t *out) {
    if (gens && a)
        return quantize_pack_smallch<S, CH, true, true>(in, n, scaler,
            feedback, gens, dither_type, a, b, xh, yh, highclip, lowclip,
            obits, obytes, out);
    if (gens)
        return quantize_pack_smallch<S, CH, true, false>(in, n, scaler,
            feedback, gens, dither_type, a, b, xh, yh, highclip, lowclip,
            obits, obytes, out);
    if (a)
        return quantize_pack_smallch<S, CH, false, true>(in, n, scaler,
            feedback, gens, dither_type, a, b, xh, yh, highclip, lowclip,
            obits, obytes, out);
    return quantize_pack_smallch<S, CH, false, false>(in, n, scaler,
        feedback, gens, dither_type, a, b, xh, yh, highclip, lowclip,
        obits, obytes, out);
}

template <typename S>
static long long quantize_pack(const S *in, long long n, int ch, S scaler,
                              S *feedback, uint32_t *gens, int dither_type,
                              const S *a, const S *b, S *xh, S *yh,
                              int32_t highclip, int32_t lowclip,
                              int obits, int obytes, uint8_t *out) {
    switch (ch) {
    case 1: return quantize_pack_ch<S, 1>(in, n, scaler, feedback, gens,
                dither_type, a, b, xh, yh, highclip, lowclip, obits, obytes,
                out);
    case 2: return quantize_pack_ch<S, 2>(in, n, scaler, feedback, gens,
                dither_type, a, b, xh, yh, highclip, lowclip, obits, obytes,
                out);
    case 6: return quantize_pack_ch<S, 6>(in, n, scaler, feedback, gens,
                dither_type, a, b, xh, yh, highclip, lowclip, obits, obytes,
                out);
    }
    return -1;      // caller falls back to quantize + pack_le
}

extern "C" long long art_quantize_pack_f32(const float *in, long long n,
                           int ch, float scaler, float *feedback,
                           uint32_t *gens, int dither_type, const float *a,
                           const float *b, float *xh, float *yh,
                           int32_t highclip, int32_t lowclip, int obits,
                           int obytes, uint8_t *out) {
    return quantize_pack<float>(in, n, ch, scaler, feedback, gens,
                                dither_type, a, b, xh, yh, highclip,
                                lowclip, obits, obytes, out);
}

extern "C" long long art_quantize_pack_f64(const double *in, long long n,
                           int ch, double scaler, double *feedback,
                           uint32_t *gens, int dither_type, const double *a,
                           const double *b, double *xh, double *yh,
                           int32_t highclip, int32_t lowclip, int obits,
                           int obytes, uint8_t *out) {
    return quantize_pack<double>(in, n, ch, scaler, feedback, gens,
                                 dither_type, a, b, xh, yh, highclip,
                                 lowclip, obits, obytes, out);
}

extern "C" long long art_quantize_f32(const float *in, long long n, int ch,
                           float scaler, float *feedback, uint32_t *gens,
                           int dither_type, const float *a, const float *b,
                           float *xh, float *yh, int32_t highclip,
                           int32_t lowclip, int32_t *outv) {
    return quantize_run<float>(in, n, ch, scaler, feedback, gens,
                               dither_type, a, b, xh, yh, highclip, lowclip,
                               outv);
}

extern "C" long long art_quantize_f64(const double *in, long long n, int ch,
                           double scaler, double *feedback, uint32_t *gens,
                           int dither_type, const double *a, const double *b,
                           double *xh, double *yh, int32_t highclip,
                           int32_t lowclip, int32_t *outv) {
    return quantize_run<double>(in, n, ch, scaler, feedback, gens,
                                dither_type, a, b, xh, yh, highclip, lowclip,
                                outv);
}

// ------------------------------------------------------- stretch search

// TDHS period search: maximize sum(|x|) / sum(|diff|) over candidate
// periods with the exact float accumulation orders of the reference
// (reference stretch.c:417-457): the running |x| sum chains pair values,
// each candidate's |diff| accumulates top-down, and the compare happens at
// data-path precision.  Mirrors engines/stretch.Stretcher._search.
template <typename S>
static int stretch_search(const S *calc, int shortest, int longest,
                          S *record, S *best_factor_out) {
    S s = 0;
    for (int i = 0; i < shortest; ++i) {
        S pair = (S)(std::fabs((double)calc[i])
                     + std::fabs((double)calc[i + shortest]));
        s = (S)(s + pair);
    }
    int best_period = shortest;
    S best_factor = (S)-1.0;
    for (int period = shortest; period <= longest; ++period) {
        S diff = 0;
        for (int i = period - 1; i >= 0; --i) {
            S d = (S)std::fabs((double)calc[i] - (double)calc[i + period]);
            diff = (S)(diff + d);
        }
        // FLT_MAX regardless of data width (reference stretch.c:441)
        S factor = diff == (S)0.0 ? (S)std::numeric_limits<float>::max()
                                  : (S)(s / diff);
        if (record) record[period] = factor;
        if (factor >= best_factor) {
            best_factor = factor;
            best_period = period;
        }
        if (period < longest) {
            S inc = (S)(std::fabs((double)calc[2 * period])
                        + std::fabs((double)calc[2 * period + 1]));
            s = (S)(s + inc);
        }
    }
    if (best_factor_out) *best_factor_out = best_factor;
    return best_period;
}

// Lane-per-candidate vectorized search: W consecutive candidate periods
// accumulate in W independent lanes, each lane running ITS candidate's
// exact sequential top-down order — so SIMD here is value-preserving
// (unlike the stock reference build, whose -fassociative-math vectorizes
// the reduction *within* a candidate and changes its own results).  The
// compare-and-update still walks candidates in ascending period order at
// data-path precision.  ~W x the scalar search; the last partial group
// falls back to the scalar path (also keeps every vector load in bounds:
// full groups read at most calc[2*longest - W]).
template <typename S, int W>
static int stretch_search_lanes(const S *calc, int shortest, int longest,
                                S *record, S *best_factor_out) {
    if (longest - shortest + 1 < 2 * W)
        return stretch_search<S>(calc, shortest, longest, record,
                                 best_factor_out);
    // running |x| sum per candidate: strictly serial chain as in the
    // reference (stretch.c:417-457), O(longest)
    std::vector<S> chain((size_t)longest + 1);
    S s = 0;
    for (int i = 0; i < shortest; ++i) {
        S pair = (S)(std::fabs((double)calc[i])
                     + std::fabs((double)calc[i + shortest]));
        s = (S)(s + pair);
    }
    chain[shortest] = s;
    for (int period = shortest; period < longest; ++period) {
        S inc = (S)(std::fabs((double)calc[2 * period])
                    + std::fabs((double)calc[2 * period + 1]));
        s = (S)(s + inc);
        chain[period + 1] = s;
    }

    int best_period = shortest;
    S best_factor = (S)-1.0;
    int P = shortest;
    for (; P + W - 1 <= longest; P += W) {
        S acc[W];
        for (int w = 0; w < W; ++w) acc[w] = 0;
        // ramp: lane w's first w terms (i from P+w-1 down to P), scalar
        for (int w = 1; w < W; ++w)
            for (int i = P + w - 1; i >= P; --i) {
                S d = (S)(calc[i] - calc[i + P + w]);
                acc[w] = (S)(acc[w] + (d < 0 ? (S)-d : d));
            }
        // common phase: all W lanes, fixed trip count (autovectorizes;
        // independent per-lane accumulators, no reassociation anywhere)
        for (int i = P - 1; i >= 0; --i) {
            S x = calc[i];
            const S *q = calc + i + P;
            for (int w = 0; w < W; ++w) {
                S d = (S)(x - q[w]);
                acc[w] = (S)(acc[w] + (d < 0 ? (S)-d : d));
            }
        }
        for (int w = 0; w < W; ++w) {
            S factor = acc[w] == (S)0.0
                ? (S)std::numeric_limits<float>::max()
                : (S)(chain[P + w] / acc[w]);
            if (record) record[P + w] = factor;
            if (factor >= best_factor) {
                best_factor = factor;
                best_period = P + w;
            }
        }
    }
    // scalar tail for the last partial group
    for (; P <= longest; ++P) {
        S diff = 0;
        for (int i = P - 1; i >= 0; --i) {
            S d = (S)(calc[i] - calc[i + P]);
            diff = (S)(diff + (d < 0 ? (S)-d : d));
        }
        S factor = diff == (S)0.0 ? (S)std::numeric_limits<float>::max()
                                  : (S)(chain[P] / diff);
        if (record) record[P] = factor;
        if (factor >= best_factor) {
            best_factor = factor;
            best_period = P;
        }
    }
    if (best_factor_out) *best_factor_out = best_factor;
    return best_period;
}

#ifdef __AVX2__
#include <immintrin.h>

// Hand-vectorized f32 search: 16 candidate lanes per group in two ymm
// accumulators.  Same value-exact lane-per-candidate scheme as
// stretch_search_lanes (ramp terms first, then the shared descending-i
// phase); |a-b| as an AND with the sign mask is the IEEE fabsf.
static int stretch_search_avx2_f32(const float *calc, int shortest,
                                   int longest, float *record,
                                   float *best_factor_out) {
    constexpr int W = 16;
    if (longest - shortest + 1 < 2 * W)
        return stretch_search<float>(calc, shortest, longest, record,
                                     best_factor_out);
    std::vector<float> chain((size_t)longest + 1);
    float s = 0;
    for (int i = 0; i < shortest; ++i)
        s += std::fabs(calc[i]) + std::fabs(calc[i + shortest]);
    chain[shortest] = s;
    for (int period = shortest; period < longest; ++period) {
        s += std::fabs(calc[2 * period]) + std::fabs(calc[2 * period + 1]);
        chain[period + 1] = s;
    }

    const __m256 signmask =
        _mm256_castsi256_ps(_mm256_set1_epi32(0x7fffffff));
    int best_period = shortest;
    float best_factor = -1.0f;
    int P = shortest;
    for (; P + W - 1 <= longest; P += W) {
        alignas(32) float r[W] = {0};
        for (int w = 1; w < W; ++w)
            for (int i = P + w - 1; i >= P; --i)
                r[w] += std::fabs(calc[i] - calc[i + P + w]);
        __m256 acc0 = _mm256_load_ps(r);
        __m256 acc1 = _mm256_load_ps(r + 8);
        for (int i = P - 1; i >= 0; --i) {
            __m256 x = _mm256_broadcast_ss(calc + i);
            __m256 q0 = _mm256_loadu_ps(calc + i + P);
            __m256 q1 = _mm256_loadu_ps(calc + i + P + 8);
            acc0 = _mm256_add_ps(
                acc0, _mm256_and_ps(_mm256_sub_ps(x, q0), signmask));
            acc1 = _mm256_add_ps(
                acc1, _mm256_and_ps(_mm256_sub_ps(x, q1), signmask));
        }
        _mm256_store_ps(r, acc0);
        _mm256_store_ps(r + 8, acc1);
        for (int w = 0; w < W; ++w) {
            float factor = r[w] == 0.0f
                ? std::numeric_limits<float>::max()
                : chain[P + w] / r[w];
            if (record) record[P + w] = factor;
            if (factor >= best_factor) {
                best_factor = factor;
                best_period = P + w;
            }
        }
    }
    for (; P <= longest; ++P) {
        float diff = 0;
        for (int i = P - 1; i >= 0; --i)
            diff += std::fabs(calc[i] - calc[i + P]);
        float factor = diff == 0.0f ? std::numeric_limits<float>::max()
                                    : chain[P] / diff;
        if (record) record[P] = factor;
        if (factor >= best_factor) {
            best_factor = factor;
            best_period = P;
        }
    }
    if (best_factor_out) *best_factor_out = best_factor;
    return best_period;
}
#endif  // __AVX2__

template <typename S>
static int search_dispatch(const S *calc, int shortest, int longest,
                           S *record, S *best_factor);

template <>
int search_dispatch<float>(const float *calc, int shortest, int longest,
                           float *record, float *best_factor) {
#ifdef __AVX2__
    return stretch_search_avx2_f32(calc, shortest, longest, record,
                                   best_factor);
#else
    return stretch_search_lanes<float, 8>(calc, shortest, longest, record,
                                          best_factor);
#endif
}

template <>
int search_dispatch<double>(const double *calc, int shortest, int longest,
                            double *record, double *best_factor) {
    return stretch_search_lanes<double, 8>(calc, shortest, longest, record,
                                           best_factor);
}

// ------------------------------------------------- stretch block pipeline
//
// The TDHS steady-state block loop (behavioral port of the Python engine
// engines/stretch.Stretcher._process_block; reference stretch.c:161-326):
// per block, detect the pitch period (mono mix -> lane search -> fast-mode
// neighbor refinement), pick the half-step process ratio steered by the
// running output-count error, and emit the 2:1 / 1:1 / 2:3 / 1:2 transform
// with linear crossfades.  Per-block Python overhead (~1 ms) dominated the
// engine once the search was vectorized; this loop runs every block of a
// buffered region in one call.

template <typename S>
static void merge_into(const S *in1, const S *in2, long long n, S *out) {
    // linear crossfade, each product/sum rounded once in source order
    // (reference merge_blocks, stretch.c:560-566)
    for (long long i = 0; i < n; ++i) {
        S p1 = (S)(in1[i] * (S)(n - i));
        S p2 = (S)(in2[i] * (S)i);
        out[i] = (S)((S)(p1 + p2) / (S)n);
    }
}

template <typename S>
static long long stretch_run(S *inbuff, long long head, long long *tail_io,
                             long long longest, long long shortest,
                             int num_chans, int fast_mode, double ratio,
                             double *error_io, S *out, S *calc, S *results) {
    long long tail = *tail_io;
    double err = *error_io;
    long long outn = 0;
    long long min_buffered = longest * (fast_mode ? 3 : 2);

    while (head - tail >= min_buffered && tail >= longest) {
        long long period;
        if (ratio != 1.0 || err != 0.0) {
            // ---- pitch detection on inbuff[tail : tail + 2*longest]
            const S *src = inbuff + tail;
            long long decim = fast_mode ? 2 : 1;
            long long n_mono = 2 * longest / (num_chans * decim);
            if (!fast_mode) {
                if (num_chans == 2)
                    for (long long j = 0; j < n_mono; ++j)
                        calc[j] = (S)((S)(src[2 * j] + src[2 * j + 1])
                                      / (S)2.0);
                else
                    std::memcpy(calc, src, n_mono * sizeof(S));
            } else if (num_chans == 2) {
                for (long long j = 0; j < n_mono; ++j) {
                    const S *g = src + 4 * j;
                    S t = (S)((S)(g[0] + g[1]) + g[2]);
                    calc[j] = (S)((S)(t + g[3]) / (S)2.0);
                }
            } else {
                for (long long j = 0; j < n_mono; ++j)
                    calc[j] = (S)((S)(src[2 * j] + src[2 * j + 1])
                                  / (S)2.0);
            }
            bool any = false;
            for (long long j = 0; j < n_mono; ++j)
                if (calc[j] != (S)0.0) { any = true; break; }
            if (!any) {
                period = longest;
            } else {
                int sh = (int)(shortest / (num_chans * decim));
                int lo = (int)(longest / (num_chans * decim));
                S bf;
                int bp = search_dispatch<S>(calc, sh, lo,
                                            fast_mode ? results : nullptr,
                                            &bf);
                if (fast_mode) {
                    // neighbor refinement at factor e asymmetry
                    // (engine _find_period_fast; reference stretch.c:536-546)
                    if (bp != sh && bp != lo) {
                        // side diffs round at data-path precision before
                        // the double compare (matches the engine's numpy)
                        S hs = (S)(results[bp] - results[bp + 1]);
                        S ls = (S)(results[bp] - results[bp - 1]);
                        if ((double)ls > (double)hs * 2.718281828459045235)
                            bp = bp * 2 + 1;
                        else if ((double)hs
                                 > (double)ls * 2.718281828459045235)
                            bp = bp * 2 - 1;
                        else
                            bp *= 2;
                    } else {
                        bp *= 2;
                    }
                }
                period = (long long)bp * num_chans;
            }
        } else {
            period = longest;
        }

        double process_ratio;
        if (err == 0.0)
            process_ratio = std::floor(ratio * 2.0 + 0.5) / 2.0;
        else if (err > 0.0)
            process_ratio = std::floor(ratio * 2.0) / 2.0;
        else
            process_ratio = std::ceil(ratio * 2.0) / 2.0;

        S *t = inbuff + tail;
        if (process_ratio == 0.5) {
            merge_into(t, t + period, period, out + outn);
            outn += period;
            err += (double)period - (double)period * 2.0 * ratio;
            tail += 2 * period;
        } else if (process_ratio == 1.0) {
            std::memcpy(out + outn, t, 2 * period * sizeof(S));
            outn += 2 * period;
            if (ratio != 1.0)
                err += (double)period * 2.0 - (double)period * 2.0 * ratio;
            else
                err = 0.0;
            tail += 2 * period;
        } else if (process_ratio == 1.5) {
            std::memcpy(out + outn, t, period * sizeof(S));
            merge_into(t + period, t, period, out + outn + period);
            std::memcpy(out + outn + 2 * period, t + period,
                        period * sizeof(S));
            outn += 3 * period;
            err += (double)period * 3.0 - (double)period * 2.0 * ratio;
            tail += 2 * period;
        } else {  // 2.0
            merge_into(t, t - period, 2 * period, out + outn);
            outn += 2 * period;
            err += (double)period * 2.0 - (double)period * ratio;
            tail += period;
            if (fast_mode) {
                t = inbuff + tail;
                merge_into(t, t - period, 2 * period, out + outn);
                outn += 2 * period;
                err += (double)period * 2.0 - (double)period * ratio;
                tail += period;
            }
        }
    }
    *tail_io = tail;
    *error_io = err;
    return outn;
}

extern "C" long long art_stretch_run_f32(
        float *inbuff, long long head, long long *tail_io,
        long long longest, long long shortest, int num_chans,
        int fast_mode, double ratio, double *error_io, float *out,
        float *calc, float *results) {
    return stretch_run<float>(inbuff, head, tail_io, longest, shortest,
                              num_chans, fast_mode, ratio, error_io, out,
                              calc, results);
}

extern "C" long long art_stretch_run_f64(
        double *inbuff, long long head, long long *tail_io,
        long long longest, long long shortest, int num_chans,
        int fast_mode, double ratio, double *error_io, double *out,
        double *calc, double *results) {
    return stretch_run<double>(inbuff, head, tail_io, longest, shortest,
                               num_chans, fast_mode, ratio, error_io, out,
                               calc, results);
}

extern "C" int art_stretch_search_f32(const float *calc, int shortest,
                                      int longest, float *record,
                                      float *best_factor) {
    return search_dispatch<float>(calc, shortest, longest, record,
                                  best_factor);
}

extern "C" int art_stretch_search_f64(const double *calc, int shortest,
                                      int longest, double *record,
                                      double *best_factor) {
    return stretch_search_lanes<double, 8>(calc, shortest, longest, record,
                                           best_factor);
}

// --------------------------------------------------------------- biquads

// Buffer-order biquad over an interleaved [n, ch] buffer, in place.
// Summation order is the reference's buffer loop: newest term first,
// alternating +feedforward/-feedback (reference biquad.c:106-163).
template <typename S>
static void biquad_buffer_run(S *buf, long long n, int ch, const S *a,
                              const S *b, S *xh, S *yh) {
    for (long long i = 0; i < n; ++i) {
        for (int c = 0; c < ch; ++c) {
            S x = buf[i * ch + c];
            S s = (S)(x * a[0]);
            s = (S)(s + (S)(xh[0 * ch + c] * a[1]));
            s = (S)(s - (S)(b[1] * yh[0 * ch + c]));
            s = (S)(s + (S)(xh[1 * ch + c] * a[2]));
            s = (S)(s - (S)(b[2] * yh[1 * ch + c]));
            s = (S)(s + (S)(xh[2 * ch + c] * a[3]));
            s = (S)(s - (S)(b[3] * yh[2 * ch + c]));
            s = (S)(s + (S)(xh[3 * ch + c] * a[4]));
            s = (S)(s - (S)(b[4] * yh[3 * ch + c]));
            for (int k = 3; k > 0; --k) {
                xh[k * ch + c] = xh[(k - 1) * ch + c];
                yh[k * ch + c] = yh[(k - 1) * ch + c];
            }
            xh[c] = x;
            yh[c] = s;
            buf[i * ch + c] = s;
        }
    }
}

extern "C" void art_biquad_buffer_f32(float *buf, long long n, int ch, const float *a,
                           const float *b, float *xh, float *yh) {
    biquad_buffer_run<float>(buf, n, ch, a, b, xh, yh);
}

extern "C" void art_biquad_buffer_f64(double *buf, long long n, int ch, const double *a,
                           const double *b, double *xh, double *yh) {
    biquad_buffer_run<double>(buf, n, ch, a, b, xh, yh);
}

// Fused biquad cascade over an interleaved [n, ch] buffer, in place.
// `nstages` buffer-order biquads applied in sequence per sample; stage s+1
// consumes only the finalized stage-s output of the same sample, so the
// values are bit-identical to nstages separate whole-buffer passes
// (reference art.c:1011-1017 applies its two cascaded lowpass biquads as
// back-to-back biquad_apply_buffer passes) while the buffer is read and
// written once instead of nstages times.  a/b are [nstages, 5], xh/yh are
// [nstages, 4, ch].
template <typename S>
static void biquad_cascade_run(S *buf, long long n, int ch, int nstages,
                               const S *a, const S *b, S *xh, S *yh) {
    for (long long i = 0; i < n; ++i) {
        for (int c = 0; c < ch; ++c) {
            S v = buf[i * ch + c];
            for (int st = 0; st < nstages; ++st) {
                const S *as = a + (long long)st * 5;
                const S *bs = b + (long long)st * 5;
                S *xs = xh + (long long)st * 4 * ch;
                S *ys = yh + (long long)st * 4 * ch;
                S x = v;
                S s = (S)(x * as[0]);
                s = (S)(s + (S)(xs[0 * ch + c] * as[1]));
                s = (S)(s - (S)(bs[1] * ys[0 * ch + c]));
                s = (S)(s + (S)(xs[1 * ch + c] * as[2]));
                s = (S)(s - (S)(bs[2] * ys[1 * ch + c]));
                s = (S)(s + (S)(xs[2 * ch + c] * as[3]));
                s = (S)(s - (S)(bs[3] * ys[2 * ch + c]));
                s = (S)(s + (S)(xs[3 * ch + c] * as[4]));
                s = (S)(s - (S)(bs[4] * ys[3 * ch + c]));
                for (int k = 3; k > 0; --k) {
                    xs[k * ch + c] = xs[(k - 1) * ch + c];
                    ys[k * ch + c] = ys[(k - 1) * ch + c];
                }
                xs[c] = x;
                ys[c] = s;
                v = s;
            }
            buf[i * ch + c] = v;
        }
    }
}

extern "C" void art_biquad_cascade_f32(float *buf, long long n, int ch,
                                       int nstages, const float *a,
                                       const float *b, float *xh, float *yh) {
    biquad_cascade_run<float>(buf, n, ch, nstages, a, b, xh, yh);
}

extern "C" void art_biquad_cascade_f64(double *buf, long long n, int ch,
                                       int nstages, const double *a,
                                       const double *b, double *xh, double *yh) {
    biquad_cascade_run<double>(buf, n, ch, nstages, a, b, xh, yh);
}

// ------------------------------------------------------------ byte pack

// Quantized int32 values -> little-endian packed bytes with pre-zero pad.
extern "C" void art_pack_le(const int32_t *vals, long long count, int output_bits,
                 int output_bytes, uint8_t *out) {
    int pre = output_bytes - ((output_bits + 7) / 8);
    int shift = (24 - output_bits) % 8;
    int32_t offset = (output_bits <= 8) ? 128 : 0;
    for (long long i = 0; i < count; ++i) {
        uint8_t *p = out + i * output_bytes;
        for (int j = 0; j < pre; ++j) *p++ = 0;
        uint32_t v = ((uint32_t)vals[i] << shift) + (uint32_t)offset;
        *p++ = (uint8_t)v;
        if (output_bits > 8) {
            *p++ = (uint8_t)(v >> 8);
            if (output_bits > 16)
                *p++ = (uint8_t)(v >> 16);
        }
    }
}

// Packed little-endian bytes -> float samples with gain, 4..24 bits.
template <typename S>
static void unpack_run(const uint8_t *in, double gain, int bits, int bytes,
                       S *out, long long count) {
    int skip = bytes - ((bits + 7) / 8);
    if (bits <= 8) {
        S gf = (S)(gain / 128.0);
        for (long long i = 0; i < count; ++i)
            out[i] = (S)(((int)in[i * bytes + skip] - 128) * gf);
    } else if (bits <= 16) {
        S gf = (S)(gain / 32768.0);
        for (long long i = 0; i < count; ++i) {
            const uint8_t *p = in + i * bytes + skip;
            int16_t v = (int16_t)(p[0] | (p[1] << 8));
            out[i] = (S)(v * gf);
        }
    } else {
        S gf = (S)(gain / 8388608.0);
        for (long long i = 0; i < count; ++i) {
            const uint8_t *p = in + i * bytes + skip;
            int32_t v = (int32_t)(p[0] | (p[1] << 8) |
                                  ((uint32_t)(int8_t)p[2] << 16));
            out[i] = (S)(v * gf);
        }
    }
}

extern "C" void art_unpack_le_f32(const uint8_t *in, double gain, int bits, int bytes,
                       float *out, long long count) {
    unpack_run<float>(in, gain, bits, bytes, out, count);
}

extern "C" void art_unpack_le_f64(const uint8_t *in, double gain, int bits, int bytes,
                       double *out, long long count) {
    unpack_run<double>(in, gain, bits, bytes, out, count);
}



// ---------------------------------------------------------------- extrapolator

// LPC endpoint extrapolation (behavioral contract: reference
// extrapolator.c:22-283 — 4-coefficient coordinate-descent fit with
// halving step, PARCOR stability clamp, delta/zero-filter fallbacks).
// Bit-exact mirror of the host numpy path (engines/extrapolator.py):
// float32 coefficient products on the f32 data path, strict left-to-right
// float64 accumulation everywhere.  This is the flush/prefill latency
// path: the descent runs up to 100k trials over <= 16*taps samples, which
// costs 10-300 ms per channel in numpy but sub-ms here.

// one coefficient*sample product, rounded the way the data path rounds
template <typename S>
static inline double extrap_prod(float c, S v);
template <>
inline double extrap_prod<float>(float c, float v) {
    return (double)(c * v);            // f32 product, then widen
}
template <>
inline double extrap_prod<double>(float c, double v) {
    return (double)c * v;              // f64 product (f32 coeff widened)
}

template <typename S>
static double extrap_calc_lpc(const S *values, long long nvalues,
                              long long maxloops, float *coeffs) {
    const int NC = 4;
    long long nevals = nvalues - NC;
    for (int i = 0; i < NC; i++) coeffs[i] = 0.0f;
    double step = 3.0 / 16.0;
    double quality = 20.0;
    if (nevals <= 0) return quality;

    // the reference squares in the DATA type before the double
    // accumulation (float*float stays float in C): on the f32 path an
    // fl32-rounded values_rms can exceed the descent's double-exact trial
    // error, which is exactly what lets the first trial "improve" on
    // spike windows (reference extrapolator.c:95-107 vs 128-147) — a
    // full-double rms here picked the zero filter where the reference
    // keeps a +3/16 coefficient
    double deltas_rms = 0.0, values_rms = 0.0;
    for (long long k = 0; k < nevals; k++) {
        S t = values[NC + k];
        S d = (S)(values[NC + k] - values[NC - 1 + k]);
        deltas_rms += (double)(S)(d * d);
        values_rms += (double)(S)(t * t);
    }
    if (values_rms == 0.0) return quality;

    double fre = values_rms;
    long long loops = 0, changes = 0;
    std::vector<double> sums((size_t)nevals);

    while (fre > 0.0 && (!maxloops || loops < maxloops)) {
        for (long long k = 0; k < nevals; k++) {
            double s = 0.0;
            for (int c = 0; c < NC; c++)
                s += extrap_prod<S>(coeffs[NC - 1 - c], values[k + c]);
            sums[k] = s + (double)values[k + NC];
        }
        bool improved = false;
        for (int t = 0; t < NC && !improved; t++) {
            loops++;
            const S *dv = values + (NC - t - 1);
            double low = 0.0, hi = 0.0;
            for (long long k = 0; k < nevals; k++) {
                double a = sums[k] - (double)dv[k] * step;
                low += a * a;
            }
            for (long long k = 0; k < nevals; k++) {
                double b = sums[k] + (double)dv[k] * step;
                hi += b * b;
            }
            if (low < fre || hi < fre) {
                if (low < hi) {
                    fre = low;
                    coeffs[t] = (float)((double)coeffs[t] - step);
                } else {
                    fre = hi;
                    coeffs[t] = (float)((double)coeffs[t] + step);
                }
                changes++;
                improved = true;
            }
        }
        if (!improved) {
            loops++;                   // the exit test also counts a loop
            if (step > 3.0 / 4194304.0)
                step *= 0.5;
            else
                break;
        }
    }

    if (changes) {                     // stability check via PARCOR clamp
        double parcor[NC], temp[NC];
        for (int i = 0; i < NC; i++) temp[i] = (double)coeffs[i];
        for (int m = NC - 1; m >= 0; m--) {
            parcor[m] = temp[m];
            double denom = 1.0 - parcor[m] * parcor[m];
            if (std::fabs(denom) < 1e-6) {
                parcor[m] = parcor[m] < 0.0 ? -0.9999995 : 0.9999995;
                denom = 1.0 - parcor[m] * parcor[m];
            }
            if (m > 0) {
                double nxt[NC];
                for (int i = 0; i < m; i++)
                    nxt[i] = (temp[i] - parcor[m] * temp[m - 1 - i]) / denom;
                for (int i = 0; i < m; i++) temp[i] = nxt[i];
            }
        }
        bool outlier = false;
        for (int i = 0; i < NC; i++)
            if (std::fabs(parcor[i]) > 0.9999) outlier = true;
        if (outlier) {
            double lpc[NC];
            for (int i = 0; i < NC; i++) {
                if (parcor[i] > 0.9999) parcor[i] = 0.9999;
                if (parcor[i] < -0.9999) parcor[i] = -0.9999;
            }
            for (int i = 0; i < NC; i++) {
                lpc[i] = parcor[i];
                for (int j = 0; j < i / 2; j++) {
                    double tmp = lpc[j];
                    lpc[j] += parcor[i] * lpc[i - 1 - j];
                    lpc[i - 1 - j] += parcor[i] * tmp;
                }
                if (i & 1) lpc[i >> 1] += lpc[i >> 1] * parcor[i];
            }
            for (int i = 0; i < NC; i++) coeffs[i] = (float)lpc[i];
        }
    }

    // re-evaluate; fall back to the delta predictor or the zero filter
    fre = 0.0;
    for (long long k = 0; k < nevals; k++) {
        double s = 0.0;
        for (int c = 0; c < NC; c++)
            s += extrap_prod<S>(coeffs[NC - 1 - c], values[k + c]);
        s += (double)values[k + NC];
        fre += s * s;
    }
    if (deltas_rms < fre && deltas_rms < values_rms) {
        coeffs[0] = -1.0f;
        coeffs[1] = coeffs[2] = coeffs[3] = 0.0f;
        fre = deltas_rms;
    } else if (values_rms <= fre) {
        for (int i = 0; i < NC; i++) coeffs[i] = 0.0f;
        fre = values_rms;
    }
    if (fre != 0.0)
        quality = (std::log(values_rms / fre) * 0.5) / std::log(2.0);
    if (quality > 20.0) quality = 20.0;
    return quality;                    // caller validates >= 0 / not NaN
}

template <typename S>
static double extrap_fwd(const S *values, long long nvalues, long long nx,
                         long long maxloops, S *out) {
    const int NC = 4;
    float coeffs[NC], rev[NC];
    double q = extrap_calc_lpc<S>(values, nvalues, maxloops, coeffs);
    for (int i = 0; i < NC; i++) rev[i] = coeffs[NC - 1 - i];
    S src[NC];                         // newest-last window, zero left pad
    for (int i = 0; i < NC; i++) {
        long long idx = nvalues - NC + i;
        src[i] = idx >= 0 ? values[idx] : (S)0;
    }
    for (long long i = 0; i < nx; i++) {
        // seed from the first product, not +0.0: the numpy oracle's strict
        // cumsum starts at element 0, and a window of all -0.0 products
        // must sum to -0.0 (negating to +0.0) for bit-parity
        double sum = extrap_prod<S>(rev[0], src[0]);
        for (int j = 1; j < NC; j++)
            sum += extrap_prod<S>(rev[j], src[j]);
        S y = (S)(-sum);
        out[i] = y;
        src[0] = src[1]; src[1] = src[2]; src[2] = src[3]; src[3] = y;
    }
    return q;
}

extern "C" double art_extrapolate_f32(const float *values, long long n,
                                      long long nx, long long maxloops,
                                      float *out) {
    return extrap_fwd<float>(values, n, nx, maxloops, out);
}

extern "C" double art_extrapolate_f64(const double *values, long long n,
                                      long long nx, long long maxloops,
                                      double *out) {
    return extrap_fwd<double>(values, n, nx, maxloops, out);
}

extern "C" double art_extrap_fit_f32(const float *values, long long n,
                                     long long maxloops, float *coeffs) {
    return extrap_calc_lpc<float>(values, n, maxloops, coeffs);
}

extern "C" double art_extrap_fit_f64(const double *values, long long n,
                                     long long maxloops, float *coeffs) {
    return extrap_calc_lpc<double>(values, n, maxloops, coeffs);
}
