// The beat tracker's dynamic program over one onset envelope, on the host.
//
// One envelope is a strictly sequential scalar recurrence of a few thousand frames:
// frame i scans a window of about 1.5 fpb earlier cumulative scores. A Python loop
// pays some 25 us of interpreter per frame; this loop pays some 40 ns. The recurrence
// is the JAX package's host DP (librosa_tpu/_native/hostdp.cpp), in float64: the same
// window bounds, log-squared penalty and first-beat gating. It walks the candidates
// from the earliest frame with a strict >, so of equal scores it keeps the earliest
// predecessor (the largest distance); the batched kernel (beat_dp.cu) keeps the
// smallest distance, as the JAX package's device scan does.
//
// Built with g++ into a plain C library by ops/_build.py and loaded with ctypes.

#include <cmath>
#include <cstdint>

extern "C" void beat_dp_host(const double* localscore, long T, const double* fpb, int tv,
                             double tightness, int64_t* backlink, double* cumscore) {
    if (T <= 0) return;
    // the true maximum: an envelope may be all negative
    double score_thresh = -HUGE_VAL;
    for (long i = 0; i < T; ++i)
        if (localscore[i] > score_thresh) score_thresh = localscore[i];
    score_thresh *= 0.01;

    bool first_beat = true;
    for (long i = 0; i < T; ++i) {
        const double f = fpb[tv ? i : 0];
        long lo = (long)(i - 2.0 * f);
        if (lo < 0) lo = 0;
        // hi is exclusive: i - round(f / 2) + 1, rounding half to even as numpy does
        long hi = i - (long)std::nearbyint(f * 0.5) + 1;
        if (hi > i) hi = i;  // d = i - loc >= 1: cumscore[i] is not written yet

        double best_score = -HUGE_VAL;
        long best_loc = -1;
        for (long loc = lo; loc < hi; ++loc) {
            const double dev = std::log((double)(i - loc)) - std::log(f);
            const double s = cumscore[loc] - tightness * dev * dev;
            if (s > best_score) {
                best_score = s;
                best_loc = loc;
            }
        }

        long beat_loc = -1;
        if (best_loc >= 0 && std::isfinite(best_score)) {
            cumscore[i] = localscore[i] + best_score;
            beat_loc = best_loc;
        } else {
            cumscore[i] = localscore[i];
        }
        if (first_beat && localscore[i] < score_thresh) {
            backlink[i] = -1;
        } else {
            backlink[i] = beat_loc;
            first_beat = false;
        }
    }
}
