// The step schedule of the beat DP kernel (csrc/beat_dp.cu), as plain C++.
//
// Frame j of a row scores the candidates d = lo .. hi (round(fpb_j / 2) <= d <= 2 fpb_j,
// 1 <= d <= min(1024, j)), that is the frames j - hi .. j - lo. A step of the kernel
// starts at frame i and scores frames i .. i + k - 1 at once, one warp a frame, reading
// only frames before i: so frame i + m may join the step only where none of its
// candidates reaches a frame of the step, lo > m (or it has no candidate). A step takes
// the leading run of such frames, at most kStepFrames. Frame i itself always qualifies
// (lo >= 1), and where fpb <= 2 (lo = 1) every step is one frame.
//
// window() is the kernel's arithmetic for the candidates (the plain version's float32
// round, floor and products); tests/test_torch_beat_dp_steps.py compiles this header
// with g++ and holds it against ops/beat_dp.py:step_schedule.

#pragma once

namespace beat_steps {

constexpr int kWindow = 1024;     // the largest predecessor distance (beat.py: _MAX_WINDOW)
constexpr int kStepFrames = 16;   // frames a step takes at most: the warps of a block

struct Window {
    int lo, hi;  // candidates lo .. hi; none where lo > hi
};

// the candidates of frame j at fpb f; none where f is NaN (fmaxf and fminf would drop it)
__device__ __forceinline__ Window window(float f, int j) {
    if (f != f) return Window{1, 0};
    const float d_min = rintf(__fmul_rn(f, 0.5f));
    const float lo_f = fmaxf(d_min, 1.0f);
    const float hi_f = fminf(floorf(__fmul_rn(2.0f, f)),
                             static_cast<float>(j < kWindow ? j : kWindow));
    if (!(lo_f <= hi_f)) return Window{1, 0};
    return Window{static_cast<int>(lo_f), static_cast<int>(hi_f)};
}

// may frame i + m join the step that starts at frame i: none of its candidates is a frame
// of the step
__host__ __device__ __forceinline__ bool independent(Window w, int m) {
    return w.lo > w.hi || w.lo > m;
}

// frames of a step from its flags (bit m: frame i + m may join; 0 beyond the last
// frame): the leading run of set bits, at least one frame and at most kStepFrames
__host__ __device__ __forceinline__ int step_length(unsigned flags) {
    int k = 1;
    while (k < kStepFrames && ((flags >> k) & 1u)) ++k;
    return k;
}

}  // namespace beat_steps
