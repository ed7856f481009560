// The column walk of the Viterbi kernel's cluster route (csrc/viterbi.cu), as plain C++.
//
// A column n of log_trans is walked over its runs of finite entries only: a run is a
// stretch of rows p with log_trans[p, n] > -inf, given as its first row (start), its
// length (len) and the offset of its first value in the packed values (val). A group of
// G lanes shares a column: lane l takes the entries l, l + G, l + 2G, ... of each run,
// so every lane visits its rows in ascending p and keeps, with a strict >, the first p
// of its largest sum. The group then combines its lanes with `takes` (a larger sum, or
// an equal one at a smaller p), so the group's answer is the first p of the column's
// largest sum whatever the split. Rows that are not visited have log_trans = -inf, so
// their sums are -inf and never win while any sum is finite; where every visited sum is
// -inf (or the column has no run), `pointer_of` gives p = 0, the dense scan's answer.
//
// The sums are __fadd_rn of the same two floats as the plain version's, so the result
// has its bits. tests/test_torch_viterbi_runs.py compiles this header with g++ and holds
// it against ops/viterbi.py:viterbi_reference.

#pragma once

namespace viterbi_runs {

// does (score, p) replace (best, best_p): a larger score, or an equal one at a smaller p
__host__ __device__ __forceinline__ bool takes(float score, int p, float best, int best_p) {
    return score > best || (score == best && p < best_p);
}

// One lane's part of a column: runs r0 .. r1 - 1, entries lane, lane + G, ... of each.
// `v` holds v_{t-1} for every p; `vals` the packed values, `vbase` the packed offset
// that vals[0] stands for.
__device__ __forceinline__ void lane_best(const float* v, const float* vals, int vbase,
                                          const int* run_start, const int* run_len,
                                          const int* run_val, int r0, int r1, int lane, int G,
                                          float& best, int& best_p) {
    for (int r = r0; r < r1; ++r) {
        const int ps = run_start[r];
        const int len = run_len[r];
        const float* val = vals + (run_val[r] - vbase);
        for (int j = lane; j < len; j += G) {
            const float s = __fadd_rn(v[ps + j], val[j]);
            if (s > best) {  // ascending p within the lane: the first p on ties
                best = s;
                best_p = ps + j;
            }
        }
    }
}

// the pointer of a column's best: p = 0 where no sum is above -inf, as the dense scan
__host__ __device__ __forceinline__ int pointer_of(float best, int best_p) {
    return best > -INFINITY ? best_p : 0;
}

}  // namespace viterbi_runs
