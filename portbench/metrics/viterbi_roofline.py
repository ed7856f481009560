"""The Viterbi kernels' share of their roofline (2 operations per finite transition pair per
step), over the device time of their launches in the profiled window."""


def read(r):
    return r.roofline_pct("viterbi")
