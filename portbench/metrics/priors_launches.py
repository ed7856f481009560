"""CUDA launch calls per call that fall inside the program span pyin.priors (pYIN's
100-threshold loop), the launches read from the profiler's runtime events."""

from portbench import program_spans


def read(r):
    return program_spans.launches_in(r, "pyin.priors")
