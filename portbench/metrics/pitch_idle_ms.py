"""The card's idle ms per call while the outermost open program span is pyin (the port's own
spans, on the profiled window's clock)."""

from portbench import program_spans


def read(r):
    return program_spans.idle_ms(r, program_spans.PITCH)
