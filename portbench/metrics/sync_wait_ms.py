"""Host ms per call inside the program span to_host: copies off the card, waiting for it
included."""

from portbench import program_spans


def read(r):
    return program_spans.inside_ms(r, "to_host")
