"""The program's counter host_syncs per call: copies off the card, each of which waits for it."""

from portbench import program_spans


def read(r):
    return program_spans.counter_per_call(r, "host_syncs")
