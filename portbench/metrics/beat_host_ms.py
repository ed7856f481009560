"""Host self ms per call of the program spans beat.local_score, beat.backtrack and beat.trim:
beat tracking's numpy and Python steps, each span's duration less its children's."""

from portbench import program_spans


def read(r):
    return program_spans.self_ms(r, program_spans.BEAT_HOST)
