"""Host-clock ms per call of onset_strength, tempo and beat_track, each span ending in a
synchronisation."""

SPANS = ("onset_strength", "tempo", "beat_track")


def read(r):
    if not all(s in r.span_ms for s in SPANS):
        return None
    return sum(r.span_ms[s] for s in SPANS)
