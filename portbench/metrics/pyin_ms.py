"""Host-clock ms per call of pyin, its span ending in a synchronisation."""


def read(r):
    return r.span_ms.get("pyin")
