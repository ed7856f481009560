"""Host-clock ms per request of its copies to and from the card (the spans h2d and d2h)."""


def read(r):
    if "h2d" not in r.span_ms:
        return None
    return r.span_ms["h2d"] + r.span_ms.get("d2h", 0.0)
