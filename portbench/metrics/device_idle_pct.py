"""100 less the share of the profiled window in which a kernel, copy or set ran on the card."""


def read(r):
    lo, hi = r.events.window
    if hi <= lo or not r.events.device:
        return None
    return 100.0 * (1.0 - r.events.busy_seconds() / (hi - lo))
