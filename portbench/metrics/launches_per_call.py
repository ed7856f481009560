"""CUDA launch calls per forward call in the profiled window (the port's ctypes launches too)."""


def read(r):
    return r.events.launches / r.calls if r.calls else None
