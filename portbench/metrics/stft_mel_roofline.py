"""The stft_mel kernel's share of its roofline: the least time the published peaks allow for
its work, over the device time of its launches in the profiled window."""


def read(r):
    return r.roofline_pct("stft_mel")
