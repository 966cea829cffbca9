"""The traced window's share of time in which no operation ran on the
card, in %: 1 minus the union of the kernel, copy and memset intervals
over the window's host time (the window ends in a device sync)."""


def read(run):
    r = run.reading
    if not r.window_s:
        return None
    return (1 - r.busy_s / r.window_s) * 100
