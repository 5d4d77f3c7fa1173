"""Share of the traced window in which no operation ran on the card, in
percent: 1 - (union of the device's kernel, copy and set intervals) /
(the window's length), from ``torch.profiler``."""


def read(m):
    if m.trace is None or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
