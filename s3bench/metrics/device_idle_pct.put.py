"""Share of the traced window in which nothing ran on the card (%): no
kernel, copy or memset (torch.profiler, the union of busy intervals)."""


def read(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)
