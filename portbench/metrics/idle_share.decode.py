"""idle_share: the share of the traced window in which no operation ran on
the card (1 - the profiler's busy time / the window), in %."""


def read(w):
    if w.trace is None or not w.trace.kernels or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
