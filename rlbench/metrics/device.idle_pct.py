"""The share of the traced slice in which no device activity ran."""


def read(run):
    s = run.slice
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
