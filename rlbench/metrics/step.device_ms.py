"""Device busy time a dispatch-loop launch in the traced slice: the union of
the device activities the profiler saw, over the launches in the slice."""


def read(run):
    s = run.slice
    if s is None or not s.launches or s.busy_s <= 0:
        return None
    return s.busy_s / s.launches * 1e3
