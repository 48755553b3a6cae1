"""Device activities (kernels, copies, memsets) a dispatch-loop launch in
the traced slice, as the profiler saw them."""


def read(run):
    s = run.slice
    if s is None or not s.launches or not s.device:
        return None
    return len(s.device) / s.launches
