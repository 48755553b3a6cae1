"""Mean wait of a frontend's block in its submit ring before the owner took
it, in the window: the program's dispatch.ring_wait_ms histogram."""


def read(run):
    count, total = run.histogram("dispatch.ring_wait_ms")
    return total / count if count else None
