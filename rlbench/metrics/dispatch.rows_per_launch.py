"""Rows a dispatch-loop launch carried in the window: the program's
dispatch.batch_size histogram, its sum over its count."""


def read(run):
    count, total = run.histogram("dispatch.batch_size")
    return total / count if count else None
