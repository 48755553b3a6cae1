"""Mean host time of the engine's launch phase (the promote pass, the slab
step's enqueue and the readback's enqueue, never the device's execution) a
device launch, in the window: the program's device.launch_ms histogram."""


def read(run):
    count, total = run.histogram("device.launch_ms")
    return total / count if count else None
