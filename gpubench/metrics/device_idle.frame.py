"""device_idle.frame: the share of an unprofiled frame's time, in %, in which no operation runs on
the device: 1 - the device's busy time a frame (the union of its operations in the device-only
profile of the traced stretch) over the mean host-clock time of the window's unprofiled frames."""


def read(run):
    return run.idle_percent()
