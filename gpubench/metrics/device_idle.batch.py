"""device_idle.batch: the share of an unprofiled batch's time, in %, in which no operation runs on
the device: 1 - the device's busy time a batch (the union of its operations in the device-only
profile of the traced stretch) over the mean host-clock time of the window's unprofiled batches."""


def read(run):
    return run.idle_percent()
