"""Device milliseconds a training step spends in convolution kernels,
forward and backward (`counts/convolution.py`): their device time in the
traced window over the window's steps."""

from port_bench.counts import convolution


def read(record):
    spent = convolution.seconds(record)
    if not spent or not record.get("steps"):
        return None
    return 1e3 * spent / record["steps"]
