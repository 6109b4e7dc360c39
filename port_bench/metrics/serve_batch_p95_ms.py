"""The nearest-rank 95th percentile, over every batch of the window, of
the host-clock time from a batch leaving the pool to its outputs on the
host, in ms."""

import math


def read(record):
    times = sorted(record.get("batch_s") or ())
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1] if times else None
