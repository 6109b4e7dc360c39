"""The convolution kernels against the card's bf16 dense peak, in %: the
frozen FLOPs of the window's steps (3 forwards of 2 x the multiply-adds of
every convolution of the reference network at the cell's shape; a
detector has no dense layer, so all of it is convolution) over the device
time of the convolution kernels (`counts/convolution.py`)."""

from port_bench.counts import convolution
from port_bench.counts.kernels import PEAKS


def read(record):
    spent = convolution.seconds(record)
    if not spent or not record.get("steps") or not record.get("step_flops"):
        return None
    return 100.0 * record["steps"] * record["step_flops"] / spent / PEAKS["bf16_flops"]
