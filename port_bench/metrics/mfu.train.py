"""The training step's share of the card's bf16 dense peak, in %: the frozen
FLOPs of a step (3 forwards of 2 x the multiply-adds of every convolution
and dense layer, counted on the reference network at the cell's shape)
times the traced window's steps per second."""

from port_bench.counts.kernels import PEAKS


def read(record):
    if not record["busy_s"]:  # no device operation in the trace
        return None
    if not record.get("steps") or not record.get("step_flops"):
        return None
    rate = record["steps"] * record["step_flops"] / record["window_s"]
    return 100.0 * rate / PEAKS["bf16_flops"]
