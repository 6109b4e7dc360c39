"""B3 (`dct_flip_h_kernel`) against its roofline, in %: the least time to
read and write the augment's output planes once (float32: luma
(B, ob, ob, 64) and chroma (B, ob/2, ob/2, 128), one launch each a step)
over the kernel's device time in the trace."""

from port_bench.counts import kernels
from port_bench.trace import kernel_seconds


def read(record):
    spent = kernel_seconds(record, "dct_flip_h_kernel")
    if not spent:
        return None
    b, ob = record["batch"], record["out_blocks"]
    least = 0.0
    for elements in (b * ob * ob * 64, b * (ob // 2) ** 2 * 128):
        least += kernels.least_seconds(*kernels.flip(elements))
    return 100.0 * least * record["steps"] / spent
