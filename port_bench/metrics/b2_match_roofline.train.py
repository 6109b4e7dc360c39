"""B2 (`bipartite_match_kernel`) against its roofline, in %: the least time
to read the IoU rows of the live ground-truth boxes of each step's batch
(after the augment) and the row mask once, and write one index a row,
over the kernel's device time in the trace."""

from port_bench.counts import kernels
from port_bench.trace import kernel_seconds


def read(record):
    spent = kernel_seconds(record, "bipartite_match_kernel")
    live = record.get("b2_live_rows")
    if not spent or not live:
        return None
    least = sum(kernels.least_seconds(*kernels.match(n, record["batch"], record["max_gt"],
                                                     record["n_anchors"])) for n in live)
    return 100.0 * least / spent
