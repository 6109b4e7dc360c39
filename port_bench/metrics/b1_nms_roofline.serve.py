"""B1 (`nms_bitmask_kernel` + `nms_scan_kernel`) against its roofline, in %:
the least time of the greedy NMS these inputs need (each kept candidate
tested against its later ones, counted on the reference's decode of the
kept batch of each pool slot; boxes and scores read once, the mask written
once), summed over the traced window's batches, over the kernels' device
time in the trace."""

from port_bench.trace import kernel_seconds


def read(record):
    spent = kernel_seconds(record, "nms_bitmask_kernel", "nms_scan_kernel")
    least = record.get("nms_least_s")
    if not spent or not least:
        return None
    return 100.0 * sum(least) / spent
