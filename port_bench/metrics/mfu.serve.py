"""The serving forward's share of the card's bf16 dense peak, in %: the
frozen forward FLOPs of an image (2 x the multiply-adds of every
convolution and dense layer, counted on the reference network at the
cell's shape) times the traced window's images per second."""

from port_bench.counts.kernels import PEAKS


def read(record):
    if not record["busy_s"]:  # no device operation in the trace
        return None
    if not record.get("images_per_s") or not record.get("image_flops"):
        return None
    return 100.0 * record["images_per_s"] * record["image_flops"] / PEAKS["bf16_flops"]
