"""The frozen operation and byte counts against hand counts."""

import torch

from port_bench.counts import flops, kernels
from port_bench.reference import net_resnet50_dct_rfa_thinner as classifier
from port_bench.reference import net_ssd300_resnet_custom as detector


def test_one_conv_and_one_dense_by_hand():
    P = {"c.weight": torch.empty(256, 64, 3, 3, device="meta"),
         "c.bias": torch.empty(256, device="meta"),
         "d.weight": torch.empty(10, 256, device="meta"),
         "d.bias": torch.empty(10, device="meta")}
    net = flops._Counter(P)
    x = net.conv(torch.empty(1, 38, 38, 64, device="meta"), "c")
    assert net.macs == 38 * 38 * 256 * 64 * 9
    net.dense(x.mean(dim=(1, 2)), "d")
    assert net.macs == 38 * 38 * 256 * 64 * 9 + 256 * 10


def test_taps_that_only_read_padding_are_not_counted():
    P = {"f.weight": torch.empty(8, 4, 3, 3, device="meta"), "f.bias": torch.empty(8, device="meta")}
    net = flops._Counter(P)
    net.conv(torch.empty(1, 5, 5, 4, device="meta"), "f", dilation=6)  # fc6 on its 5x5 map
    assert net.macs == 5 * 5 * 8 * 4 * 1
    net.macs = 0
    net.conv(torch.empty(1, 10, 10, 4, device="meta"), "f", dilation=6)
    assert net.macs == 10 * 10 * 8 * 4 * 9


def test_network_counts_are_frozen():
    # 2 x multiply-adds of every conv and dense layer at the cells' shapes
    assert flops.forward_flops(detector, 38, 20) == 13_028_263_936
    assert flops.forward_flops(classifier, 28, 1000) == 5_973_508_096
    assert flops.train_flops(detector, 38, 20) == 3 * 13_028_263_936
    assert detector.ANCHORS.count() == 8732


def test_kernel_least_work_by_hand():
    assert kernels.flip(2 * 38 * 38 * 64) == (2 * 2 * 38 * 38 * 64 * 4, 0)
    nbytes, ops = kernels.match(live_rows=5, batch=2, max_gt=8, anchors=8732)
    assert (nbytes, ops) == (5 * 8732 * 4 + 2 * 8 * 4 + 2 * 8, 5 * 8732)
    keep = torch.tensor([[True, False, True, False], [False, False, False, False]])
    nbytes, ops = kernels.nms(keep, problems=2, k=4)
    assert ops == kernels.NMS_OPS_PER_PAIR * (3 + 1)  # candidate 0 vs 3 later, 2 vs 1
    assert nbytes == 2 * 4 * (16 + 4 + 1)
    assert kernels.least_seconds(3.35e12, 0) == 1.0
