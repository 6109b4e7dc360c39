"""Frozen operation counts of the networks, from the reference's layers.

A forward's FLOPs are 2 x the multiply-adds of every convolution and dense
layer of the configuration's reference network (`reference/net_<network>.py`)
at the cell's input shape, counted on the meta device (no data, no device).
A kernel tap that can only ever read padding (fc6's dilation-6 taps on its
5 x 5 map) does no work and is not counted.  A training step counts as
three forwards.  The count depends on the configuration and the shapes
alone, so it reads the same whatever implements the layers.
"""

from __future__ import annotations

import functools

import torch

from port_bench.reference import nets


class _Counter(nets.Net):
    def __init__(self, P):
        super().__init__(P)
        self.macs = 0

    def conv(self, x, name, stride=1, padding="SAME", dilation=1):
        y = super().conv(x, name, stride, padding, dilation)
        cout, cin, k, _ = self.P[name + ".weight"].shape
        taps = 1
        for size in x.shape[1:3]:
            taps *= sum(1 for j in range(k) if abs((j - (k - 1) / 2) * dilation) < size)
        self.macs += y.shape[1] * y.shape[2] * cout * cin * taps
        return y

    def dense(self, x, name):
        self.macs += self.P[name + ".weight"].numel()
        return super().dense(x, name)


@functools.lru_cache(maxsize=None)
def forward_flops(network, y_blocks: int, n_classes: int) -> int:
    """FLOPs of one image's forward through `network` (a `net_<name>.py`
    module)."""
    layers = network.layers(n_classes)
    P = {k: torch.empty(s, device="meta") for k, s in nets.state_shapes(layers).items()}
    net = _Counter(P)
    y = torch.empty(1, y_blocks, y_blocks, 64, device="meta")
    c = torch.empty(1, y_blocks // 2, y_blocks // 2, 128, device="meta")
    network.forward(net, y, c, n_classes)
    return 2 * net.macs


def train_flops(network, y_blocks: int, n_classes: int) -> int:
    """FLOPs of one image's training step: three forwards."""
    return 3 * forward_flops(network, y_blocks, n_classes)
