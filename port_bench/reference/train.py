"""Plain SGD training steps of a configuration's reference network.

A step is: the network's train-mode forward (batch statistics in every
BatchNorm), its loss (`net_<network>.py::loss`), the gradient by
autograd, and SGD with momentum (the buffer starts at the first gradient;
Nesterov where the configuration says) at the step's learning rate.
Bottlenecks are recomputed in the backward pass so that a batch of 256
fits beside nothing else on one card.
"""

from __future__ import annotations

import torch

from port_bench.reference import nets


def trainable(P: dict) -> list[str]:
    return [k for k in P if not k.endswith(("running_mean", "running_var"))]


def run(network, P0: dict, batches, hyper: dict, prec: nets.Precision = nets.FLOAT32):
    """SGD steps of `network` (a `net_<name>.py` module) over `batches` from
    the weights `P0` (left unchanged).

    Returns the loss of each step, the network's outputs in the first step
    (detached), the norm of each leaf's first gradient, and the norm of each
    leaf's change after the last step."""
    names = trainable(P0)
    P = {k: v.detach().clone() for k, v in P0.items()}
    for k in names:
        P[k].requires_grad_(True)
    buf: dict = {}
    losses, grad_norms, first = [], {}, None
    for s, batch in enumerate(batches):
        net = nets.Net(P, prec, train=True)
        outs = network.forward(net, batch["y"], batch["cbcr"], hyper["n_classes"], checkpoint=True)
        loss = network.loss(P, outs, batch, hyper)
        if s == 0:
            first = tuple(o.detach() for o in outs)
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(float(loss.detach()))
        lr = hyper["lr"] / (1.0 + hyper.get("lr_decay", 0.0) * s)
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = g.float()
                if s == 0:
                    grad_norms[k] = float(g.norm())
                    buf[k] = g.clone()
                else:
                    buf[k] = hyper["momentum"] * buf[k] + g
                upd = g + hyper["momentum"] * buf[k] if hyper.get("nesterov") else buf[k]
                P[k] -= lr * upd
        del grads, loss, outs
    with torch.no_grad():
        change = {k: float((P[k].float() - P0[k].float()).norm()) for k in names}
    return losses, first, grad_norms, change
