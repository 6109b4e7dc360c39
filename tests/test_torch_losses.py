"""Port parity for the SSD loss and the selective L2 penalty (CPU, float32).

`SSDLoss` value and gradient with respect to the predictions against
`jax.value_and_grad` of the JAX package's, at rtol 1e-5 (the same float32
operations, summed in another order).  The hard-negative selection is the
same 31-step bit-pattern search on both sides, so ties at the k-th value
share their weight in the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.losses import SSDLoss as JaxSSDLoss
from jpeg_detection_resnet_ssd_tpu.losses import l2_regularization_loss as jax_l2
from jpeg_detection_resnet_ssd_tpu.losses.classification import (
    default_ssd_reg_filter as jax_reg_filter,
)
from jpeg_detection_resnet_ssd_tpu.losses.ssd_loss import top_k_sum as jax_top_k_sum
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables
from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import _LEAF_NAMES
from jpeg_detection_resnet_ssd_torch.losses import (
    SSDLoss,
    l2_regularization_loss,
    regularized_parameters,
    top_k_sum,
)
from jpeg_detection_resnet_ssd_torch.models import build_model

from torch_parity import random_flax_variables

torch.set_num_threads(1)

N_TOTAL = 4  # 3 classes + background


def loss_case(seed, n_pos=12, tie_rows=0, batch=2, n=300):
    """(y_true, y_pred) with `n_pos` positives, some neutral anchors and,
    with `tie_rows`, that many negatives whose class loss is identical."""
    rng = np.random.default_rng(seed)
    cls = np.zeros((batch, n), np.int64)
    pos = rng.choice(batch * n, n_pos, replace=False)
    cls.reshape(-1)[pos] = rng.integers(1, N_TOTAL, n_pos)
    onehot = np.eye(N_TOTAL)[cls]
    neutral = rng.random((batch, n)) < 0.1
    onehot[neutral & (cls == 0)] = 0.0
    logits = rng.normal(0, 2, (batch, n, N_TOTAL))
    if tie_rows:
        negs = np.flatnonzero((cls == 0) & ~neutral)[:tie_rows]
        logits.reshape(-1, N_TOTAL)[negs] = logits.reshape(-1, N_TOTAL)[negs[0]]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    offsets_t = rng.normal(0, 1, (batch, n, 4))
    offsets_p = offsets_t + rng.normal(0, 1.5, (batch, n, 4))  # both smooth-L1 branches
    tail = rng.uniform(0.1, 1, (batch, n, 8))
    y_true = np.concatenate([onehot, offsets_t, tail], -1).astype(np.float32)
    y_pred = np.concatenate([probs, offsets_p, tail], -1).astype(np.float32)
    return y_true, y_pred


CASES = {
    "positives": dict(seed=0),
    "no_positives": dict(seed=1, n_pos=0),
    "ties_at_kth": dict(seed=2, n_pos=4, tie_rows=40),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_neg_min", [0, 25])
def test_ssd_loss_value_and_grad_match_jax(case, n_neg_min):
    y_true, y_pred = loss_case(**CASES[case])
    ref_loss, ref_grad = jax.value_and_grad(
        lambda p: JaxSSDLoss(n_neg_min=n_neg_min)(jnp.asarray(y_true), p)
    )(jnp.asarray(y_pred))
    pred = torch.from_numpy(y_pred).requires_grad_(True)
    loss = SSDLoss(n_neg_min=n_neg_min)(torch.from_numpy(y_true), pred)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(pred.grad.numpy(), ref_grad, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_grad).max())
    per_item = SSDLoss(n_neg_min=n_neg_min).per_item(torch.from_numpy(y_true), pred.detach())
    np.testing.assert_allclose(
        per_item.numpy(),
        np.asarray(JaxSSDLoss(n_neg_min=n_neg_min).per_item(jnp.asarray(y_true), jnp.asarray(y_pred))),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("n_keep", [0.0, 1.0, 2.5, 7.0, 9.3, 20.0])
def test_top_k_sum_matches_jax_with_ties(n_keep):
    flat = np.array([0.5, 3.0, 3.0, 3.0, 0.0, 1.25, 7.0, 3.0, 0.5, 2.0, 0.0, 1.0,
                     4.0, 4.0, 0.25, 0.75, 6.0, 0.5, 0.5, 9.0], np.float32)
    ref, ref_grad = jax.value_and_grad(lambda x: jax_top_k_sum(x, jnp.float32(n_keep)))(
        jnp.asarray(flat)
    )
    x = torch.from_numpy(flat).requires_grad_(True)
    got = top_k_sum(x, torch.tensor(n_keep))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), rtol=1e-6, atol=1e-7)
    k = int(np.ceil(n_keep))
    np.testing.assert_allclose(got.item(), np.sort(flat)[::-1][:k].sum(), rtol=1e-6)


@pytest.fixture(scope="module")
def ssd_custom_pair():
    module, example = jax_build_model("ssd300_ssd_custom", n_classes=20)
    variables = random_flax_variables(module, example(), train=False, seed=4)
    port, _ = build_model("ssd300_ssd_custom", n_classes=20, device="cpu")
    load_flax_variables(port, variables)
    return variables, port


def test_l2_selects_the_jax_tensors_with_the_same_value(ssd_custom_pair):
    variables, port = ssd_custom_pair
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    want = set()
    for path, _ in flat:
        keys = tuple(p.key for p in path)
        if jax_reg_filter(keys):
            want.add(".".join((*keys[:-1], _LEAF_NAMES["params"][keys[-1]])))
    got = {k for k, _ in regularized_parameters(port)}
    assert got == want
    assert len(got) == 2 * 6 + 6  # head conf + loc, fc6, fc7, conv6_1/2, conv9_1/2
    ref = float(jax_l2(variables["params"], 5e-4))
    np.testing.assert_allclose(l2_regularization_loss(port, 5e-4).item(), ref, rtol=1e-6)
