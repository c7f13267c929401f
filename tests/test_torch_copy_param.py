"""``copy_param`` and ``soft_copy_param`` refuse modules of another structure
(``pfrl_tpu_torch/utils/copy_param.py``): a missing layer or a pair of
another shape raises ``ValueError`` naming the first pair that differs, as
the JAX ``soft_copy_param``'s ``jax.tree.map`` over two trees raises, and the
target is left as it was. Matching modules still copy.
"""

import jax.numpy as jnp
import pytest
import torch
from torch import nn

from pfrl_tpu.utils.copy_param import soft_copy_param as jax_soft_copy_param
from pfrl_tpu_torch.models import MLP
from pfrl_tpu_torch.models.batch_norm import BatchNorm
from pfrl_tpu_torch.utils import copy_param, soft_copy_param, synchronize_parameters


def _mlp(hidden=(8, 8), out=3, seed=0):
    torch.manual_seed(seed)
    return MLP(4, out, hidden)


def _snapshot(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _unchanged(module, before):
    return all(torch.equal(v, before[k]) for k, v in module.state_dict().items())


COPIES = {
    "hard": lambda target, source: copy_param(target, source),
    "soft": lambda target, source: soft_copy_param(target, source, 0.5),
    "synchronize": lambda target, source: synchronize_parameters(source, target, "soft", 0.5),
}


@pytest.mark.parametrize("copy", sorted(COPIES))
@pytest.mark.parametrize("case", ["missing layer", "extra layer", "shape"])
def test_a_mismatch_raises_and_leaves_the_target_untouched(copy, case):
    source = {"missing layer": _mlp((8, 8)), "extra layer": _mlp((8,)), "shape": _mlp((8, 8), out=2)}[case]
    target = _mlp((8,) if case == "missing layer" else (8, 8), seed=1)
    before = _snapshot(target)
    match = "structure" if case != "shape" else "shapes differ"
    with pytest.raises(ValueError, match=match):
        COPIES[copy](target, source)
    assert _unchanged(target, before)


def test_the_error_names_the_first_pair_that_differs():
    with pytest.raises(ValueError, match=r"target .*\(3, 8\).*source .*\(2, 8\)"):
        copy_param(_mlp(seed=1), _mlp(out=2))
    with pytest.raises(ValueError, match=r"target has 4 synced tensors, source 6; source \S+ has no counterpart"):
        copy_param(_mlp((8,), seed=1), _mlp((8, 8)))


def test_the_jax_soft_copy_also_refuses_a_mismatched_tree():
    target = {"a": jnp.zeros(3)}
    with pytest.raises(ValueError):
        jax_soft_copy_param(target, {"a": jnp.zeros(3), "b": jnp.zeros(2)}, 0.5)


def test_matching_modules_still_copy_with_their_batch_norm_statistics():
    def net(seed):
        torch.manual_seed(seed)
        return nn.Sequential(nn.Linear(4, 5), BatchNorm(5))

    source, target = net(0), net(1)
    source[1].mean.fill_(2.0)
    copy_param(target, source)
    for (name, t), (_, s) in zip(target.state_dict().items(), source.state_dict().items()):
        assert torch.equal(t, s), name
    soft_copy_param(target, net(2), 0.25)
    assert torch.equal(target[1].mean, torch.full((5,), 2.0) * 0.75 + net(2)[1].mean * 0.25)
