"""Nature-DQN network of the port against the flax model: the parameter
converter, Q-values on the same params and uint8 frames, action-value
accessors, atari_phi and the initializers."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfrl_tpu.action_value import DiscreteActionValue as JaxDAV
from pfrl_tpu.models import LargeAtariCNN as JaxLargeAtariCNN
from pfrl_tpu.q_functions import DiscreteActionValueHead as JaxHead
from pfrl_tpu.utils import atari_phi as jax_atari_phi
from pfrl_tpu_torch import convert, initializers
from pfrl_tpu_torch.action_value import DiscreteActionValue
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN
from pfrl_tpu_torch.utils.batch_states import atari_phi

torch.set_num_threads(1)


class JaxNatureQ(nn.Module):
    """bench.py's NatureQ."""

    n_actions: int = 6

    @nn.compact
    def __call__(self, x):
        return JaxHead()(nn.Dense(self.n_actions)(JaxLargeAtariCNN()(x)))


def _frames(seed, b=3):
    return np.random.RandomState(seed).randint(0, 256, (b, 84, 84, 4)).astype(np.uint8)


def _flax_params(seed, n_actions=6):
    params = JaxNatureQ(n_actions).init(jax.random.PRNGKey(seed), jnp.zeros((1, 84, 84, 4)))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("seed", [0, 1])
def test_q_values_match_flax_with_converted_params(seed):
    params = _flax_params(seed)
    obs = _frames(seed)
    want = JaxNatureQ().apply(params, jax_atari_phi(jnp.asarray(obs))).q_values
    model = convert.load_flax_params(NatureQ(6), params)
    with torch.no_grad():
        got = model(atari_phi(torch.from_numpy(obs))).q_values
    # fp32 on both sides; only the reduction order of convs/matmuls differs.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_converter_layouts_cover_every_parameter():
    params = _flax_params(2)
    model = convert.load_flax_params(NatureQ(6), params)
    got = {name: p.detach().numpy() for name, p in model.named_parameters()}
    flax = params["params"]
    scopes = {
        "torso.convs.0": flax["LargeAtariCNN_0"]["Conv_0"],
        "torso.convs.1": flax["LargeAtariCNN_0"]["Conv_1"],
        "torso.convs.2": flax["LargeAtariCNN_0"]["Conv_2"],
        "torso.dense": flax["LargeAtariCNN_0"]["Dense_0"],
        "head": flax["Dense_0"],
    }
    assert set(got) == {f"{s}.{k}" for s in scopes for k in ("weight", "bias")}
    for sub, node in scopes.items():
        k = node["kernel"]
        want = np.transpose(k, (3, 2, 0, 1)) if k.ndim == 4 else k.T  # HWIO->OIHW, [in,out]->[out,in]
        np.testing.assert_array_equal(got[f"{sub}.weight"], want)
        np.testing.assert_array_equal(got[f"{sub}.bias"], node["bias"])


def test_converter_rejects_a_missing_scope():
    params = _flax_params(2)
    del params["params"]["Dense_0"]
    with pytest.raises(KeyError):
        convert.load_flax_params(NatureQ(6), params)


def test_torso_features_match_flax():
    params = _flax_params(3)
    obs = _frames(3, b=2)
    torso_params = {"params": params["params"]["LargeAtariCNN_0"]}
    want = JaxLargeAtariCNN().apply(torso_params, jax_atari_phi(jnp.asarray(obs)))
    torso = convert.load_flax_params(LargeAtariCNN(), torso_params)
    with torch.no_grad():
        got = torso(atari_phi(torch.from_numpy(obs)))
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_action_value_accessors_match_jax():
    q = np.array(
        [[1.0, 3.0, 3.0, 0.0], [-1.0, -1.0, -2.0, -5.0], [0.5, 0.25, 0.5, 0.75]],
        np.float32,
    )  # ties: the first index wins in both
    actions = np.array([2, 0, 3], np.int32)
    jav, tav = JaxDAV(jnp.asarray(q)), DiscreteActionValue(torch.from_numpy(q))
    greedy = tav.greedy_actions()
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jav.greedy_actions()))
    np.testing.assert_array_equal(tav.max().numpy(), np.asarray(jav.max()))
    np.testing.assert_array_equal(
        tav.evaluate_actions(torch.from_numpy(actions)).numpy(),
        np.asarray(jav.evaluate_actions(jnp.asarray(actions))),
    )
    assert tav.n_actions == 4


def test_atari_phi_matches_jax_and_passes_floats():
    obs = _frames(4, b=1)
    np.testing.assert_array_equal(
        atari_phi(torch.from_numpy(obs)).numpy(), np.asarray(jax_atari_phi(jnp.asarray(obs)))
    )
    x = torch.rand(2, 3)
    assert atari_phi(x) is x


def test_initializer_statistics():
    g = torch.Generator().manual_seed(0)
    model = NatureQ(6)
    model.reset_parameters(g)
    for layer in (*model.torso.convs, model.torso.dense):
        w = layer.weight.detach()
        std = (1.0 / initializers.fan_in(w)) ** 0.5
        assert abs(w.std().item() / std - 1.0) < 0.05
        assert abs(w.mean().item()) < 0.05 * std
        assert torch.all(layer.bias == 0.1)
        assert w.abs().max().item() > 3.0 * std  # untruncated tails
    head = model.head.weight.detach()
    std = (1.0 / 512) ** 0.5
    assert abs(head.std().item() / std - 1.0) < 0.1
    assert head.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-7
    assert torch.all(model.head.bias == 0.0)


def test_initializers_are_seeded():
    a, b = NatureQ(6), NatureQ(6)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
