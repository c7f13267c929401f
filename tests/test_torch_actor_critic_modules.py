"""The actor-critic building blocks of the port against the JAX package's:
``MLP``, the policy heads, the (state, action) Q-functions,
``bound_by_tanh``, the additive explorers and ``soft_copy_param``.

Weights are the JAX modules' own, initialized from a key and converted
(``convert.load_flax_params``); inputs come from numpy seeds. Tolerances:
forwards 1e-6 absolute (dots over at most 64 terms, summed in another
order); the explorers on given noise and ``soft_copy_param`` are exact.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distributions import GivenNormal

from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import policies as jpolicies
from pfrl_tpu import q_functions as jq
from pfrl_tpu.functions.bound_by_tanh import bound_by_tanh as jax_bound_by_tanh
from pfrl_tpu.models import MLP as JaxMLP
from pfrl_tpu.utils.copy_param import soft_copy_param as jax_soft_copy_param
from pfrl_tpu_torch import convert, explorers, policies, q_functions
from pfrl_tpu_torch.experiments.mujoco_actor_critic import (
    MLPPolicy,
    deterministic_policy,
    squashed_gaussian_policy,
)
from pfrl_tpu_torch.functions import bound_by_tanh
from pfrl_tpu_torch.models import MLP
from pfrl_tpu_torch.utils.copy_param import copy_param, soft_copy_param

torch.set_num_threads(1)

OBS, ACT, HIDDEN = 5, 3, 16


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


class JaxSACPolicy(nn.Module):
    """``bench.py``'s SAC ``Policy``."""

    act_dim: int = ACT
    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x):
        h = JaxMLP(out_size=2 * self.act_dim, hidden_sizes=(self.hidden, self.hidden))(x)
        return jpolicies.SquashedGaussianHead(action_size=self.act_dim)(h)


class JaxDetPolicy(nn.Module):
    """``bench.py``'s TD3 ``Policy`` (also DDPG's in ``record_curves.py``)."""

    act_dim: int = ACT
    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x):
        h = JaxMLP(out_size=self.act_dim, hidden_sizes=(self.hidden, self.hidden))(x)
        return jpolicies.DeterministicHead()(jnp.tanh(h))


# ------------------------------------------------------------------------ MLP
@pytest.mark.parametrize("hidden,last_wscale,last_bias", [((), 1.0, None), ((16, 8), 1e-2, 0.5)])
def test_mlp_converted_forward_matches_jax(hidden, last_wscale, last_bias):
    jm = JaxMLP(out_size=4, hidden_sizes=hidden, last_wscale=last_wscale, last_bias_init=last_bias,
                nonlinearity=jnp.tanh)
    x = np.random.RandomState(0).normal(size=(6, OBS)).astype(np.float32)
    params = np_tree(jm.init(jax.random.PRNGKey(0), x))
    tm = MLP(OBS, 4, hidden, nonlinearity=torch.tanh, last_wscale=last_wscale, last_bias_init=last_bias)
    assert tm.flax_names() == {f"layers.{i}": f"Dense_{i}" for i in range(len(hidden) + 1)}
    convert.load_flax_params(tm, params)
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(), np.asarray(jm.apply(params, x)), atol=1e-6, rtol=0)
    # Every parameter has a flax leaf of the same size, and the other way round.
    assert sum(p.numel() for p in tm.parameters()) == sum(a.size for a in jax.tree.leaves(params))


def test_mlp_init_has_the_jax_statistics():
    """Chainer-default: std sqrt(1 / fan_in), the last layer scaled by
    ``last_wscale``, zero biases but the last layer's given constant.
    Sample std over 10**5 weights: within 2% of the nominal value, as the
    flax module's own draw is."""
    wide, last_wscale = 400, 1e-2
    tm = MLP(250, wide, (wide,), last_wscale=last_wscale, last_bias_init=0.25)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    jm = JaxMLP(out_size=wide, hidden_sizes=(wide,), last_wscale=last_wscale, last_bias_init=0.25)
    jp = np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 250))))["params"]
    for layer, name, nominal in ((tm.layers[0], "Dense_0", 250**-0.5), (tm.layers[1], "Dense_1", last_wscale * wide**-0.5)):
        w = layer.weight.detach().numpy()
        for sample in (w, jp[name]["kernel"]):
            assert abs(sample.std() / nominal - 1.0) < 0.02
            assert abs(sample.mean()) < 0.02 * nominal
        assert abs(w).max() > 3.5 * nominal  # untruncated
    assert (tm.layers[0].bias == 0).all() and (jp["Dense_0"]["bias"] == 0).all()
    assert (tm.layers[1].bias == 0.25).all() and (jp["Dense_1"]["bias"] == 0.25).all()
    again = MLP(250, wide, (wide,), last_wscale=last_wscale)
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[0].weight, tm.layers[0].weight)  # the generator decides


# ---------------------------------------------------------------------- heads
def test_squashed_gaussian_head_splits_clips_and_exponentiates_like_jax():
    out = np.random.RandomState(1).normal(size=(8, 2 * ACT)).astype(np.float32) * 15.0  # beyond [-20, 2]
    j = jpolicies.SquashedGaussianHead(action_size=ACT).apply({}, jnp.asarray(out))
    t = policies.SquashedGaussianHead(ACT)(_t(out))
    np.testing.assert_array_equal(t.loc.numpy(), np.asarray(j.loc))
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale), rtol=1e-6)
    assert float(t.scale.max()) <= np.exp(2.0) * (1 + 1e-6) and float(t.scale.min()) >= np.exp(-20.0) * (1 - 1e-6)
    assert (out[:, ACT:] > 2).any() and (out[:, ACT:] < -20).any()


def test_deterministic_head_matches_jax():
    loc = np.random.RandomState(2).normal(size=(4, ACT)).astype(np.float32)
    j = jpolicies.DeterministicHead().apply({}, jnp.asarray(loc))
    t = policies.DeterministicHead()(_t(loc))
    np.testing.assert_array_equal(t.mode().numpy(), np.asarray(j.mode()))


@pytest.mark.parametrize("var_type", ["spherical", "diagonal"])
def test_state_independent_covariance_head_converts_its_bare_log_std(var_type):
    """``log_std`` is a parameter leaf that is neither kernel nor bias."""
    jh = jpolicies.GaussianHeadWithStateIndependentCovariance(action_size=ACT, var_type=var_type, init_log_std=-0.5)
    mean = np.random.RandomState(3).normal(size=(4, ACT)).astype(np.float32)
    params = np_tree(jh.init(jax.random.PRNGKey(0), mean))
    th = policies.GaussianHeadWithStateIndependentCovariance(ACT, var_type=var_type, init_log_std=-0.5)
    assert th.log_std.shape == params["params"]["log_std"].shape and (th.log_std == -0.5).all()
    params["params"]["log_std"] = np.linspace(-1.0, 0.5, th.log_std.numel()).astype(np.float32)
    convert.load_flax_params(th, params)
    j, t = jh.apply(params, jnp.asarray(mean)), th(_t(mean))
    np.testing.assert_array_equal(t.loc.numpy(), np.asarray(j.loc))
    np.testing.assert_allclose(t.scale.detach().numpy(), np.asarray(j.scale), rtol=1e-6)
    assert t.scale.shape == mean.shape


def test_log_std_under_a_compact_wrapper_converts_by_nested_scope():
    class JaxGaussianPolicy(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = JaxMLP(out_size=ACT, hidden_sizes=(HIDDEN,))(x)
            return jpolicies.GaussianHeadWithStateIndependentCovariance(action_size=ACT, var_type="diagonal")(h)

    class GaussianPolicy(MLPPolicy):
        def flax_names(self):
            names = super().flax_names()
            names["head.log_std"] = "GaussianHeadWithStateIndependentCovariance_0/log_std"
            return names

    x = np.random.RandomState(4).normal(size=(4, OBS)).astype(np.float32)
    jp = JaxGaussianPolicy()
    params = np_tree(jp.init(jax.random.PRNGKey(0), x))
    params["params"]["GaussianHeadWithStateIndependentCovariance_0"]["log_std"] = np.array([-1.0, 0.0, 0.3], np.float32)
    tp = GaussianPolicy(OBS, ACT, (HIDDEN,), policies.GaussianHeadWithStateIndependentCovariance(ACT, "diagonal"))
    convert.load_flax_params(tp, params)
    j, t = jp.apply(params, x), tp(_t(x))
    np.testing.assert_allclose(t.loc.detach().numpy(), np.asarray(j.loc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.scale.detach().numpy(), np.asarray(j.scale), rtol=1e-6)
    del params["params"]["GaussianHeadWithStateIndependentCovariance_0"]
    with pytest.raises(KeyError):
        convert.load_flax_params(tp, params)


def test_diagonal_and_fixed_covariance_heads_match_jax():
    x = np.random.RandomState(5).normal(size=(4, 2 * ACT)).astype(np.float32) * 3.0
    j = jpolicies.GaussianHeadWithDiagonalCovariance().apply({}, jnp.asarray(x))
    t = policies.GaussianHeadWithDiagonalCovariance()(_t(x))
    np.testing.assert_array_equal(t.loc.numpy(), np.asarray(j.loc))
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale), rtol=1e-6, atol=1e-7)
    j = jpolicies.GaussianHeadWithFixedCovariance(scale=0.3).apply({}, jnp.asarray(x))
    t = policies.GaussianHeadWithFixedCovariance(0.3)(_t(x))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(t.loc.numpy(), np.asarray(j.loc))


@pytest.mark.parametrize("kind", ["squashed_gaussian", "deterministic"])
def test_bench_policies_convert_by_nested_scopes_and_match_jax(kind):
    x = np.random.RandomState(6).normal(size=(6, OBS)).astype(np.float32)
    if kind == "squashed_gaussian":
        jp, tp = JaxSACPolicy(), squashed_gaussian_policy(OBS, ACT, HIDDEN)
    else:
        jp, tp = JaxDetPolicy(), deterministic_policy(OBS, ACT, HIDDEN)
    params = np_tree(jp.init(jax.random.PRNGKey(0), x))
    assert tp.flax_names() == {f"mlp.layers.{i}": f"MLP_0/Dense_{i}" for i in range(3)}
    convert.load_flax_params(tp, params)
    j, t = jp.apply(params, x), tp(_t(x))
    np.testing.assert_allclose(t.mode().detach().numpy(), np.asarray(j.mode()), atol=1e-6, rtol=0)
    if kind == "squashed_gaussian":
        np.testing.assert_allclose(t.scale.detach().numpy(), np.asarray(j.scale), rtol=1e-5)
    else:
        assert float(t.mode().detach().abs().max()) < 1.0  # tanh before the head


# ---------------------------------------------------------------- Q-functions
def _late_action_model():
    class JaxModel(nn.Module):
        @nn.compact
        def __call__(self, obs, action):
            return JaxMLP(out_size=1, hidden_sizes=(HIDDEN,))(jnp.concatenate([obs, action], -1))

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = MLP(OBS + ACT, 1, (HIDDEN,))

        def reset_parameters(self, generator=None):
            self.mlp.reset_parameters(generator)

        def flax_names(self):
            return {f"mlp.{k}": f"MLP_0/{v}" for k, v in self.mlp.flax_names().items()}

        def forward(self, obs, action):
            return self.mlp(torch.cat([obs, action], -1))

    return JaxModel(), Model()


@pytest.mark.parametrize("kind", ["fc", "single_model", "late_action"])
def test_state_action_q_functions_match_jax(kind):
    rs = np.random.RandomState(7)
    obs = rs.normal(size=(6, OBS)).astype(np.float32)
    act = rs.uniform(-1, 1, (6, ACT)).astype(np.float32)
    if kind == "fc":
        jf = jq.FCSAQFunction(n_hidden_channels=HIDDEN, n_hidden_layers=2, last_wscale=0.5)
        tf = q_functions.FCSAQFunction(OBS, ACT, HIDDEN, 2, last_wscale=0.5)
        assert tf.flax_names() == {f"mlp.layers.{i}": f"MLP_0/Dense_{i}" for i in range(3)}
    elif kind == "single_model":
        jmodel, tmodel = _late_action_model()
        jf = jq.SingleModelStateActionQFunction(model=jmodel)
        tf = q_functions.SingleModelStateActionQFunction(tmodel)
    else:
        jf = jq.FCLateActionSAQFunction(n_hidden_channels=HIDDEN, n_hidden_layers=3)
        tf = q_functions.FCLateActionSAQFunction(OBS, ACT, HIDDEN, 3)
        assert tf.obs_mlp.layers[0].in_features == OBS and tf.mlp.layers[0].in_features == HIDDEN + ACT
    params = np_tree(jf.init(jax.random.PRNGKey(1), obs, act))
    convert.load_flax_params(tf, params)
    got, want = tf(_t(obs), _t(act)).detach().numpy(), np.asarray(jf.apply(params, obs, act))
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    tf.reset_parameters(torch.Generator().manual_seed(0))
    assert not np.allclose(tf(_t(obs), _t(act)).detach().numpy(), want, atol=1e-3)
    assert sum(p.numel() for p in tf.parameters()) == sum(a.size for a in jax.tree.leaves(params))


def test_late_action_q_function_needs_a_hidden_layer():
    with pytest.raises(ValueError):
        q_functions.FCLateActionSAQFunction(OBS, ACT, HIDDEN, 0)


# -------------------------------------------------------------- bound_by_tanh
def test_bound_by_tanh_matches_jax():
    x = np.random.RandomState(8).normal(size=(5, 3)).astype(np.float32) * 4.0
    low, high = np.array([-2.0, 0.0, 1.0], np.float32), np.array([2.0, 0.5, 3.0], np.float32)
    got = bound_by_tanh(_t(x), low, high).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_bound_by_tanh(jnp.asarray(x), low, high)), atol=1e-6, rtol=0)
    assert (got >= low).all() and (got <= high).all()
    np.testing.assert_allclose(
        bound_by_tanh(_t(x), -1.0, 3.0).numpy(), np.asarray(jax_bound_by_tanh(jnp.asarray(x), -1.0, 3.0)), atol=1e-6
    )
    with pytest.raises(ValueError):
        bound_by_tanh(_t(x), None, 1.0)


# ------------------------------------------------------------------ explorers
def _give_jax(monkeypatch, eps):
    monkeypatch.setattr(
        jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(eps, dtype).reshape(shape)
    )


@pytest.mark.parametrize("low,high", [(-1.0, 1.0), (None, 0.5), (-0.5, None), (None, None)])
def test_additive_gaussian_on_given_noise_is_exactly_jax(monkeypatch, low, high):
    rs = np.random.RandomState(9)
    greedy = rs.uniform(-1, 1, (6, ACT)).astype(np.float32)
    eps = (rs.normal(size=(6, ACT)) * 8.0).astype(np.float32)  # scale 0.1: many cross the bounds
    _give_jax(monkeypatch, eps)
    want = np.asarray(jexplorers.AdditiveGaussian(0.1, low=low, high=high).select_action(
        jax.random.PRNGKey(0), 0, jnp.asarray(greedy)))
    got = explorers.AdditiveGaussian(0.1, low=low, high=high).select_action(GivenNormal(eps), 0, _t(greedy)).numpy()
    np.testing.assert_array_equal(got, want)
    if low is not None:
        assert got.min() == low
    if high is not None:
        assert got.max() == high
    if low is None and high is None:
        assert got.max() > 1.5


def test_additive_ou_stateful_and_fallback_on_given_noise_are_exactly_jax(monkeypatch):
    rs = np.random.RandomState(10)
    greedy = rs.uniform(-1, 1, (4, ACT)).astype(np.float32)
    jou, tou = jexplorers.AdditiveOU(mu=0.1, theta=0.2, sigma=0.4), explorers.AdditiveOU(mu=0.1, theta=0.2, sigma=0.4)
    jstate, tstate = jou.init_state((4, ACT)), tou.init_state((4, ACT))
    assert tstate.dtype == torch.float32 and not tstate.any()
    for _ in range(3):
        eps = rs.normal(size=(4, ACT)).astype(np.float32)
        _give_jax(monkeypatch, eps)
        ja, jstate = jou.select_action_stateful(jax.random.PRNGKey(0), jstate, jnp.asarray(greedy))
        ta, tstate = tou.select_action_stateful(GivenNormal(eps), tstate, _t(greedy))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-7, rtol=0)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), atol=1e-7, rtol=0)
    want = np.asarray(jou.select_action(jax.random.PRNGKey(0), 0, jnp.asarray(greedy)))
    np.testing.assert_array_equal(tou.select_action(GivenNormal(eps), 0, _t(greedy)).numpy(), want)


# ------------------------------------------------------------ soft_copy_param
@pytest.mark.parametrize("tau", [5e-3, 1e-2, 0.3])
def test_soft_copy_param_is_numpy_float32_to_the_bit_over_many_copies(tau):
    """``(1 - tau) * t + tau * s`` with both products rounded to float32
    before the sum, 200 times over: equal to numpy and to the JAX function
    to the bit, and not what ``torch.lerp`` gives."""
    torch.manual_seed(0)
    source, target, lerped = MLP(7, 5, (11,)), MLP(7, 5, (11,)), MLP(7, 5, (11,))
    target.reset_parameters(torch.Generator().manual_seed(1))
    copy_param(lerped, target)
    want = [p.detach().numpy().copy() for p in target.parameters()]
    jtree = [jnp.asarray(w) for w in want]
    src = [p.detach().numpy() for p in source.parameters()]
    f32 = np.float32
    for _ in range(200):
        soft_copy_param(target, source, tau)
        want = [f32(1.0 - tau) * w + f32(tau) * s for w, s in zip(want, src)]
        jtree = jax_soft_copy_param(jtree, [jnp.asarray(s) for s in src], tau)
        with torch.no_grad():
            for t, s in zip(lerped.parameters(), source.parameters()):
                t.lerp_(s, tau)
    for p, w, j in zip(target.parameters(), want, jtree):
        assert w.dtype == np.float32
        np.testing.assert_array_equal(p.detach().numpy(), w)
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(j))
    assert any(not torch.equal(a, b) for a, b in zip(target.parameters(), lerped.parameters()))
    assert all(p.requires_grad for p in source.parameters())


def test_copy_param_is_a_hard_copy():
    source, target = MLP(3, 2, (4,)), MLP(3, 2, (4,))
    target.reset_parameters(torch.Generator().manual_seed(3))
    copy_param(target, source)
    assert all(torch.equal(a, b) and a is not b for a, b in zip(target.parameters(), source.parameters()))
