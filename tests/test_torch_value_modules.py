"""The discrete value family's modules of the port against the JAX package:
the four state Q-functions, ``QuantileDiscreteActionValue``,
``ops/quantile.py``, ``ImplicitQuantileQFunction``, the noisy ``NatureQ``
of ``train_dqn_ale.py --noisy-net-sigma``, the three new explorers, one
update of each of ``ALCore``, ``PALCore``, ``DoublePALCore``, ``DPPCore``,
``IQNCore`` and ``DoubleIQNCore``, and the converter's default device and
its ``clip_by_global_norm`` + Adam chain.

Draws are matched by value. The port draws from :class:`Tape` (seeded
numpy draws, logged); :func:`install_tape` makes the JAX package draw the
very same numbers: every draw from a real (integer) key pops the next
logged draw, which must be of the same kind and size, and a key of floats
*is* the array to draw (``ValueKeys``, for the vmapped env resets); a
traced integer key (flax checking an init function's shapes) draws zeros
and pops nothing. The
JAX functions run un-jitted (the slice runs its runner under
``jax.disable_jit``), so the pops follow the program's order; the log must
be empty at the end. Noise of a noisy layer is logged from flax and
replayed (``test_torch_rainbow_modules.py``).

Tolerances: forwards within 1e-6 absolute (matmuls reduce in another
order; ``cos`` of arguments up to 64 pi differs by a few ulps), C51's
Q-values over the support [0, 500] within 1e-6 relative; the
elementwise quantile loss 1e-7 absolute; losses and per-sample errors of
an update 1e-5 relative (floor 1e-6); parameters within 1e-6 after one
update (Adam's first steps amplify rounding, ROADMAP C22); epsilon within
one float32 ulp; actions exactly.
"""

import importlib.util
import math
import os
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_continuous_envs import LoggedDraws, ValueKeys
from test_torch_rainbow_modules import ReplayedNormals, np_tree, record_normals

from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.action_value import QuantileDiscreteActionValue as JaxQuantileAV
from pfrl_tpu.agents.al import ALCore as JaxAL
from pfrl_tpu.agents.dpp import DPPCore as JaxDPP
from pfrl_tpu.agents.dqn import DQNCore as JaxDQNCore
from pfrl_tpu.agents.iqn import DoubleIQNCore as JaxDoubleIQN
from pfrl_tpu.agents.iqn import IQNCore as JaxIQN
from pfrl_tpu.agents.pal import DoublePALCore as JaxDoublePAL
from pfrl_tpu.agents.pal import PALCore as JaxPAL
from pfrl_tpu.models import MLP as JaxMLP
from pfrl_tpu.ops import quantile as jquantile
from pfrl_tpu.replay import TransitionBatch as JaxBatch
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import explorers as texplorers
from pfrl_tpu_torch.action_value import DiscreteActionValue, QuantileDiscreteActionValue
from pfrl_tpu_torch.agents import ALCore, DoubleIQNCore, DoublePALCore, DPPCore, DQNCore, IQNCore, PALCore
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ, make_dqn_runner
from pfrl_tpu_torch.experiments.cartpole_value import ReLUMLP
from pfrl_tpu_torch.models import MLP, FactorizedNoisyLinear, to_factorized_noisy
from pfrl_tpu_torch.ops import quantile as tquantile
from pfrl_tpu_torch.optimizers import Adam, ClipByGlobalNorm
from pfrl_tpu_torch.q_functions import (
    DistributionalFCStateQFunctionWithDiscreteAction,
    DistributionalSingleModelStateQFunctionWithDiscreteAction,
    FCStateQFunctionWithDiscreteAction,
    ImplicitQuantileQFunction,
    SingleModelStateQFunctionWithDiscreteAction,
)
from pfrl_tpu_torch.replay import TransitionBatch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, ACTIONS, HIDDEN, ATOMS = 4, 2, 16, 51


# ------------------------------------------------------------ shared helpers
class Tape(LoggedDraws):
    """The port's draw source for these tests: seeded numpy draws, each
    logged as ``(kind, values)``."""

    def randint(self, high, n):
        return self._record("randint", self.rs.randint(0, high, n).astype(np.int32))


def _is_value_key(key) -> bool:
    return jnp.issubdtype(jnp.asarray(key).dtype, jnp.floating)


def _is_abstract(key) -> bool:
    """A traced integer key: flax's shape checks of an init function, which
    draw nothing that is used."""
    return isinstance(key, jax.core.Tracer) and not _is_value_key(key)


def install_tape(monkeypatch, tape: Tape):
    """Make ``jax.random`` draw ``tape``'s log, in order (see the module
    docstring). ``split`` of a real key gives zero keys; a float key is a
    value (``ValueKeys``)."""

    def pop(kinds, shape, key):
        if _is_abstract(key):
            return jnp.zeros(shape)
        kind, values = tape.log.pop(0)
        assert kind in kinds, (kind, kinds)
        assert values.size == math.prod(shape), (values.shape, shape)
        return jnp.asarray(values.reshape(shape))

    def split(key, num=2):
        return ValueKeys.split(key, num) if _is_value_key(key) else jnp.zeros((num, 2), jnp.uint32)

    def normal(key, shape=(), dtype=jnp.float32):
        return ValueKeys.normal(key, shape, dtype) if _is_value_key(key) else pop(("normal",), shape, key).astype(dtype)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if not _is_value_key(key):
            key = pop(("uniform",), shape, key)
        return ValueKeys.uniform(key, shape, dtype, minval, maxval)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        if _is_value_key(key):
            return key.astype(dtype)
        return pop(("randint", "randint_below"), shape, key).astype(dtype)

    def categorical(key, logits, axis=-1, shape=None):
        """``jax.random.categorical``'s Gumbel-max on logged uniforms (mode
        "low": ``u`` over ``[tiny, 1)``)."""
        assert axis == -1 and shape is None
        u = jnp.maximum(jnp.finfo(logits.dtype).tiny, pop(("uniform",), logits.shape, key))
        return jnp.argmax(logits - jnp.log(-jnp.log(u)), axis=-1)

    for name, fn in (("split", split), ("normal", normal), ("uniform", uniform), ("randint", randint),
                     ("categorical", categorical)):
        monkeypatch.setattr(jax.random, name, fn)


def _t(x):
    return torch.from_numpy(np.array(x))


def cartpole_obs(rs, n):
    """States a CartPole agent meets: the pole up, the cart near the middle."""
    return (rs.uniform(-1, 1, (n, OBS)) * np.array([2.0, 2.0, 0.2, 2.0])).astype(np.float32)


def jax_fc(hidden=HIDDEN):
    return jq.FCStateQFunctionWithDiscreteAction(n_actions=ACTIONS, n_hidden_channels=hidden, n_hidden_layers=2)


class JaxPsi(nn.Module):
    """``run_iqn_cartpole``'s ``Psi`` at a given width."""

    out: int = 64
    hidden: int = 100

    @nn.compact
    def __call__(self, x):
        return nn.relu(JaxMLP(out_size=self.out, hidden_sizes=(self.hidden,))(x))


def jax_iqf(feature=8, hidden=HIDDEN):
    return jq.ImplicitQuantileQFunction(psi=JaxPsi(out=feature, hidden=hidden), n_actions=ACTIONS, n_basis_functions=64)


def port_iqf(feature=8, hidden=HIDDEN):
    return ImplicitQuantileQFunction(ReLUMLP(OBS, feature, hidden), feature, ACTIONS, n_basis_functions=64)


def assert_params(module, flax_tree, atol, what=""):
    for name, want in convert.torch_arrays(module, np_tree(flax_tree)).items():
        got = dict(module.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"{what} {name}")


# ------------------------------------------------------------ Q-functions
class JaxProbs(nn.Module):
    """x -> [B, A, N] probabilities, for the distributional wrapper."""

    @nn.compact
    def __call__(self, x):
        h = JaxMLP(out_size=ACTIONS * ATOMS, hidden_sizes=(HIDDEN,))(x)
        return jax.nn.softmax(h.reshape(x.shape[0], ACTIONS, ATOMS), axis=-1)


class Probs(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = MLP(OBS, ACTIONS * ATOMS, (HIDDEN,))

    def reset_parameters(self, generator=None):
        self.mlp.reset_parameters(generator)

    def flax_names(self):
        return {f"mlp.{k}": f"MLP_0/{v}" for k, v in self.mlp.flax_names().items()}

    def forward(self, x):
        return torch.softmax(self.mlp(x).reshape(x.shape[0], ACTIONS, ATOMS), dim=-1)


Z = tuple(np.linspace(-3.0, 7.0, ATOMS).tolist())
Q_FUNCTIONS = {
    "fc": (jax_fc, lambda: FCStateQFunctionWithDiscreteAction(OBS, ACTIONS, 2, HIDDEN)),
    "distributional_fc": (
        lambda: jq.DistributionalFCStateQFunctionWithDiscreteAction(
            n_actions=ACTIONS, n_atoms=ATOMS, v_min=0.0, v_max=500.0, n_hidden_channels=HIDDEN, n_hidden_layers=2),
        lambda: DistributionalFCStateQFunctionWithDiscreteAction(OBS, ACTIONS, ATOMS, 0.0, 500.0, 2, HIDDEN),
    ),
    "single_model": (
        lambda: jq.SingleModelStateQFunctionWithDiscreteAction(model=JaxMLP(out_size=ACTIONS, hidden_sizes=(HIDDEN,))),
        lambda: SingleModelStateQFunctionWithDiscreteAction(MLP(OBS, ACTIONS, (HIDDEN,))),
    ),
    "distributional_single_model": (
        lambda: jq.DistributionalSingleModelStateQFunctionWithDiscreteAction(model=JaxProbs(), z_values=Z),
        lambda: DistributionalSingleModelStateQFunctionWithDiscreteAction(Probs(), Z),
    ),
}


@pytest.mark.parametrize("kind", sorted(Q_FUNCTIONS))
def test_state_q_functions_match_flax(kind):
    make_jax, make_port = Q_FUNCTIONS[kind]
    obs = cartpole_obs(np.random.RandomState(0), 9)
    jmodel, model = make_jax(), make_port()
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(obs))
    convert.load_flax_params(model, np_tree(params))
    assert set(convert.torch_arrays(model, np_tree(params))) == {n for n, _ in model.named_parameters()}
    want, got = jmodel.apply(params, jnp.asarray(obs)), model(_t(obs))
    # C51's Q-values are means over atoms up to 500: held relative there.
    rtol, atol = (1e-6, 0.0) if kind == "distributional_fc" else (0.0, 1e-6)
    np.testing.assert_allclose(got.q_values.detach().numpy(), np.asarray(want.q_values), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(got.greedy_actions().numpy(), np.asarray(want.greedy_actions()))
    if kind.startswith("distributional"):
        np.testing.assert_allclose(got.q_dist.detach().numpy(), np.asarray(want.q_dist), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.z_values.numpy(), np.asarray(want.z_values))  # the support to the bit
    # Re-initialization draws every parameter from the generator.
    before = [p.detach().clone() for p in model.parameters()]
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()) if a.dim() == 2)


# -------------------------------------------------- quantiles and IQN's net
def _quantile_avs(seed=0, b=5, n=7):
    q = np.random.RandomState(seed).normal(size=(b, n, 3)).astype(np.float32)
    return JaxQuantileAV(quantiles=jnp.asarray(q)), QuantileDiscreteActionValue(quantiles=_t(q))


@pytest.mark.parametrize("accessor", ["q_values", "greedy_actions", "max", "evaluate_actions",
                                      "evaluate_actions_as_quantiles"])
def test_quantile_action_value_accessors_match_jax(accessor):
    jav, tav = _quantile_avs()
    actions = np.array([0, 2, 1, 1, 0], np.int32)
    if accessor == "q_values":
        got, want = tav.q_values, jav.q_values
    elif accessor.startswith("evaluate"):
        got, want = getattr(tav, accessor)(_t(actions)), getattr(jav, accessor)(jnp.asarray(actions))
    else:
        got, want = getattr(tav, accessor)(), getattr(jav, accessor)()
    assert tuple(got.shape) == want.shape and str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_cosine_basis_functions_match_jax():
    taus = np.random.RandomState(1).uniform(size=(6, 32)).astype(np.float32)
    taus[0, :3] = [0.0, 0.5, 1.0 - 2**-24]
    got = tquantile.cosine_basis_functions(_t(taus), 64)
    want = jquantile.cosine_basis_functions(jnp.asarray(taus), 64)
    assert got.shape == (6, 32, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _loss_inputs(seed, b=4, n=6, n_prime=5):
    rs = np.random.RandomState(seed)
    y = rs.normal(size=(b, n)).astype(np.float32) * 2
    t = rs.normal(size=(b, n_prime)).astype(np.float32) * 2
    t[0, :2] = y[0, :2]  # ties: the indicator is strict
    taus = rs.uniform(size=(b, n)).astype(np.float32)
    weights = rs.uniform(0.2, 1.0, b).astype(np.float32)
    return y, t, taus, weights


def test_elementwise_quantile_loss_matches_jax_with_a_strict_indicator():
    y, t, taus, _ = _loss_inputs(0)
    got = tquantile.eltwise_huber_quantile_loss(_t(y), _t(t), _t(taus))
    want = jquantile.eltwise_huber_quantile_loss(jnp.asarray(y), jnp.asarray(t), jnp.asarray(taus))
    assert got.shape == (4, 6, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    # Where t == y the Huber term is 0 whatever the indicator; just above,
    # t < y is false: the weight is tau, not |tau - 1|.
    y1 = np.array([[1.0]], np.float32)
    t1 = np.nextafter(y1, np.float32(2.0))
    lo = tquantile.eltwise_huber_quantile_loss(_t(y1), _t(t1), _t(np.array([[0.25]], np.float32)))
    assert float(lo[0, 0, 0]) == pytest.approx(0.25 * 0.5 * float(t1[0, 0] - 1.0) ** 2, rel=1e-3)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("batch_accumulator", ["mean", "sum"])
def test_quantile_loss_accumulations_match_jax(weighted, batch_accumulator):
    y, t, taus, weights = _loss_inputs(1)
    el = jquantile.eltwise_huber_quantile_loss(jnp.asarray(y), jnp.asarray(t), jnp.asarray(taus))
    tel = _t(np.asarray(el))
    if weighted:
        got = tquantile.weighted_quantile_loss_accumulate(tel, _t(weights), batch_accumulator)
        want = jquantile.weighted_quantile_loss_accumulate(el, jnp.asarray(weights), batch_accumulator)
    else:
        got = tquantile.quantile_loss_accumulate(tel, batch_accumulator)
        want = jquantile.quantile_loss_accumulate(el, batch_accumulator)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    w = (_t(weights), jnp.asarray(weights)) if weighted else (None, None)
    yt = _t(y).requires_grad_(True)
    got_all = tquantile.quantile_huber_loss(yt, _t(t), _t(taus), w[0], batch_accumulator)
    want_all = jquantile.quantile_huber_loss(jnp.asarray(y), jnp.asarray(t), jnp.asarray(taus), w[1],
                                             batch_accumulator)
    np.testing.assert_allclose(float(got_all), float(want_all), rtol=1e-6)
    got_grad, = torch.autograd.grad(got_all, yt)
    want_grad = jax.grad(lambda v: jquantile.quantile_huber_loss(v, jnp.asarray(t), jnp.asarray(taus), w[1],
                                                                 batch_accumulator))(jnp.asarray(y))
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tquantile.quantile_loss_accumulate(tel, "max")


def test_implicit_quantile_q_function_matches_flax():
    rs = np.random.RandomState(2)
    obs, taus = cartpole_obs(rs, 6), rs.uniform(size=(6, 32)).astype(np.float32)
    jmodel, model = jax_iqf(), port_iqf()
    params = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(obs), jnp.asarray(taus))
    arrays = convert.torch_arrays(model, np_tree(params))
    assert set(arrays) == {n for n, _ in model.named_parameters()}
    assert arrays["phi.weight"].shape == (8, 64) and arrays["head.weight"].shape == (ACTIONS, 8)
    assert arrays["psi.mlp.layers.0.weight"].shape == (HIDDEN, OBS)
    convert.load_flax_params(model, np_tree(params))
    want = jmodel.apply(params, jnp.asarray(obs), jnp.asarray(taus))
    got = model(_t(obs), _t(taus))
    assert got.quantiles.shape == (6, 32, ACTIONS)
    np.testing.assert_allclose(got.quantiles.detach().numpy(), np.asarray(want.quantiles), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.greedy_actions().numpy(), np.asarray(want.greedy_actions()))


# ---------------------------------------------------------------- noisy Q
def _train_dqn_ale():
    spec = importlib.util.spec_from_file_location("train_dqn_ale", os.path.join(REPO, "examples/atari/train_dqn_ale.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_noisy_nature_q_matches_train_dqn_ale_noisy_net(monkeypatch):
    """``build_model`` of ``train_dqn_ale.py --noisy-net-sigma 0.5``: the
    ``ConvQ`` whose head is a factorized noisy layer; its noise by value."""
    ale = _train_dqn_ale()
    args = types.SimpleNamespace(noisy_net_sigma=0.5, arch="nature")
    jmodel = ale.build_model(6, args)
    model = NatureQ(6, dense_cls=to_factorized_noisy(torch.nn.Linear, sigma_scale=0.5))
    assert isinstance(model.head, FactorizedNoisyLinear) and model.head.sigma_scale == 0.5
    frames = np.random.RandomState(3).randint(0, 256, (3, 84, 84, 4)).astype(np.float32) / 255.0
    params = jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.asarray(frames))
    convert.load_flax_params(model, np_tree(params))
    log = record_normals(monkeypatch)
    want = jmodel.apply(params, jnp.asarray(frames), rngs={"noise": jax.random.PRNGKey(2)})
    assert [x.shape for x in log] == [(512,), (6,)]  # eps_in, then eps_out
    got = model(_t(frames), ReplayedNormals(log))
    np.testing.assert_allclose(got.q_values.detach().numpy(), np.asarray(want.q_values), rtol=0, atol=1e-6)
    # The recipe: Greedy with the noisy net, epsilon-greedy without.
    core, _ = ale.build_core_and_buffer(6, types.SimpleNamespace(
        noisy_net_sigma=0.5, arch="nature", double=False, lr=1e-4, bf16=False, prioritized=False,
        replay_capacity=1024, num_step_return=1, num_envs=4, final_epsilon=0.1, final_exploration_frames=100))
    runner = make_dqn_runner(num_envs=4, capacity=64, noisy_net_sigma=0.5, device="cpu")
    assert type(core.explorer).__name__ == type(runner.core.explorer).__name__ == "Greedy"
    assert isinstance(runner.core.model.head, FactorizedNoisyLinear)
    assert isinstance(make_dqn_runner(num_envs=4, capacity=64, device="cpu").core.explorer,
                      texplorers.LinearDecayEpsilonGreedy)
    names = model.flax_names()
    assert names["head"] == "FactorizedNoisyDense_0" and NatureQ(6).flax_names()["head"] == "Dense_0"


# ---------------------------------------------------------------- explorers
@pytest.mark.parametrize("epsilon", [0.0, 0.3])
def test_constant_epsilon_greedy_draws_even_at_zero(monkeypatch, epsilon):
    greedy = np.zeros(64, np.int32)
    tape = Tape(0)
    got = texplorers.ConstantEpsilonGreedy(epsilon, ACTIONS).select_action(tape, 5, _t(greedy))
    assert [k for k, _ in tape.log] == ["uniform", "randint"]
    install_tape(monkeypatch, tape)
    jx = jexplorers.ConstantEpsilonGreedy(epsilon, ACTIONS)
    want = jx.select_action(jax.random.PRNGKey(0), jnp.int32(5), jnp.asarray(greedy))
    assert not tape.log
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (epsilon == 0.0) == np.array_equal(got.numpy(), greedy)
    assert texplorers.ConstantEpsilonGreedy(epsilon, ACTIONS).epsilon_at(9) == float(jx.epsilon_at(jnp.int32(9)))


def test_exponential_decay_epsilon_is_jax_within_an_ulp_and_acts_alike(monkeypatch):
    tx = texplorers.ExponentialDecayEpsilonGreedy(1.0, 0.05, 0.9995, ACTIONS)
    jx = jexplorers.ExponentialDecayEpsilonGreedy(1.0, 0.05, 0.9995, ACTIONS)
    for t in (0, 1, 7, 1_000, 5_987, 6_000, 2**24 + 3, 10**9):
        got, want = tx.epsilon_at(t), np.float32(jx.epsilon_at(jnp.int32(t)))
        assert abs(np.float32(got) - want) <= np.spacing(want), t
    assert tx.epsilon_at(10**6) == np.float32(0.05) and tx.epsilon_at(0) == 1.0
    greedy = np.zeros(64, np.int32)
    tape = Tape(1)
    got = tx.select_action(tape, 1_500, _t(greedy))
    install_tape(monkeypatch, tape)
    want = jx.select_action(jax.random.PRNGKey(0), jnp.int32(1_500), jnp.asarray(greedy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.float().mean() < 1  # both explored and greedy lanes


def test_boltzmann_samples_like_jax_categorical(monkeypatch):
    q = np.random.RandomState(4).normal(size=(200, 3)).astype(np.float32)
    greedy = np.argmax(q, -1).astype(np.int32)
    tape = Tape(2)
    got = texplorers.Boltzmann(T=0.5).select_action(tape, 0, _t(greedy), DiscreteActionValue(_t(q)))
    assert [k for k, _ in tape.log] == ["uniform"] and got.dtype == torch.int32
    install_tape(monkeypatch, tape)
    want = jexplorers.Boltzmann(T=0.5).select_action(
        jax.random.PRNGKey(0), jnp.int32(0), jnp.asarray(greedy), jq.DiscreteActionValueHead().apply({}, jnp.asarray(q)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.5 < float((got.numpy() == greedy).mean()) < 1.0
    with pytest.raises(ValueError):
        texplorers.Boltzmann().select_action(tape, 0, _t(greedy))


# ---------------------------------------------------------------- the cores
def value_batch(seed, b=8, discount=0.99):
    rs = np.random.RandomState(seed)
    return dict(
        obs=cartpole_obs(rs, b),
        action=rs.randint(0, ACTIONS, b).astype(np.int32),
        reward=(rs.normal(size=b) * 2).astype(np.float32),
        next_obs=cartpole_obs(rs, b),
        discount=np.full(b, discount, np.float32),
        is_terminal=np.array([False, False, True, False] * (b // 4)),
        weight=rs.uniform(0.2, 1.0, b).astype(np.float32),
        indices=np.arange(b, dtype=np.int32),
    )


def _clip_adam(max_norm):
    if max_norm is None:
        return optax.adam(1e-3), Adam(1e-3)
    return optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(1e-3)), ClipByGlobalNorm(max_norm, Adam(1e-3))


CORES = {  # kind -> (JAX core class, port core class, extra arguments, clip norm)
    "al": (JaxAL, ALCore, dict(alpha=0.9), 10.0),
    "pal": (JaxPAL, PALCore, dict(alpha=0.7), 0.5),
    "double_pal": (JaxDoublePAL, DoublePALCore, dict(alpha=0.9), None),
    "dpp": (JaxDPP, DPPCore, dict(eta=2.0), 10.0),
    "iqn": (JaxIQN, IQNCore, dict(quantile_thresholds_N=6, quantile_thresholds_N_prime=5,
                                  quantile_thresholds_K=4), None),
    "double_iqn": (JaxDoubleIQN, DoubleIQNCore, dict(quantile_thresholds_N=6, quantile_thresholds_N_prime=5,
                                                     quantile_thresholds_K=4), 1.0),
}


def make_cores(kind):
    jcls, tcls, extra, max_norm = CORES[kind]
    jopt, topt = _clip_adam(max_norm)
    iqn = "iqn" in kind
    jcore = jcls(model=jax_iqf() if iqn else jax_fc(), optimizer=jopt, explorer=None, gamma=0.99, **extra)
    tcore = tcls(model=port_iqf() if iqn else FCStateQFunctionWithDiscreteAction(OBS, ACTIONS, 2, HIDDEN),
                 optimizer=topt, explorer=None, gamma=0.99, **extra)
    return jcore, tcore


def warm_state(jcore, tcore):
    """A JAX state a step in (target apart, moments nonzero) and the port's
    conversion of it. IQN's warm-up draws its taus from a real key."""
    obs0 = jnp.zeros((1, OBS))
    js = jcore.init(jax.random.PRNGKey(0), obs0)
    js = js.replace(target_params=jcore.init(jax.random.PRNGKey(1), obs0).params)
    js, _ = jcore.update(js, jax.random.PRNGKey(2), JaxBatch(**value_batch(0)))
    ts = convert.dqn_state_from_flax(tcore, np_tree(js.params), np_tree(js.target_params),
                                     opt_state=np_tree(js.opt_state), n_updates=int(js.n_updates), device="cpu")
    return js, ts


@pytest.mark.parametrize("kind", sorted(CORES))
def test_core_update_matches_jax_from_converted_state(monkeypatch, kind):
    jcore, tcore = make_cores(kind)
    js, ts = warm_state(jcore, tcore)
    assert ts.n_updates == 1
    b = value_batch(1)
    tape = Tape(3)
    ts, taux = tcore.update(ts, TransitionBatch(**{k: _t(v) for k, v in b.items()}), tape)
    kinds = [k for k, _ in tape.log]
    assert kinds == ({"iqn": ["uniform"] * 2, "double_iqn": ["uniform"] * 3}.get(kind, []))
    with pytest.MonkeyPatch.context() as mp:
        install_tape(mp, tape)
        js, jaux = jcore.update(js, jax.random.PRNGKey(4), JaxBatch(**b))
        assert not tape.log
    assert ts.n_updates == int(js.n_updates) == 2
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux["errors"].numpy(), np.asarray(jaux["errors"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(taux["average_q"]), float(jaux["average_q"]), rtol=1e-5, atol=1e-6)
    assert float(taux["loss"]) > 0 and taux["errors"].shape == (8,)
    assert_params(ts.model, js.params, 1e-6, kind)
    assert_params(ts.target_model, js.target_params, 0.0, kind)
    adam = js.opt_state[1][0] if CORES[kind][3] is not None else js.opt_state[0]
    opt = ts.opt_state
    assert opt.count == int(adam.count) == 2
    names = [n for n, _ in ts.model.named_parameters()]
    for moments, tree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        want = convert.torch_arrays(ts.model, np_tree(tree))
        for name, m in zip(names, moments):
            atol = 1e-5 * float(np.abs(want[name]).max()) + 1e-12
            np.testing.assert_allclose(m.numpy(), want[name], rtol=1e-4, atol=atol, err_msg=f"{kind} {name}")


def test_pal_targets_take_the_smaller_gap_and_double_pal_a_fourth_forward():
    """The forwards AL, PAL and DPP make (three) and DoublePAL (four), in
    the JAX cores' order: online on obs, target on obs, target on next_obs
    (and online on next_obs)."""
    calls = []

    class Recording(FCStateQFunctionWithDiscreteAction):
        def forward(self, x, draws=None):
            calls.append(x)
            return super().forward(x, draws)

    b = TransitionBatch(**{k: _t(v) for k, v in value_batch(5).items()})
    for cls, n in ((ALCore, 3), (PALCore, 3), (DPPCore, 3), (DoublePALCore, 4)):
        core = cls(Recording(OBS, ACTIONS, 2, HIDDEN), Adam(1e-3), None)
        state = core.init(torch.Generator().manual_seed(0), b.obs)
        calls.clear()
        core.compute_y_and_t(state.model, state.target_model, b)
        assert len(calls) == n, cls
        assert [torch.equal(c, b.obs) for c in calls] == [True, True, False, False][:n], cls


# ------------------------------------------------------------ the converter
def test_chain_state_round_trips_through_the_converter():
    """``optax.chain(clip_by_global_norm, adam)``: the moments sit at
    ``opt_state[1][0]``; converted, then one more update on each side."""
    jopt, topt = _clip_adam(1.0)
    jcore = JaxDQNCore(model=jax_fc(), optimizer=jopt, explorer=None, gamma=0.99)
    tcore = DQNCore(model=FCStateQFunctionWithDiscreteAction(OBS, ACTIONS, 2, HIDDEN), optimizer=topt,
                    explorer=None, gamma=0.99)
    js = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    for k in range(3):
        js, _ = jcore.update(js, jax.random.PRNGKey(k), JaxBatch(**value_batch(k)))
    assert isinstance(js.opt_state[0], optax.EmptyState)
    ts = convert.dqn_state_from_flax(tcore, np_tree(js.params), np_tree(js.target_params),
                                     opt_state=np_tree(js.opt_state), n_updates=int(js.n_updates), device="cpu")
    adam = js.opt_state[1][0]
    assert ts.n_updates == 3 and ts.opt_state.count == int(adam.count) == 3
    names = [n for n, _ in ts.model.named_parameters()]
    for moments, tree in ((ts.opt_state.mu, adam.mu), (ts.opt_state.nu, adam.nu)):
        want = convert.torch_arrays(ts.model, np_tree(tree))
        for name, m in zip(names, moments):
            np.testing.assert_array_equal(m.numpy(), want[name])
    assert float(ts.opt_state.nu[0].abs().max()) > 0
    b = value_batch(7)
    js, jaux = jcore.update(js, jax.random.PRNGKey(9), JaxBatch(**b))
    ts, taux = tcore.update(ts, TransitionBatch(**{k: _t(v) for k, v in b.items()}))
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert_params(ts.model, js.params, 1e-6, "chain")


def test_every_converter_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layer = torch.nn.Linear(1, 1)
    core = types.SimpleNamespace(model=layer, policy=layer, q_func=layer, q_func1=layer, q_func2=layer, vf=layer)
    for fn in (convert.actor_critic_state_from_flax, convert.td3_state_from_flax, convert.sac_state_from_flax,
               convert.ppo_state_from_flax, convert.trpo_state_from_flax):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(core, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.dqn_state_from_flax(core, {}, {}, {})
