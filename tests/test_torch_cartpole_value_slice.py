"""The discrete value family on CartPole as a whole, at a small width: the
DQN, C51, Rainbow-CartPole, AL and IQN recipes of
``experiments/cartpole_value.py`` through the port's ``OffPolicyRunner``,
against the JAX package's own ``OffPolicyRunner.run_chunk`` on the same
draws, and ``EvalLoop`` against ``JaxEvalLoop``.

The port draws from ``Tape`` (``test_torch_value_modules.py``). The JAX
runner runs under ``jax.disable_jit`` (its scans, loops and conds then run
as Python, in program order) with ``install_tape``: every draw it makes
from a key pops the port's next logged draw, checked by kind and size, so
each act step's noise, taus and explorer draws, each env reset, each scan
step's minibatch ids or each PER sample, and each update's noise and taus
are the port's. Its vector env is handed each step's resets by value
(:class:`TapeEnv`). The log must be empty at the end.

Sizes: 4 lanes, hidden 16 (IQN: features 8, 8 taus), batch 8, a 40-slot
ring that wraps, 2 updates per scan step from 12 transitions on, target
syncs every 24, epsilon 1 -> 0.05 over 40 transitions, CartPole cut to 10
steps so that lanes are truncated; 11 scan steps (18 updates, one sync
at 24). Rainbow-CartPole: 3-step PER (alpha 0.5, beta
annealed over 100 samples), its noise and its epsilon-0 explorer's draws
by value.

Tolerances: counters, flags, ids and actions exact; observations in the
ring 1e-5 (CartPole's ``sin``/``cos`` round an ulp apart and the pole
integrates it); losses, priorities and parameters within 2e-5 (Adam at
1e-3 over 18 updates, ROADMAP C22), losses relative; evaluation returns
exact.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import JaxPsi, Tape, install_tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.action_value import DistributionalDiscreteActionValue as JaxDistAV
from pfrl_tpu.agents.al import ALCore as JaxAL
from pfrl_tpu.agents.categorical_dqn import CategoricalDoubleDQNCore as JaxCategoricalDouble
from pfrl_tpu.agents.categorical_dqn import CategoricalDQNCore as JaxCategorical
from pfrl_tpu.agents.dqn import DQNCore as JaxDQN
from pfrl_tpu.agents.iqn import IQNCore as JaxIQN
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
from pfrl_tpu.experiments import RunnerConfig as JaxConfig
from pfrl_tpu.experiments.runner import RunnerState as JaxRunnerState
from pfrl_tpu.models import MLP as JaxMLP
from pfrl_tpu.models.noisy_linear import FactorizedNoisyDense
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.agents import ALCore, CategoricalDoubleDQNCore, CategoricalDQNCore, DQNCore, IQNCore
from pfrl_tpu_torch.experiments import cartpole_value as cv
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.explorers import ConstantEpsilonGreedy, LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam, ClipByGlobalNorm
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer

torch.set_num_threads(1)

LANES, HIDDEN, FEATURES, TAUS, BATCH, CAPACITY = 4, 16, 8, 8, 8, 40
START, SYNC_EVERY, DECAY, LIMIT, STEPS = 12, 24, 40, 10, 11
SMALL = dict(num_envs=LANES, capacity=CAPACITY, replay_start_size=START, update_interval=2,
             target_update_interval=SYNC_EVERY, minibatch_size=BATCH)
# xdist hands out whole files: the AL and IQN runs are held by
# ``test_torch_zoo_value.py`` through the same functions.
KINDS = ("dqn", "c51", "rainbow")


# ------------------------------------------------------ the JAX recipes
class JaxRainbowHead(nn.Module):
    """``tools/record_curves.py:962-978``'s ``RainbowHead`` at a given width."""

    hidden: int = 128
    n_actions: int = 2

    @nn.compact
    def __call__(self, x):
        n_atoms = 51
        h = nn.relu(JaxMLP(out_size=self.hidden, hidden_sizes=(self.hidden,))(x))
        h_a, h_v = jnp.split(h, 2, axis=-1)
        a = FactorizedNoisyDense(features=self.n_actions * n_atoms, sigma_scale=0.5)(h_a).reshape(
            -1, self.n_actions, n_atoms)
        a = a - jnp.mean(a, axis=1, keepdims=True)
        v = FactorizedNoisyDense(features=n_atoms, sigma_scale=0.5)(h_v)[:, None, :]
        q_dist = nn.softmax(a + v, axis=-1)
        z = jnp.linspace(0.0, 500.0, n_atoms, dtype=jnp.float32)
        return JaxDistAV(q_dist=q_dist, z_values=z)


def jax_core(kind, hidden, decay_steps, feature_size=64, n_taus=32):
    """The recipe's JAX core (``tools/record_curves.py``) at a given width."""
    fc = jq.FCStateQFunctionWithDiscreteAction(n_actions=2, n_hidden_channels=hidden, n_hidden_layers=2)
    explorer = jexplorers.LinearDecayEpsilonGreedy(1.0, 0.05, decay_steps, 2)
    clipped = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-3))
    if kind == "dqn":
        return JaxDQN(model=fc, optimizer=clipped, explorer=explorer, gamma=0.99)
    if kind == "al":
        return JaxAL(model=fc, optimizer=clipped, explorer=explorer, gamma=0.99)
    if kind == "c51":
        model = jq.DistributionalFCStateQFunctionWithDiscreteAction(
            n_actions=2, n_atoms=51, v_min=0.0, v_max=500.0, n_hidden_channels=hidden, n_hidden_layers=2)
        return JaxCategorical(model=model, optimizer=optax.adam(1e-3), explorer=explorer, gamma=0.99)
    if kind == "rainbow":
        return JaxCategoricalDouble(model=JaxRainbowHead(hidden=hidden), optimizer=optax.adam(1e-3, eps=1.5e-4),
                                    explorer=jexplorers.ConstantEpsilonGreedy(0.0, 2), gamma=0.99)
    model = jq.ImplicitQuantileQFunction(psi=JaxPsi(out=feature_size, hidden=hidden), n_actions=2,
                                         n_basis_functions=64)
    return JaxIQN(model=model, optimizer=optax.adam(1e-3), explorer=explorer, gamma=0.99,
                  quantile_thresholds_N=n_taus, quantile_thresholds_N_prime=n_taus, quantile_thresholds_K=n_taus)


def port_recipe(kind, env, **sizes):
    make = {"dqn": cv.make_dqn_cartpole_runner, "c51": cv.make_c51_cartpole_runner,
            "rainbow": cv.make_rainbow_cartpole_runner, "al": cv.make_al_cartpole_runner,
            "iqn": cv.make_iqn_cartpole_runner}[kind]
    return make(env=env, device="cpu", **sizes)


def port_state(core, jtrain):
    """The JAX train state, converted: weights, target, optimizer state."""
    return convert.dqn_state_from_flax(core, np_tree(jtrain.params), np_tree(jtrain.target_params),
                                       opt_state=np_tree(jtrain.opt_state), n_updates=int(jtrain.n_updates),
                                       device="cpu")


class TapeEnv(VectorJaxEnv):
    """``VectorJaxEnv`` whose resets are the port's next logged uniform
    draw, handed to CartPole's vmapped reset by value."""

    def __init__(self, env, num_envs, tape):
        super().__init__(env, num_envs)
        self.tape = tape

    def _reset_keys(self):
        (u,) = self.tape.take("uniform")
        return jnp.asarray(u.reshape(self.num_envs, 4))

    def reset(self, rng):
        return super().reset(self._reset_keys())

    def step(self, rng, states, actions):
        reset = self._reset_keys()
        return super().step(jnp.concatenate([jnp.zeros_like(reset), reset]), states, actions)


def _small_sizes(kind):
    extra = {"rainbow": dict(hidden=HIDDEN, betasteps=100), "iqn": dict(hidden=HIDDEN, feature_size=FEATURES,
                                                                          n_taus=TAUS, decay_steps=DECAY)}
    return {**SMALL, **extra.get(kind, dict(hidden=HIDDEN, decay_steps=DECAY))}


def _run_jax(jcore, jtrain, buffer, tape):
    """The JAX package's ``OffPolicyRunner.run_chunk`` on the port's draws."""
    jenv = jenvs.TimeLimit(jenvs.CartPole(), LIMIT)
    config = JaxConfig(num_envs=LANES, replay_start_size=START, update_interval=2,
                       target_update_interval=SYNC_EVERY, minibatch_size=BATCH)
    jrunner = JaxRunner(jenv, jcore, buffer, config)
    jrunner.env = TapeEnv(jenv, LANES, tape)
    env_states, obs = jrunner.env.reset(None)
    example = JaxTransition(obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()), next_obs=obs[0],
                            terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict())
    state = JaxRunnerState(
        env_states=env_states, obs=obs, train_state=jtrain, replay_state=buffer.init(example),
        rng=jnp.zeros((2,), jnp.uint32), t=jnp.int32(0), episode_return=jnp.zeros(LANES),
        recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0),
    )
    with jax.disable_jit():
        state, metrics = jrunner.run_chunk(state, STEPS)
    assert not tape.log  # every draw the port made was replayed
    return jrunner, state, metrics


def small_run(kind):
    """The port's small run of one recipe and the JAX runner's on its draws."""
    env = tenvs.TimeLimit(tenvs.CartPole(device="cpu"), LIMIT)
    runner, eval_loop = port_recipe(kind, env, **_small_sizes(kind))
    jcore = jax_core(kind, HIDDEN, DECAY, FEATURES, TAUS)
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, 4)))
    tape = Tape(0)
    state = runner.init(0, draws=tape)
    state.train_state = port_state(runner.core, jtrain)
    state, metrics = runner.run_chunk(state, STEPS)
    kinds = [k for k, _ in tape.log]
    per = dict(alpha=0.5, beta0=0.4, betasteps=100, num_steps=3, gamma=0.99, num_lanes=LANES)
    buffer = JaxPER(CAPACITY, **per) if kind == "rainbow" else JaxReplay(CAPACITY, gamma=0.99, num_lanes=LANES)
    with pytest.MonkeyPatch.context() as mp:
        install_tape(mp, tape)
        jax_run = _run_jax(jcore, jtrain, buffer, tape)
    return dict(runner=runner, eval_loop=eval_loop, state=state, metrics=metrics, kinds=kinds, jax=jax_run,
                jcore=jcore)


def assert_matches_jax_runner(run, kind):
    runner, state, metrics = run["runner"], run["state"], run["metrics"]
    jrunner, jstate, jmetrics = run["jax"]
    cfg = runner.config
    assert cfg.updates_per_step == 2
    update_steps = sum(1 for k in range(1, STEPS + 1) if k * LANES >= START)
    n_updates = update_steps * cfg.updates_per_step
    assert state.t == int(jstate.t) == STEPS * LANES
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates) == n_updates == 18

    # The draws, by kind: per act step the noise (Rainbow: 4 normals), the
    # taus (IQN) and the explorer's two; per scan step the resets; per scan
    # step with updates one id draw (uniform ring) or per update one PER
    # sample and 12 normals (Rainbow), or two tau draws per update (IQN).
    count = run["kinds"].count
    assert count("randint") == STEPS
    if kind == "rainbow":
        assert count("normal") == 4 * STEPS + 12 * n_updates and count("randint_below") == 0
        assert count("uniform") == 1 + STEPS + STEPS + n_updates
    else:
        assert count("normal") == 0 and count("randint_below") == update_steps
        assert count("uniform") == 1 + 2 * STEPS + (STEPS + 2 * n_updates if kind == "iqn" else 0)

    ring, jring = state.replay_state, jstate.replay_state
    if kind == "rainbow":
        ring, jring = ring.base, jring.base
    assert int(ring.cursor) == int(jring.cursor) == STEPS * LANES > CAPACITY
    storage = ring.storage
    for name in ("action", "terminated", "done"):
        np.testing.assert_array_equal(storage[name].numpy(), np.asarray(getattr(jring.storage, name)), err_msg=name)
    np.testing.assert_allclose(storage["obs"].numpy(), np.asarray(jring.storage.obs), rtol=0, atol=1e-5)
    assert (storage["done"] & ~storage["terminated"]).any()  # truncated by the time limit

    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]), rtol=2e-5, atol=1e-7)
    np.testing.assert_array_equal(metrics["done_count"].numpy(), np.asarray(jmetrics["done_count"]))
    assert (metrics["loss"][: START // LANES - 1] == 0).all() and (metrics["loss"][START // LANES - 1:] > 0).all()
    assert int(state.recent_count) == int(jstate.recent_count) > 0
    np.testing.assert_allclose(runner.recent_return_mean(state), jrunner.recent_return_mean(jstate), rtol=1e-6)

    for module, tree in ((ts.model, jts.params), (ts.target_model, jts.target_params)):
        for name, want in convert.torch_arrays(module, np_tree(tree)).items():
            got = dict(module.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=f"{kind} {name}")
    # The sync at 24 copied the online net of then; updates went on.
    target = dict(ts.target_model.named_parameters())
    assert all(not torch.equal(p, target[n]) for n, p in ts.model.named_parameters() if p.dim() == 2)
    if kind == "rainbow":
        tr, jr = state.replay_state, jstate.replay_state
        np.testing.assert_allclose(tr.tree.numpy(), np.asarray(jr.tree), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(tr.min_tree.numpy(), np.asarray(jr.min_tree), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(float(tr.max_priority), float(jr.max_priority), rtol=2e-5)
        np.testing.assert_allclose(float(tr.beta), float(jr.beta), rtol=1e-6)
        assert float(tr.beta) > 0.4 and ts.opt_state.count == int(jts.opt_state[0].count)


def assert_eval_matches_jax(run, kind):
    """``JaxEvalLoop`` un-jitted on the port's draws: the start states and
    each step's resets, and Rainbow-CartPole's noise on every step."""
    lanes, max_steps = 5, LIMIT + 3
    tape = Tape(1)
    loop = EvalLoop(run["runner"].env.env, run["runner"].core, lanes, max_steps, device="cpu")
    got = loop.evaluate(run["state"].train_state, tape)
    assert [k for k, _ in tape.log].count("normal") == (4 * max_steps if kind == "rainbow" else 0)
    jenv = jenvs.TimeLimit(jenvs.CartPole(), LIMIT)
    jloop = JaxEvalLoop(jenv, run["jcore"], lanes, max_steps)
    jloop.env = TapeEnv(jenv, lanes, tape)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        want = jloop.evaluate(run["jax"][1].train_state, jnp.zeros((2,), jnp.uint32))
    assert not tape.log
    assert got.shape == want.shape == (lanes,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all() and (got <= LIMIT).all()


@pytest.fixture(scope="module")
def trained():
    return {kind: small_run(kind) for kind in KINDS}


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("kind", KINDS)
def test_recipe_matches_the_jax_runner_over_updates_and_a_sync(trained, kind):
    assert_matches_jax_runner(trained[kind], kind)


@pytest.mark.parametrize("kind", KINDS)
def test_eval_loop_matches_jax_eval_loop_on_the_same_draws(trained, kind):
    assert_eval_matches_jax(trained[kind], kind)


def test_recipes_hold_the_published_widths_and_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = {"dqn": cv.make_dqn_cartpole_runner, "c51": cv.make_c51_cartpole_runner,
              "rainbow": cv.make_rainbow_cartpole_runner, "al": cv.make_al_cartpole_runner,
              "iqn": cv.make_iqn_cartpole_runner, "example": cv.make_dqn_cartpole_example_runner}
    for make in makers.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    recipes = {k: make(device="cpu", capacity=1_024) for k, make in makers.items()}
    for kind, (runner, loop) in recipes.items():
        cfg, env = runner.config, runner.env.env
        example = kind == "example"
        want = (128, 1_000, 32, 2_000, 128, 4) if example else (32, 1_024, 4, 1_024, 64, 8)
        assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
                cfg.minibatch_size, cfg.updates_per_step) == want, kind
        assert isinstance(env, tenvs.TimeLimit) and isinstance(env.env, tenvs.CartPole) and env.max_steps == 500
        assert (loop.env.num_envs, loop.max_steps) == ((16, 500) if example else (10, 501))
        assert loop.core is runner.core and runner.core.gamma == 0.99
        buf = runner.buffer
        assert (buf.gamma, buf.num_lanes) == (0.99, cfg.num_envs) and buf.store_next_obs
        if kind == "rainbow":
            assert isinstance(buf, PrioritizedReplayBuffer) and not buf.iid_samples
            assert (buf.alpha, buf.beta0, buf.num_steps, buf.beta_add) == (0.5, 0.4, 3, (1.0 - 0.4) / 300_000)
        else:
            assert isinstance(buf, ReplayBuffer) and buf.iid_samples and buf.num_steps == 1
        explorer = runner.core.explorer
        if kind == "rainbow":
            assert isinstance(explorer, ConstantEpsilonGreedy) and explorer.epsilon == 0.0
        else:
            assert isinstance(explorer, LinearDecayEpsilonGreedy)
            assert (explorer.start_epsilon, explorer.end_epsilon, explorer.decay_steps) == (
                1.0, 0.05, 100_000 if example else 50_000)
    cores = {k: r.core for k, (r, _) in recipes.items()}
    assert type(cores["dqn"]) is DQNCore and type(cores["example"]) is DQNCore and type(cores["al"]) is ALCore
    assert type(cores["c51"]) is CategoricalDQNCore and type(cores["rainbow"]) is CategoricalDoubleDQNCore
    assert type(cores["iqn"]) is IQNCore and cores["al"].alpha == 0.9
    assert (cores["iqn"].N, cores["iqn"].N_prime, cores["iqn"].K) == (32, 32, 32)
    for kind in ("dqn", "al"):
        opt = cores[kind].optimizer
        assert isinstance(opt, ClipByGlobalNorm) and opt.max_norm == 10.0 and opt.inner.learning_rate == 1e-3
    for kind, eps in (("c51", 1e-8), ("iqn", 1e-8), ("example", 1e-8), ("rainbow", 1.5e-4)):
        opt = cores[kind].optimizer
        assert isinstance(opt, Adam) and (opt.learning_rate, opt.eps) == (1e-3, eps)
    widths = {k: [tuple(layer.weight.shape) for layer in cores[k].model.mlp.layers] for k in ("dqn", "al", "c51")}
    assert widths["dqn"] == widths["al"] == [(100, 4), (100, 100), (2, 100)]
    assert widths["c51"] == [(100, 4), (100, 100), (102, 100)]
    assert [tuple(layer.weight.shape) for layer in cores["example"].model.mlp.layers] == [(128, 4), (128, 128), (2, 128)]
    assert cores["c51"].model.z_values[-1] == 500.0 and cores["c51"].model.z_values.shape == (51,)
    head = cores["rainbow"].model
    assert [tuple(layer.weight.shape) for layer in head.mlp.layers] == [(128, 4), (128, 128)]
    assert head.advantage.w_mu.shape == (102, 64) and head.value.w_mu.shape == (51, 64)
    assert head.advantage.sigma_scale == head.value.sigma_scale == 0.5
    iqf = cores["iqn"].model
    assert [tuple(layer.weight.shape) for layer in iqf.psi.mlp.layers] == [(100, 4), (64, 100)]
    assert iqf.phi.weight.shape == (64, 64) and iqf.head.weight.shape == (2, 64)
