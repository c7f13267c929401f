"""The AtariSim examples the port now runs at their own settings, against
the examples' own JAX code (loaded from ``examples/atari/``):

- ``train_dqn_ale.py --sim`` (``experiments/atari_dqn_ale.py``): the
  ``nips`` ``ConvQ`` (``SmallAtariCNN`` -> Dense) and the ``dueling``
  ``DuelingDQN`` (and the ``nature`` ``ConvQ``), from ``build_model``;
- ``train_categorical_dqn_ale.py --sim`` (``experiments/atari_c51.py``):
  ``C51Q`` (``LargeAtariCNN`` -> Dense(6 * 51) -> softmax on
  ``linspace(-10, 10)``).

Each network's forward from the same (converted) weights within 1e-6
relative (C28: matmuls and convolutions reduce in another order; C51's
Q-values, means over atoms on [-10, 10] that cancel, relative to the
support's scale, and its probabilities within 1e-9 absolute); one and
three updates of the recipes' cores (the example's ``build_core_and_buffer``
and C51's ``run_sim`` core) on the same batch, parameters within 1e-6
after one and 3e-6 after three (C22), losses 1e-5 relative; and 8 scan
steps of each recipe at 4 lanes and a ring that wraps, through the port's
``OffPolicyRunner`` against the JAX package's ``OffPolicyRunner.run_chunk``
under ``jax.disable_jit`` on the port's draws (``install_tape``; the
updates, which draw nothing, run jitted inside the eager runner), with
replay start 16, batch 8 and a target sync at 24: five updates. The
``--prioritized`` run samples through the prefix sample's plain version on
the CPU against the JAX package's tree descent (``use_pallas="auto"``,
XLA's on the CPU). Rings, counters, flags and actions exact; losses 2e-5
relative; parameters and priorities 2e-5.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import replay_buffers as jreplay
from pfrl_tpu.agents import CategoricalDQNCore as JaxCategorical
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
from pfrl_tpu.experiments import RunnerConfig as JaxConfig
from pfrl_tpu.experiments.runner import RunnerState as JaxRunnerState
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.replay import TransitionBatch as JaxBatch
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import CategoricalDQNCore, DoubleDQNCore, DQNCore
from pfrl_tpu_torch.experiments import atari_c51, atari_dqn_ale
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.models import SmallAtariCNN
from pfrl_tpu_torch.ops.prefix_sample import prefix_sample
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import DuelingDQN
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer, TransitionBatch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES, CAPACITY, START, SYNC_EVERY, BATCH, DECAY, STEPS = 4, 24, 16, 24, 8, 100, 8


def load_example(relpath):
    spec = importlib.util.spec_from_file_location(relpath.replace("/", "_")[:-3], os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ALE = load_example("examples/atari/train_dqn_ale.py")
C51 = load_example("examples/atari/train_categorical_dqn_ale.py")


def _args(arch="nature", double=False, prioritized=False, capacity=CAPACITY):
    """``train_dqn_ale.py``'s arguments, small."""
    return types.SimpleNamespace(
        noisy_net_sigma=None, arch=arch, double=double, prioritized=prioritized, lr=2.5e-4, bf16=False,
        replay_capacity=capacity, num_step_return=1, num_envs=LANES, final_epsilon=0.01,
        final_exploration_frames=DECAY, steps=400, update_interval=4)


def jax_c51_core(batch_size=32, decay=DECAY):
    """``train_categorical_dqn_ale.py``'s ``run_sim`` core (its decay cut):
    Adam's eps is ``1e-2 / batch_size``."""
    return JaxCategorical(
        model=C51.C51Q(n_actions=6, n_atoms=51), optimizer=optax.adam(2.5e-4, eps=1e-2 / batch_size),
        explorer=jexplorers.LinearDecayEpsilonGreedy(1.0, 0.01, decay, 6), gamma=0.99, phi=C51.phi)


def _frames(seed, n=3):
    return np.random.RandomState(seed).randint(0, 256, (n, 84, 84, 4)).astype(np.uint8)


def _model(kind):
    """(JAX model, port model)."""
    if kind == "c51":
        return C51.C51Q(n_actions=6, n_atoms=51), atari_c51.C51Q(6)
    return ALE.build_model(6, _args(kind)), atari_dqn_ale.build_model(kind)


# ---------------------------------------------------------------- forwards
@pytest.mark.parametrize("kind", ["nips", "dueling", "c51", "nature"])
def test_forward_matches_the_examples_flax_network(kind):
    jmodel, model = _model(kind)
    frames = _frames(1).astype(np.float32) / 255.0
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(frames))
    convert.load_flax_params(model, np_tree(params))
    want = jmodel.apply(params, jnp.asarray(frames))
    got = model(torch.from_numpy(frames))
    q, jq = got.q_values.detach().numpy(), np.asarray(want.q_values)
    # Relative to the largest Q-value; C51's are sums of probabilities times
    # atoms of up to 10 that cancel, held relative to the support's scale.
    scale = 10.0 if kind == "c51" else np.abs(jq).max()
    np.testing.assert_allclose(q, jq, rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_array_equal(got.greedy_actions().numpy(), np.asarray(want.greedy_actions()))
    if kind == "c51":
        np.testing.assert_allclose(got.q_dist.detach().numpy(), np.asarray(want.q_dist), rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(got.z_values.numpy(), np.asarray(want.z_values))  # C8: to the bit
    names = model.flax_names()
    torso = {"nips": "SmallAtariCNN_0", "dueling": "LargeAtariCNN_0", "c51": "LargeAtariCNN_0",
             "nature": "LargeAtariCNN_0"}[kind]
    assert names["torso.dense"] == f"{torso}/Dense_0"
    if kind == "nips":
        assert isinstance(model.torso, SmallAtariCNN) and names["head"] == "Dense_0"
    if kind == "dueling":
        assert isinstance(model, DuelingDQN) and (names["advantage"], names["value"]) == ("Dense_0", "Dense_1")


# ----------------------------------------------------------------- updates
def _cores(kind):
    """(JAX core, port core, the batch's obs dtype)."""
    if kind == "c51":
        return jax_c51_core(), atari_c51.make_c51_core(final_exploration_frames=DECAY), np.uint8
    arch, double = {"nips": ("nips", False), "dueling": ("dueling", False), "nips-double": ("nips", True)}[kind]
    jcore, _ = ALE.build_core_and_buffer(6, _args(arch, double))
    runner, _ = atari_dqn_ale.make_dqn_ale_runner(arch, double=double, device="cpu", num_envs=LANES,
                                                  capacity=CAPACITY, final_exploration_frames=DECAY)
    return jcore, runner.core, np.float32


def _batch(seed, obs_dtype, b=BATCH):
    rs = np.random.RandomState(seed)

    def obs():
        x = rs.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8)
        return x if obs_dtype == np.uint8 else x.astype(np.float32) * np.float32(1.0 / 255.0)  # the ring's gather

    return dict(obs=obs(), action=rs.randint(0, 6, b).astype(np.int32),
                reward=rs.choice([-1.0, 0.0, 1.0], b).astype(np.float32), next_obs=obs(),
                discount=np.full(b, 0.99, np.float32), is_terminal=np.arange(b) % 4 == 1,
                weight=np.ones(b, np.float32), indices=np.arange(b, dtype=np.int32))


@pytest.mark.parametrize("kind", ["nips", "dueling", "c51", "nips-double"])
def test_core_updates_match_the_example_from_converted_weights(kind):
    jcore, tcore, obs_dtype = _cores(kind)
    obs0 = jnp.zeros((1, 84, 84, 4), jnp.uint8)
    js = jcore.init(jax.random.PRNGKey(0), obs0)
    js = js.replace(target_params=jcore.init(jax.random.PRNGKey(1), obs0).params)
    ts = convert.dqn_state_from_flax(tcore, np_tree(js.params), np_tree(js.target_params), np_tree(js.opt_state),
                                     device="cpu")
    update = jax.jit(jcore.update)
    for i in range(3):
        b = _batch(10 + i, obs_dtype)
        ts, taux = tcore.update(ts, TransitionBatch(**{k: torch.from_numpy(v) for k, v in b.items()}))
        js, jaux = update(js, jax.random.PRNGKey(4), JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}))
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(taux["errors"].numpy(), np.asarray(jaux["errors"]), rtol=1e-5, atol=1e-6)
        atol = 1e-6 if i == 0 else 3e-6
        for name, want in convert.torch_arrays(ts.model, np_tree(js.params)).items():
            got = dict(ts.model.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"{kind} update {i + 1} {name}")
    assert ts.n_updates == int(js.n_updates) == 3 and ts.opt_state.count == 3
    assert type(tcore) is {"c51": CategoricalDQNCore, "nips-double": DoubleDQNCore}.get(kind, DQNCore)


# ------------------------------------------------------------ the runners
class AtariTapeEnv(VectorJaxEnv):
    """``VectorJaxEnv`` over AtariSim whose resets are the port's next
    logged draws, ``[seed, u]`` per lane, by value."""

    def __init__(self, env, num_envs, tape):
        super().__init__(env, num_envs)
        self.tape = tape

    def _reset_keys(self):
        seed, u = self.tape.take("randint", "uniform")
        return jnp.stack([jnp.asarray(seed, jnp.float32), jnp.asarray(u)], axis=1)

    def reset(self, rng):
        return super().reset(self._reset_keys())

    def step(self, rng, states, actions):
        reset = self._reset_keys()
        return super().step(jnp.concatenate([jnp.zeros_like(reset), reset]), states, actions)


RUNS = ["nature", "nips", "dueling", "nature-prioritized", "c51"]
SMALL = dict(num_envs=LANES, capacity=CAPACITY, replay_start_size=START, target_update_interval=SYNC_EVERY,
             minibatch_size=BATCH, final_exploration_frames=DECAY)


def _setup_run(kind):
    """(port runner, JAX core, JAX buffer)."""
    if kind == "c51":
        runner, _ = atari_c51.make_c51_atarisim_runner(device="cpu", **SMALL)
        buffer = jreplay.ReplayBuffer(CAPACITY, gamma=0.99, num_lanes=LANES, store_next_obs=False)
        return runner, jax_c51_core(BATCH), buffer
    arch, prioritized = kind.split("-")[0], kind.endswith("prioritized")
    runner, _ = atari_dqn_ale.make_dqn_ale_runner(arch, prioritized=prioritized, steps=400, device="cpu", **SMALL)
    jcore, buffer = ALE.build_core_and_buffer(6, _args(arch, prioritized=prioritized))
    return runner, jcore, buffer


def _run_jax(jcore, buffer, jtrain, tape):
    config = JaxConfig(num_envs=LANES, replay_start_size=START, update_interval=4,
                       target_update_interval=SYNC_EVERY, minibatch_size=BATCH)
    jitted = jax.jit(jcore.update)  # draws nothing: jitted inside the eager runner

    def update(state, rng, batch):
        with jax.disable_jit(False):
            return jitted(state, rng, batch)

    jcore.update = update
    jenv = jenvs.AtariSim(n_actions=6)
    jrunner = JaxRunner(jenv, jcore, buffer, config)
    jrunner.env = AtariTapeEnv(jenv, LANES, tape)
    env_states, obs = jrunner.env.reset(None)
    example = JaxTransition(obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()), next_obs=obs[0],
                            terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict())
    state = JaxRunnerState(
        env_states=env_states, obs=obs, train_state=jtrain, replay_state=buffer.init(example),
        rng=jnp.zeros((2,), jnp.uint32), t=jnp.int32(0), episode_return=jnp.zeros(LANES),
        recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0),
    )
    with jax.disable_jit():
        return jrunner.run_chunk(state, STEPS)


@pytest.fixture(scope="module", params=RUNS)
def run(request):
    kind = request.param
    runner, jcore, buffer = _setup_run(kind)
    obs0 = jnp.zeros((1, 84, 84, 4), jnp.uint8)
    jtrain = jcore.init(jax.random.PRNGKey(1), obs0)
    jtrain = jtrain.replace(target_params=jcore.init(jax.random.PRNGKey(2), obs0).params)
    tape = Tape(0)
    state = runner.init(0, draws=tape)
    state.train_state = convert.dqn_state_from_flax(runner.core, np_tree(jtrain.params), np_tree(jtrain.target_params),
                                                    np_tree(jtrain.opt_state), device="cpu")
    prefix_sample.launches = 0
    state, metrics = runner.run_chunk(state, STEPS)
    kinds = [k for k, _ in tape.log]
    with pytest.MonkeyPatch.context() as mp:
        install_tape(mp, tape)
        jstate, jmetrics = _run_jax(jcore, buffer, jtrain, tape)
    assert not tape.log  # every draw the port made was replayed
    return dict(kind=kind, runner=runner, state=state, metrics=metrics, kinds=kinds, jstate=jstate,
                jmetrics=jmetrics)


def test_recipe_matches_the_jax_runner(run):
    kind, runner, state, metrics = run["kind"], run["runner"], run["state"], run["metrics"]
    jstate, jmetrics = run["jstate"], run["jmetrics"]
    cfg = runner.config
    update_steps = sum(1 for k in range(1, STEPS + 1) if k * LANES >= START)
    assert state.t == int(jstate.t) == STEPS * LANES
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates) == update_steps * cfg.updates_per_step == 5
    prioritized = kind.endswith("prioritized")
    count = run["kinds"].count
    assert count("randint") == 1 + 2 * STEPS  # the resets' seeds and the explorer's random actions
    assert count("randint_below") == (0 if prioritized else update_steps)
    assert count("uniform") == 1 + 2 * STEPS + (ts.n_updates if prioritized else 0)

    ring, jring = state.replay_state, jstate.replay_state
    if prioritized:
        ring, jring = ring.base, jring.base
    assert int(ring.cursor) == int(jring.cursor) == STEPS * LANES > CAPACITY
    storage = ring.storage
    for name in ("obs", "action", "reward", "terminated", "done"):
        want = np.asarray(getattr(jring.storage, name))
        np.testing.assert_array_equal(storage[name].numpy().reshape(want.shape), want, err_msg=name)
    assert storage["obs"].dtype == torch.uint8

    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]), rtol=2e-5, atol=1e-7)
    np.testing.assert_array_equal(metrics["done_count"].numpy(), np.asarray(jmetrics["done_count"]))
    assert (metrics["loss"][START // LANES - 1:] > 0).all()
    for module, tree in ((ts.model, jts.params), (ts.target_model, jts.target_params)):
        for name, want in convert.torch_arrays(module, np_tree(tree)).items():
            got = dict(module.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=f"{kind} {name}")
    # The sync at 24 copied the online net of then; the updates went on.
    target = dict(ts.target_model.named_parameters())
    assert any(not torch.equal(p, target[n]) for n, p in ts.model.named_parameters())
    if prioritized:
        tr, jr = state.replay_state, jstate.replay_state
        np.testing.assert_allclose(tr.tree.numpy(), np.asarray(jr.tree), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(tr.min_tree.numpy(), np.asarray(jr.min_tree), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(float(tr.beta), float(jr.beta), rtol=1e-6)
        # On the CPU the prefix sample takes its plain version: no launch.
        assert prefix_sample.launches == 0


def test_recipes_hold_the_examples_settings():
    for arch in atari_dqn_ale.ARCHS:
        for prioritized in (False, True):
            runner, loop = atari_dqn_ale.make_dqn_ale_runner(arch, prioritized=prioritized, device="cpu",
                                                             capacity=4_096)
            cfg, core, buf = runner.config, runner.core, runner.buffer
            assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
                    cfg.minibatch_size) == (64, 50_000, 4, 10_000, 32)
            assert type(core) is DQNCore and core.batch_accumulator == "mean" and core.gamma == 0.99
            assert isinstance(core.optimizer, Adam) and (core.optimizer.learning_rate, core.optimizer.eps) == (
                2.5e-4, 1.5e-4)
            explorer = core.explorer
            assert isinstance(explorer, LinearDecayEpsilonGreedy)
            assert (explorer.start_epsilon, explorer.end_epsilon, explorer.decay_steps) == (1.0, 0.01, 10**6)
            assert (buf.num_steps, buf.num_lanes, buf.store_next_obs) == (1, 64, False)
            assert buf.fused_dequant_scale == 1.0 / 255.0
            if prioritized:
                assert isinstance(buf, PrioritizedReplayBuffer)
                assert (buf.alpha, buf.beta0, buf.beta_add) == (0.6, 0.4, (1.0 - 0.4) / (5e7 / 4))
            else:
                assert isinstance(buf, ReplayBuffer)
            model = core.model
            assert isinstance(model, {"nature": NatureQ, "nips": NatureQ, "dueling": DuelingDQN}[arch])
            assert (loop.env.num_envs, loop.max_steps) == (5, 500)
    runner, _ = atari_dqn_ale.make_dqn_ale_runner(double=True, num_step_return=3, device="cpu", capacity=4_096)
    assert type(runner.core) is DoubleDQNCore and runner.buffer.num_steps == 3
    runner, loop = atari_c51.make_c51_atarisim_runner(device="cpu", capacity=4_096)
    cfg, core, buf = runner.config, runner.core, runner.buffer
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
            cfg.minibatch_size) == (64, 50_000, 4, 10_000, 32)
    assert type(core) is CategoricalDQNCore and core.batch_accumulator == "mean"
    assert (core.optimizer.learning_rate, core.optimizer.eps) == (2.5e-4, 1e-2 / 32)
    assert isinstance(buf, ReplayBuffer) and buf.fused_dequant_scale is None and not buf.store_next_obs
    assert core.phi is atari_c51.phi and core.explorer.end_epsilon == 0.01
    assert core.model.head.out_features == 6 * 51 and (loop.env.num_envs, loop.max_steps) == (5, 500)
    with pytest.raises(ValueError):
        atari_dqn_ale.build_model("large")
