"""Five examples the port now runs at their own settings, against the
examples' own JAX code (loaded from ``examples/``):

- ``atari/reproduction/iqn/train_iqn.py --sim`` (``experiments/atari_iqn.py``):
  the script's ``main`` up to its evaluator (its ``OffPolicyRunner`` and
  ``JaxEvalLoop`` replaced by ones that keep their arguments) gives the
  core, ring, cadence and evaluation the recipe must equal; the
  ``ImplicitQuantileQFunction(psi=LargeAtariCNN())`` forward from the same
  converted weights and taus at the full widths; and 8 scan steps of the
  recipe at the full widths (Nature CNN, N = N' = 64, K = 32, batch 32)
  over 4 lanes and a 24-slot ring that wraps, against the JAX package's
  ``OffPolicyRunner.run_chunk`` with the script's core under
  ``jax.disable_jit`` on the port's draws (``install_tape``: each act's K
  taus, the explorer's draws, the resets, each scan step's ids, each
  update's N and N' taus): replay start 16, one update per scan step, a
  target sync at 24, five updates.
- ``mujoco/reproduction/ppo/train_ppo.py --jax-env pendulum``
  (``experiments/ppo_pendulum.py``, ``make_ppo_pendulum_device_runner``):
  ``run_device``'s core, lanes, rollout and evaluation; 3 iterations at 4
  lanes x 16 steps (one batch-64 minibatch, 10 epochs) against the JAX
  ``OnPolicyRunner`` jitted with a ``ScriptedKey`` (``test_torch_onpolicy_slice.py``).
  ``onpolicy.make_ppo_pendulum_runner`` is not this recipe: it has no
  entropy bonus, and the script keeps the JAX core's 0.01.
- ``quickstart/quickstart.py`` (``experiments/quickstart.py``): the device
  runner's settings from ``run_device``, and 11 scan steps at 4 lanes
  against the JAX runner under ``jax.disable_jit`` on the port's draws, as
  ``test_torch_cartpole_value_slice.py`` holds the CartPole recipes (18
  updates, a sync at 24); the host loop's agent from ``run_hostloop``.
- ``gym/train_ppo_pendulum.py`` (``ppo_pendulum.run``) and
  ``atlas/train_soft_actor_critic_atlas.py --jax-env``
  (``experiments/sac_atlas.py``, ``--torch-env``): each ``main`` with its
  driver replaced: the shells' settings and the drivers' arguments equal,
  the JAX shell's initial state converts into the port's, and the greedy
  actions of both agree on 64 observations within 1e-5. The atlas script's
  Roboschool backend raises by name.

Tolerances: counters, flags, ids and actions exact; the IQN forward's
quantiles within 2e-5 of their scale (the Nature CNN's reductions and
XLA's ``cos`` at arguments up to 64 pi round apart, C28, C36); the IQN
run's frames, actions and counters exact, losses 1e-4 relative, weights
2e-6 (Adam at 5e-5 over five updates: C22); PPO's obs, returns and
metrics 1e-4 relative (the Pendulum's ``sin``/``cos`` an ulp apart, C60),
weights 2e-5; the quickstart run as the CartPole recipes: ring
observations 1e-5, weights 2e-5.
"""

import importlib
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict
from test_torch_atari_examples import AtariTapeEnv
from test_torch_cartpole_value_slice import TapeEnv
from test_torch_onpolicy_slice import ITERATIONS, PermutingDraws
from test_torch_onpolicy_slice import _run_jax as run_jax_onpolicy
from test_torch_rainbow_modules import np_tree
from test_torch_sac import assert_network
from test_torch_value_modules import Tape, install_tape

import pfrl_tpu.experiments as jexperiments
from pfrl_tpu import envs as jenvs
from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
from pfrl_tpu.experiments.runner import RunnerState as JaxRunnerState
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import DQN, PPO, IQNCore, PPOCore, SoftActorCritic
from pfrl_tpu_torch.envs import SerialVectorEnv
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments import atari_iqn, onpolicy, ppo_pendulum, profile_host, profile_slice, quickstart
from pfrl_tpu_torch.experiments import sac_atlas
from pfrl_tpu_torch.explorers import ConstantEpsilonGreedy, LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.replay import ReplayBuffer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {
    "iqn": "examples/atari/reproduction/iqn/train_iqn.py",
    "ppo": "examples/mujoco/reproduction/ppo/train_ppo.py",
    "quickstart": "examples/quickstart/quickstart.py",
    "ppo-gym": "examples/gym/train_ppo_pendulum.py",
    "sac-atlas": "examples/atlas/train_soft_actor_critic_atlas.py",
}


def load_example(kind):
    spec = importlib.util.spec_from_file_location(f"example_more_{kind.replace('-', '_')}",
                                                  os.path.join(REPO, SCRIPTS[kind]))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Kept(Exception):
    """Raised by a replaced evaluator or driver, after keeping its arguments."""


def keeping_runner(store):
    class Runner:
        def __init__(self, *args, **kwargs):
            store["runner"] = (args, kwargs)

        def init(self, rng):
            return types.SimpleNamespace(t=10**12, train_state=None)

    return Runner


def keeping_eval(store):
    def eval_loop(*args, **kwargs):
        store["eval"] = (args, kwargs)
        raise Kept

    return eval_loop


def script_runner(kind, monkeypatch, argv=(), call=None):
    """The example's runner and evaluator arguments: ``{"runner": (args,
    kwargs), "eval": (args, kwargs)}``."""
    module = load_example(kind)
    store = {}
    for target in (module, jexperiments):
        monkeypatch.setattr(target, "OffPolicyRunner", keeping_runner(store), raising=False)
        monkeypatch.setattr(target, "OnPolicyRunner", keeping_runner(store), raising=False)
        monkeypatch.setattr(target, "JaxEvalLoop", keeping_eval(store), raising=False)
    monkeypatch.setattr(sys, "argv", [SCRIPTS[kind], *argv])
    with pytest.raises(Kept):
        (call or module.main)(module)
    return store


def _runner_args(store):
    (env, core, *rest), kwargs = store["runner"]
    return env, core, rest, kwargs


# ------------------------------------------------------------------- IQN
def iqn_script(monkeypatch):
    """(JAX core, JAX buffer, JAX config, evaluator arguments) of ``main --sim``."""
    store = script_runner("iqn", monkeypatch, ["--sim"], call=lambda m: m.main())
    _, core, (buffer, cfg), _ = _runner_args(store)
    return core, buffer, cfg, store["eval"]


def test_iqn_recipe_holds_the_scripts_settings(monkeypatch):
    jcore, jbuffer, jcfg, (eval_args, eval_kwargs) = iqn_script(monkeypatch)
    runner, loop = atari_iqn.make_iqn_atarisim_runner(device="cpu", capacity=4_096)
    cfg, core, buf = runner.config, runner.core, runner.buffer
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
            cfg.minibatch_size, cfg.n_times_update) == (jcfg.num_envs, jcfg.replay_start_size, jcfg.update_interval,
                                                        jcfg.target_update_interval, jcfg.minibatch_size,
                                                        jcfg.n_times_update) == (64, 50_000, 4, 10_000, 32, 1)
    assert type(core) is IQNCore and (core.N, core.N_prime, core.K) == (
        jcore.N, jcore.N_prime, jcore.K) == (64, 64, 32)
    assert core.gamma == jcore.gamma == 0.99 and core.batch_accumulator == jcore.batch_accumulator == "mean"
    assert isinstance(core.optimizer, Adam) and (core.optimizer.learning_rate, core.optimizer.eps) == (5e-5, 1e-2 / 32)
    ex, jex = core.explorer, jcore.explorer
    assert isinstance(ex, LinearDecayEpsilonGreedy)
    assert (ex.start_epsilon, ex.end_epsilon, ex.decay_steps, ex.n_actions) == (
        jex.start_epsilon, jex.end_epsilon, jex.decay_steps, jex.n_actions) == (1.0, 0.01, 10**6, 6)
    assert core.phi is atari_iqn.phi and core.compute_dtype is None and jcore.compute_dtype is None
    assert type(buf) is ReplayBuffer and not buf.store_next_obs and buf.fused_dequant_scale is None
    assert (buf.num_steps, buf.gamma, buf.num_lanes) == (jbuffer.num_steps, jbuffer.gamma, jbuffer.num_lanes) == (
        1, 0.99, 64)
    assert jbuffer.capacity == (10**5 // 64) * 64 and atari_iqn.make_iqn_atarisim_runner.__defaults__[3] == 10**5
    assert not jbuffer.store_next_obs
    assert (loop.env.num_envs, loop.max_steps) == (eval_kwargs["num_episodes"], eval_kwargs["max_steps"]) == (5, 500)
    model = core.model
    assert (model.phi.in_features, model.phi.out_features, model.head.out_features) == (64, 512, 6)
    assert model.flax_names()["phi"] == "Dense_0" and model.flax_names()["head"] == "Dense_1"
    runner, _ = atari_iqn.make_iqn_atarisim_runner(compute_dtype=torch.bfloat16, device="cpu", capacity=4_096)
    assert runner.core.compute_dtype == torch.bfloat16
    # Without --sim the command line runs AtariSim, as the example's main does.
    out = atari_iqn.run(["--num-envs", "4", "--replay-capacity", "4096", "--steps", "0"], device="cpu")
    assert isinstance(out["runner"].env.env, AtariSim) and out["state"].t == 0


def _frames(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n, 84, 84, 4)).astype(np.uint8)


def test_iqn_network_matches_the_scripts_at_full_width(monkeypatch):
    jcore, *_ = iqn_script(monkeypatch)
    frames = _frames(1, 3)
    taus = np.random.RandomState(2).uniform(size=(3, 64)).astype(np.float32)
    x = frames.astype(np.float32) / 255.0
    params = jcore.model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(taus))
    model = atari_iqn.make_iqn_model()
    convert.load_flax_params(model, np_tree(params))
    want = np.asarray(jcore.model.apply(params, jnp.asarray(x), jnp.asarray(taus)).quantiles)
    got = model(torch.from_numpy(x), torch.from_numpy(taus)).quantiles.detach().numpy()
    assert got.shape == want.shape == (3, 64, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


IQN_SMALL = dict(num_envs=4, capacity=24, replay_start_size=16, target_update_interval=24)
IQN_STEPS = 8


def _run_jax_iqn(jcore, jtrain, tape):
    from pfrl_tpu.experiments import RunnerConfig as JaxConfig
    from pfrl_tpu.replay import ReplayBuffer as JaxReplay

    buffer = JaxReplay(24, gamma=0.99, num_lanes=4, store_next_obs=False)
    config = JaxConfig(num_envs=4, replay_start_size=16, update_interval=4, target_update_interval=24, minibatch_size=32)
    jenv = jenvs.AtariSim(n_actions=6)
    jrunner = JaxRunner(jenv, jcore, buffer, config)
    jrunner.env = AtariTapeEnv(jenv, 4, tape)
    env_states, obs = jrunner.env.reset(None)
    example = JaxTransition(obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()), next_obs=obs[0],
                            terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict())
    state = JaxRunnerState(
        env_states=env_states, obs=obs, train_state=jtrain, replay_state=buffer.init(example),
        rng=jnp.zeros((2,), jnp.uint32), t=jnp.int32(0), episode_return=jnp.zeros(4),
        recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0),
    )
    with jax.disable_jit():
        state, metrics = jrunner.run_chunk(state, IQN_STEPS)
    assert not tape.log
    return state, metrics


def test_iqn_recipe_matches_the_jax_runner_at_full_width(monkeypatch):
    with pytest.MonkeyPatch.context() as mp:
        jcore, *_ = iqn_script(mp)
    runner, _ = atari_iqn.make_iqn_atarisim_runner(device="cpu", **IQN_SMALL)
    obs0 = jnp.zeros((1, 84, 84, 4), jnp.uint8)
    jtrain = jcore.init(jax.random.PRNGKey(1), obs0)
    jtrain = jtrain.replace(target_params=jcore.init(jax.random.PRNGKey(2), obs0).params)
    tape = Tape(0)
    state = runner.init(0, draws=tape)
    state.train_state = convert.dqn_state_from_flax(runner.core, np_tree(jtrain.params), np_tree(jtrain.target_params),
                                                    np_tree(jtrain.opt_state), device="cpu")
    state, metrics = runner.run_chunk(state, IQN_STEPS)
    count = [k for k, _ in tape.log].count
    with pytest.MonkeyPatch.context() as mp:
        install_tape(mp, tape)
        jstate, jmetrics = _run_jax_iqn(jcore, jtrain, tape)
    ts, jts = state.train_state, jstate.train_state
    assert state.t == int(jstate.t) == 32 and ts.n_updates == int(jts.n_updates) == 5
    # Per act step the K taus and the explorer's two draws, and the resets'
    # two; per update one id draw and the N and N' taus.
    assert count("randint") == 1 + 2 * IQN_STEPS and count("randint_below") == 5
    assert count("uniform") == 1 + 3 * IQN_STEPS + 2 * 5
    ring, jring = state.replay_state, jstate.replay_state
    for name in ("obs", "action", "reward", "terminated", "done"):
        want = np.asarray(getattr(jring.storage, name))
        np.testing.assert_array_equal(ring.storage[name].numpy().reshape(want.shape), want, err_msg=name)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]), rtol=1e-4, atol=1e-7)
    assert (metrics["loss"][3:] > 0).all()
    for module, tree in ((ts.model, jts.params), (ts.target_model, jts.target_params)):
        for name, want in convert.torch_arrays(module, np_tree(tree)).items():
            got = dict(module.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, err_msg=f"iqn {name}")


# -------------------------------------------------------- PPO on device
def ppo_script(monkeypatch, argv=("--jax-env", "pendulum")):
    store = script_runner("ppo", monkeypatch, argv, call=lambda m: m.main())
    env, core, rest, kwargs = _runner_args(store)
    return env, core, kwargs, store["eval"]


def test_ppo_pendulum_device_recipe_holds_the_scripts_settings(monkeypatch):
    jenv, jcore, jkw, (eval_args, eval_kwargs) = ppo_script(monkeypatch)
    runner, loop = ppo_pendulum.make_ppo_pendulum_device_runner(device="cpu")
    core = runner.core
    assert (runner.num_envs, runner.rollout_len) == (jkw["num_envs"], jkw["rollout_len"]) == (64, 128)
    assert type(core) is PPOCore
    for attr in ("gamma", "lambd", "clip_eps", "clip_eps_vf", "entropy_coef", "value_func_coef", "epochs",
                 "minibatch_size", "standardize_advantages"):
        assert getattr(core, attr) == getattr(jcore, attr), attr
    assert (core.entropy_coef, core.epochs, core.minibatch_size) == (0.01, 10, 64)
    assert isinstance(core.optimizer, Adam) and core.optimizer.learning_rate == 3e-4
    assert isinstance(jenv, jenvs.TimeLimit) and runner.env.env.max_steps == jenv.max_steps == 200
    assert (loop.env.num_envs, loop.max_steps) == (eval_kwargs["num_episodes"], eval_kwargs["max_steps"]) == (10, 200)
    model = core.model
    assert model.pi[2].scale == 1e-4 and model.pi[2].out_features == 1 and model.v[2].out_features == 1
    # record_curves.py's PPO-Pendulum recipe has no entropy bonus: another recipe.
    assert onpolicy.make_ppo_pendulum_runner(device="cpu").core.entropy_coef == 0.0


def test_ppo_pendulum_device_recipe_matches_the_jax_runner(monkeypatch):
    with pytest.MonkeyPatch.context() as mp:
        jenv, jcore, _, _ = ppo_script(mp)
    runner, _ = ppo_pendulum.make_ppo_pendulum_device_runner(4, 16, device="cpu")
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((4, 3)))
    draws = PermutingDraws(0)
    state = runner.init(0, draws=draws)
    state.train_state = convert.ppo_state_from_flax(runner.core, np_tree(jtrain), device="cpu")
    state, aux = runner.run_iterations(state, ITERATIONS)
    resets, act = [("uniform", 1), ("uniform", 1)], ("normal", 1)
    jrunner, jstate, jaux = run_jax_onpolicy(monkeypatch, jenv, jcore, jtrain, draws, resets, act, 10, 16)
    assert state.t == int(jstate.t) == ITERATIONS * 64
    assert state.train_state.n_updates == int(jstate.train_state.n_updates) == ITERATIONS * 10
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.episode_return.numpy(), np.asarray(jstate.episode_return), rtol=1e-4, atol=1e-4)
    for name, got in aux.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(jaux[name]), rtol=1e-4, atol=1e-6, err_msg=name)
    assert_network(state.train_state.model, jstate.train_state.params, 2e-5, "ppo-pendulum-device")


# ------------------------------------------------------------ quickstart
QS_SMALL = dict(num_envs=4, capacity=40, replay_start_size=12, update_interval=2, target_update_interval=24,
                minibatch_size=8)


def test_quickstart_device_recipe_is_the_scripts_and_matches_its_runner(monkeypatch):
    with pytest.MonkeyPatch.context() as mp:
        store = script_runner("quickstart", mp, call=lambda m: m.run_device(80, 0))
    jenv, jcore, (jbuffer, jcfg), _ = _runner_args(store)
    runner, loop = quickstart.make_device_runner(100_000, device="cpu")
    cfg, core = runner.config, runner.core
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
            cfg.minibatch_size) == (jcfg.num_envs, jcfg.replay_start_size, jcfg.update_interval,
                                    jcfg.target_update_interval, jcfg.minibatch_size) == (32, 1024, 32, 2048, 64)
    assert runner.buffer.capacity == jbuffer.capacity == 10**5 and runner.buffer.store_next_obs
    assert (core.explorer.end_epsilon, core.explorer.decay_steps) == (0.05, 50_000)
    assert jcore.explorer.decay_steps == 40 and core.optimizer.learning_rate == 1e-3
    assert (loop.env.num_envs, loop.max_steps) == (store["eval"][1]["num_episodes"], store["eval"][1]["max_steps"])
    assert runner.env.env.max_steps == jenv.max_steps == 500
    # 11 scan steps at 4 lanes against the JAX runner on the port's draws.
    from test_torch_cartpole_value_slice import STEPS, port_state

    runner, _ = quickstart.make_device_runner(80, device="cpu", **QS_SMALL)
    from pfrl_tpu.envs import CartPole as JaxCartPole
    from pfrl_tpu.envs import TimeLimit as JaxTimeLimit
    from pfrl_tpu.experiments import RunnerConfig as JaxConfig
    from pfrl_tpu.replay import ReplayBuffer as JaxReplay

    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((4, 4)))
    tape = Tape(0)
    state = runner.init(0, draws=tape)
    state.train_state = port_state(runner.core, jtrain)
    state, metrics = runner.run_chunk(state, STEPS)
    jbuffer = JaxReplay(40, gamma=0.99, num_lanes=4)
    jenv = JaxTimeLimit(JaxCartPole(), 500)
    jrunner = JaxRunner(jenv, jcore, jbuffer, JaxConfig(**{k: v for k, v in QS_SMALL.items() if k != "capacity"}))
    jrunner.env = TapeEnv(jenv, 4, tape)
    with pytest.MonkeyPatch.context() as mp:
        install_tape(mp, tape)
        env_states, obs = jrunner.env.reset(None)
        example = JaxTransition(obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()), next_obs=obs[0],
                                terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict())
        jstate = JaxRunnerState(
            env_states=env_states, obs=obs, train_state=jtrain, replay_state=jbuffer.init(example),
            rng=jnp.zeros((2,), jnp.uint32), t=jnp.int32(0), episode_return=jnp.zeros(4),
            recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0))
        with jax.disable_jit():
            jstate, jmetrics = jrunner.run_chunk(jstate, STEPS)
        assert not tape.log
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates) == 18
    np.testing.assert_array_equal(state.replay_state.storage["action"].numpy(),
                                  np.asarray(jstate.replay_state.storage.action))
    np.testing.assert_allclose(state.replay_state.storage["obs"].numpy(), np.asarray(jstate.replay_state.storage.obs),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]), rtol=2e-5, atol=1e-7)
    for module, tree in ((ts.model, jts.params), (ts.target_model, jts.target_params)):
        assert_network(module, tree, 2e-5, "quickstart")


# ---------------------------------------------------------- host recipes
def _keep_driver(store):
    def driver(agent, env, **kwargs):
        store.update(agent=agent, env=env, **kwargs)
        raise Kept

    return driver


def _host_pair(kind, monkeypatch, tmp_path):
    """(JAX agent, port agent, JAX driver kwargs, port driver kwargs)."""
    module = load_example(kind)
    jstore, tstore = {}, {}
    monkeypatch.setattr(module, "train_agent_batch_with_evaluation", _keep_driver(jstore), raising=False)
    monkeypatch.setattr(jexperiments, "train_agent_batch_with_evaluation", _keep_driver(jstore))
    monkeypatch.setattr(importlib.import_module("pfrl_tpu_torch.experiments.train_agent_batch"),
                        "train_agent_batch_with_evaluation", _keep_driver(tstore))
    argv = ["--jax-env", "--serial-envs"] if kind == "sac-atlas" else []
    monkeypatch.setattr(sys, "argv", [SCRIPTS[kind], *argv])
    with pytest.raises(Kept):
        module.main()
    with pytest.raises(Kept):
        if kind == "sac-atlas":
            sac_atlas.run(["--torch-env", "--serial-envs"], device="cpu")
        else:
            ppo_pendulum.run([], device="cpu")
    return jstore, tstore


SHELL = {
    "ppo-gym": ("update_interval", "core.gamma", "core.lambd", "core.clip_eps", "core.entropy_coef",
                "core.value_func_coef", "core.epochs", "core.minibatch_size", "core.standardize_advantages"),
    "sac-atlas": ("replay_start_size", "minibatch_size", "update_interval", "n_times_update", "core.gamma",
                  "core.soft_update_tau", "core.entropy_target", "core.initial_temperature", "core.burnin_steps"),
}


def _attr(obj, dotted):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("kind", ["ppo-gym", "sac-atlas"])
def test_host_recipe_is_the_script(kind, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    jstore, tstore = _host_pair(kind, monkeypatch, tmp_path)
    jagent, tagent = jstore.pop("agent"), tstore.pop("agent")
    jenv, tenv = jstore.pop("env"), tstore.pop("env")
    jeval, teval = jstore.pop("eval_env"), tstore.pop("eval_env")
    assert tstore == jstore  # steps, evaluation, outdir, log interval
    lanes = 4 if kind == "sac-atlas" else 8
    assert isinstance(tenv, SerialVectorEnv) and tenv.num_envs == jenv.num_envs == lanes == teval.num_envs
    for attr in SHELL[kind]:
        assert _attr(tagent, attr) == pytest.approx(_attr(jagent, attr)), attr
    assert type(tagent) is {"ppo-gym": PPO, "sac-atlas": SoftActorCritic}[kind]
    if kind == "sac-atlas":
        assert tagent.buffer.capacity == jagent.buffer.capacity == 10**6
        assert tagent.buffer.num_steps == jagent.buffer.num_steps == 3 and tagent.buffer.gamma == 0.98
        opts = (tagent.core.policy_optimizer, tagent.core.q_func1_optimizer, tagent.core.q_func2_optimizer)
        assert all((o.learning_rate, o.eps) == (3e-4, 0.1) for o in opts)
        assert tagent.core.temperature_optimizer.learning_rate == 3e-4
    else:
        assert tagent.core.optimizer.learning_rate == 3e-4
    obs = np.random.RandomState(0).normal(size=(64, 3)).astype(np.float32)
    with jagent.eval_mode():
        jagent.batch_act(obs[:1])
    state = np_tree(jagent.train_state)
    if kind == "sac-atlas":
        convert.actor_critic_shell_from_flax(tagent, state)
    else:
        convert.onpolicy_shell_from_flax(tagent, state)
    with jagent.eval_mode(), tagent.eval_mode():
        np.testing.assert_allclose(tagent.batch_act(obs), np.asarray(jagent.batch_act(obs)), rtol=0, atol=1e-5)
    for env in (tenv, teval, jenv, jeval):
        env.close()


def test_quickstart_hostloop_agent_is_the_scripts(monkeypatch):
    module = load_example("quickstart")
    store, jax_dqn = {}, module.DQN

    class KeptDQN(jax_dqn):
        def __init__(self, **kwargs):
            store.update(kwargs)
            super().__init__(**kwargs)
            raise Kept

    monkeypatch.setattr(module, "DQN", KeptDQN)
    with pytest.raises(Kept):
        module.run_hostloop(100, 0)
    tagent = quickstart.make_hostloop_agent(device="cpu")
    assert type(tagent) is DQN and tagent.buffer.capacity == store["replay_buffer"].capacity == 10**4
    for attr in ("replay_start_size", "update_interval", "target_update_interval", "minibatch_size"):
        assert getattr(tagent, attr) == store.get(attr, getattr(tagent, attr)), attr
    assert (tagent.replay_start_size, tagent.update_interval, tagent.target_update_interval) == (500, 1, 100)
    assert isinstance(tagent.core.explorer, ConstantEpsilonGreedy) and tagent.core.explorer.epsilon == 0.1
    assert store["explorer"].epsilon == 0.1 and store["gamma"] == tagent.core.gamma == 0.99
    obs = np.random.RandomState(0).normal(size=(64, 4)).astype(np.float32)
    jagent = jax_dqn(**store)  # the script's agent, with the arguments it was given
    with jagent.eval_mode():
        jagent.batch_act(obs[:1])
    convert.dqn_shell_from_flax(tagent, np_tree(jagent.train_state))
    with jagent.eval_mode(), tagent.eval_mode():
        np.testing.assert_array_equal(tagent.batch_act(obs), np.asarray(jagent.batch_act(obs)))


def test_sac_atlas_refuses_the_roboschool_backend_by_name():
    args = sac_atlas.parser().parse_args([])
    with pytest.raises(RuntimeError, match="RoboschoolAtlasForwardWalk-v1.*--torch-env"):
        sac_atlas.make_env(args, 0, False)
    args = sac_atlas.parser().parse_args(["--torch-env"])
    env = sac_atlas.make_env(args, 3, False)
    assert env.observation_space.shape == (3,) and env.action_space.shape == (1,)


def test_profile_tools_hold_the_new_configs():
    for name in ("iqn-atarisim-64", "ppo-pendulum-device-64", "quickstart-dqn-cartpole-32"):
        assert name in profile_slice.CONFIGS
    runner = profile_slice.CONFIGS["iqn-atarisim-64"](device="cpu", capacity=4_096)
    assert runner.config.num_envs == 64 and runner.config.replay_start_size == 2_048
    for name, lanes in (("ppo-pendulum-host-8", 8), ("sac-atlas-pendulum-host-4", 4),
                        ("quickstart-dqn-cartpole-host-1", 1)):
        agent, env, eval_env = profile_host.make_host_path(name, device="cpu")
        assert profile_host.HOST_PATHS[name].lanes == lanes
        assert getattr(env, "num_envs", 1) == lanes


def test_vector_envs_built_together_close_the_built_one_on_a_failure():
    """``make_together`` (the atlas, grasping and batch-ALE recipes start
    their training and evaluation workers at once): the envs in order, and
    on a failure the ones built are closed and the error raised."""
    from pfrl_tpu_torch.envs.multiprocess_vector_env import make_together

    built = []

    def make(n):
        env = SerialVectorEnv([ppo_pendulum.pendulum_env(i) for i in range(n)])
        built.append(env)
        return env

    env, eval_env = make_together(lambda: make(2), lambda: make(3))
    assert (env.num_envs, eval_env.num_envs) == (2, 3)

    def fail():
        raise ValueError("no env")

    built.clear()
    closed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SerialVectorEnv, "close", lambda self: closed.append(self))
        with pytest.raises(ValueError, match="no env"):
            make_together(lambda: make(2), fail)
    assert closed == built and len(built) == 1
