"""The other five real-ALE entry points, each against its example's own
``main`` over the ALE stand-in (``torch_ale_standin.py``), both with their
drivers replaced by ones that keep their arguments (the pattern of
``test_torch_examples_more.py``):

- ``train_dqn_batch_ale.py`` (``atari_dqn_batch.run_batch`` and the
  actor-learner mode's envs, ``run_actor_learner``);
- ``train_dqn_pipeline_ale.py`` without ``--sim`` (``atari_pipeline.run``:
  ``make_ale_plane_env``'s double ``MaxAndSkipEnv``, ROADMAP C86);
- ``train_a2c_ale.py`` and ``train_ppo_ale.py`` without ``--sim``
  (``atari_onpolicy_ale.run_a2c_ale``, ``run_ppo_ale``);
- ``reproduction/dqn/train_dqn.py`` without ``--sim``
  (``atari_dqn_reproduction.run_ale``).

Held: the shells' settings and the drivers' arguments equal; the envs'
first observations (or, for single envs and factories, rollouts with
resets) equal to the bit; the on-policy shells' greedy actions on 16
frames equal after the JAX shell's initial state is converted into the
port's. The port's vector envs are its spawned ``MultiprocessVectorEnv``;
the JAX examples' are replaced by ``SerialVectorEnv`` (their cloudpickled
factories need no worker to be held). Each entry point raises before any
worker spawns when there is no card and no ``device="cpu"``.
"""

import importlib
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rainbow_modules import np_tree
from torch_ale_standin import ENV_ID

import pfrl_tpu.envs as jenvs
import pfrl_tpu.experiments as jexperiments
import pfrl_tpu.parallel.atari_pipeline as jpipeline
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import A2C, DQN, PPO
from pfrl_tpu_torch.envs import MultiprocessVectorEnv
from pfrl_tpu_torch.experiments import atari_dqn_batch, atari_dqn_reproduction, atari_onpolicy_ale, atari_pipeline
from pfrl_tpu_torch.optimizers import Adam, ClipByGlobalNorm, RMSprop
from pfrl_tpu_torch.wrappers import RandomizeAction

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {
    "batch": "examples/atari/train_dqn_batch_ale.py",
    "pipeline": "examples/atari/train_dqn_pipeline_ale.py",
    "a2c": "examples/atari/train_a2c_ale.py",
    "ppo": "examples/atari/train_ppo_ale.py",
    "reproduction": "examples/atari/reproduction/dqn/train_dqn.py",
}


def load_example(kind):
    spec = importlib.util.spec_from_file_location(f"ale_example_{kind}", os.path.join(REPO, SCRIPTS[kind]))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Kept(Exception):
    """Raised by a replaced driver, after keeping its arguments."""


def keeping(store):
    """A driver that keeps its arguments and each env's first observations
    (the port's envs are closed once the entry point returns)."""
    def driver(agent=None, env=None, *args, **kwargs):
        store.update(agent=agent, env=env, args=args, **kwargs)
        store["obs"] = [np.asarray(o) for o in env.reset()] if hasattr(env, "num_envs") else np.asarray(env.reset())
        eval_env = kwargs.get("eval_env")
        if eval_env is not None and hasattr(eval_env, "num_envs"):
            store["eval_obs"] = [np.asarray(o) for o in eval_env.reset()]
        raise Kept

    return driver


def run_example(kind, monkeypatch, argv):
    """The example's ``main`` with ``argv``; its vector envs serial."""
    module = load_example(kind)
    monkeypatch.setattr(jenvs, "MultiprocessVectorEnv", lambda fns: jenvs.SerialVectorEnv([f() for f in fns]))
    monkeypatch.setattr(sys, "argv", [SCRIPTS[kind], *argv])
    with pytest.raises(Kept):
        module.main()
    return module


def _attr(obj, dotted):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _same_obs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _rollout(env, steps, seed):
    rs = np.random.RandomState(seed)
    out = [np.asarray(env.reset())]
    for _ in range(steps):
        obs, reward, done, info = env.step(int(rs.randint(0, 4)))
        out.append((np.asarray(obs), reward, done, info.get("needs_reset", False)))
        if done or info.get("needs_reset", False):
            out.append(np.asarray(env.reset()))
    return out


def _same_rollouts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]
        else:
            np.testing.assert_array_equal(g, w)


def test_batch_run_is_the_examples(monkeypatch, tmp_path):
    jstore, tstore = {}, {}
    monkeypatch.setattr(jexperiments, "train_agent_batch_with_evaluation", keeping(jstore))
    monkeypatch.setattr(atari_dqn_batch, "train_agent_batch_with_evaluation", keeping(tstore))
    run_example("batch", monkeypatch, ["--env", ENV_ID, "--num-envs", "2", "--replay-capacity", "1024",
                                       "--outdir", str(tmp_path / "jax")])
    with pytest.raises(Kept):
        atari_dqn_batch.run_batch(str(tmp_path / "jax"), num_envs=2, env_id=ENV_ID, capacity=1024, device="cpu")
    tagent, jagent = tstore.pop("agent"), jstore.pop("agent")
    tenv, jenv = tstore.pop("env"), jstore.pop("env")
    assert isinstance(tenv, MultiprocessVectorEnv) and tenv.closed and tenv.num_envs == jenv.num_envs == 2
    for key in ("obs", "eval_obs"):
        _same_obs(tstore.pop(key), jstore.pop(key))
    tstore.pop("eval_env"), jstore.pop("eval_env")
    assert tstore == jstore  # steps, evaluation, outdir
    assert type(tagent) is DQN and tagent.buffer.capacity == jagent.buffer.capacity == 1024
    for attr in ("replay_start_size", "minibatch_size", "update_interval", "target_update_interval",
                 "buffer.num_lanes", "core.explorer.n_actions"):
        assert _attr(tagent, attr) == _attr(jagent, attr), attr
    assert tagent.core.explorer.n_actions == 4


def test_actor_learner_envs_are_the_examples(monkeypatch, tmp_path):
    kept = {}

    def train_agent_async(**kwargs):
        kept.update(kwargs)
        raise Kept

    monkeypatch.setattr(atari_dqn_batch, "train_agent_async", train_agent_async)
    with pytest.raises(Kept):
        atari_dqn_batch.run_actor_learner(str(tmp_path), num_envs=2, seed=5, env_id=ENV_ID, capacity=1024,
                                          device="cpu")
    example = load_example("batch")
    args = type("Args", (), {"env": ENV_ID, "seed": 5})()
    for idx, test in ((0, False), (1, True)):
        port, jax_env = kept["make_env"](idx, test), example.make_ale_env(args, idx, test)
        assert isinstance(port, RandomizeAction) == test
        if test:
            port._rng, jax_env._rng = np.random.RandomState(2), np.random.RandomState(2)
        _same_rollouts(_rollout(port, 120, idx), _rollout(jax_env, 120, idx))


def test_pipeline_without_sim_is_the_examples(monkeypatch):
    jstore, tstore = {}, {}

    def keep(store):
        def make(**kwargs):
            store.update(kwargs)
            raise Kept
        return make

    monkeypatch.setattr(jpipeline, "AtariActorLearnerPipeline", keep(jstore))
    monkeypatch.setattr(atari_pipeline, "make_dqn_pipeline", keep(tstore))
    argv = ["--env", ENV_ID, "--replay-capacity", "4096", "--seed", "3"]
    run_example("pipeline", monkeypatch, argv)
    with pytest.raises(Kept):
        atari_pipeline.run(argv, device="cpu")
    tfactory, jfactory = tstore.pop("env_factory"), jstore.pop("env_factory")
    jcore = jstore.pop("core")
    assert tstore.pop("n_actions") == jcore.explorer.n_actions == 4
    assert tstore.pop("lr") == 2.5e-4 and tstore.pop("compute_dtype") is None and tstore.pop("device") == "cpu"
    assert tstore == jstore  # workers, lanes, ring, batch, cadence, burst, seed
    # make_ale_plane_env: make_atari's MaxAndSkipEnv under a second one (16 raw frames per action).
    port, jax_env = tfactory(3), jfactory(3)
    assert type(port.env.env).__name__ == type(port.env.env.env).__name__ == "MaxAndSkipEnv"
    got = _rollout(port, 80, 1)
    _same_rollouts(got, _rollout(jax_env, 80, 1))
    assert got[0].shape == (84, 84, 1)


ONPOLICY = {
    "a2c": (atari_onpolicy_ale.run_a2c_ale, A2C, ("update_interval", "core.gamma", "core.use_gae", "core.lambd",
                                                  "core.entropy_coef", "core.value_func_coef")),
    "ppo": (atari_onpolicy_ale.run_ppo_ale, PPO, ("update_interval", "core.gamma", "core.lambd", "core.clip_eps",
                                                  "core.entropy_coef", "core.value_func_coef", "core.epochs",
                                                  "core.minibatch_size", "core.standardize_advantages")),
}


@pytest.mark.parametrize("kind", ["a2c", "ppo"])
def test_onpolicy_run_ale_is_the_examples(kind, monkeypatch, tmp_path):
    run, cls, attrs = ONPOLICY[kind]
    jstore, tstore = {}, {}
    monkeypatch.setattr(jexperiments, "train_agent_batch_with_evaluation", keeping(jstore))
    monkeypatch.setattr(atari_onpolicy_ale, "train_agent_batch_with_evaluation", keeping(tstore))
    argv = ["--env", ENV_ID, "--num-envs", "2", "--seed", "6", "--outdir", str(tmp_path)]
    run_example(kind, monkeypatch, argv)
    with pytest.raises(Kept):
        run(argv, device="cpu")
    tagent, jagent = tstore.pop("agent"), jstore.pop("agent")
    tenv = tstore.pop("env")
    jstore.pop("env"), tstore.pop("eval_env"), jstore.pop("eval_env")
    assert isinstance(tenv, MultiprocessVectorEnv) and tenv.closed
    for key in ("obs", "eval_obs"):
        _same_obs(tstore.pop(key), jstore.pop(key))
    assert tstore == jstore
    assert type(tagent) is cls
    for attr in attrs:
        assert _attr(tagent, attr) == pytest.approx(_attr(jagent, attr)), attr
    opt = tagent.core.optimizer
    if kind == "a2c":
        assert isinstance(opt, ClipByGlobalNorm) and opt.max_norm == 40.0 and isinstance(opt.inner, RMSprop)
        assert (opt.inner.learning_rate, opt.inner.decay, opt.inner.eps) == (7e-4, 0.99, 1e-5)
        assert tagent.update_interval == 5 * 2
    else:
        assert isinstance(opt, Adam) and (opt.learning_rate, opt.eps) == (2.5e-4, 1e-5)
        assert (tagent.update_interval, tagent.core.minibatch_size, tagent.core.epochs) == (1024, 256, 4)
    obs = np.random.RandomState(0).randint(0, 256, (16, 84, 84, 4)).astype(np.uint8)
    with jagent.eval_mode():
        jagent.batch_act(obs[:1])
    convert.onpolicy_shell_from_flax(tagent, np_tree(jagent.train_state))
    with jagent.eval_mode(), tagent.eval_mode():
        np.testing.assert_array_equal(tagent.batch_act(obs), np.asarray(jagent.batch_act(obs)))


def test_reproduction_run_ale_is_the_examples(monkeypatch, tmp_path):
    jstore, tstore = {}, {}
    monkeypatch.setattr(jexperiments, "train_agent_with_evaluation", keeping(jstore))
    monkeypatch.setattr(importlib.import_module("pfrl_tpu_torch.experiments.train_agent"),
                        "train_agent_with_evaluation", keeping(tstore))
    argv = ["--env", ENV_ID, "--outdir", str(tmp_path)]
    run_example("reproduction", monkeypatch, argv)
    with pytest.raises(Kept):
        atari_dqn_reproduction.run_ale(argv, device="cpu")
    tagent, jagent = tstore.pop("agent"), jstore.pop("agent")
    for store in (tstore, jstore):
        store.pop("env")
    teval, jeval = tstore.pop("eval_env"), jstore.pop("eval_env")
    assert isinstance(teval, RandomizeAction) and teval.random_fraction == jeval.random_fraction == 0.05
    np.testing.assert_array_equal(tstore.pop("obs"), jstore.pop("obs"))
    assert tstore == jstore  # steps, evaluation (125,000 steps every 250,000), outdir
    assert type(tagent) is DQN
    for attr in ("replay_start_size", "minibatch_size", "update_interval", "target_update_interval", "gamma",
                 "buffer.capacity", "buffer.num_lanes", "buffer.store_next_obs", "buffer.gamma",
                 "core.batch_accumulator", "core.explorer.end_epsilon", "core.explorer.decay_steps"):
        assert _attr(tagent, attr) == _attr(jagent, attr), attr
    assert (tagent.buffer.capacity, tagent.core.batch_accumulator, tagent.core.explorer.end_epsilon) == \
        (10**5, "sum", 0.1)
    opt = tagent.core.optimizer
    assert isinstance(opt, RMSprop) and (opt.learning_rate, opt.decay, opt.eps) == (2.5e-4, 0.95, 1e-2)
    obs = np.random.RandomState(1).randint(0, 256, (8, 84, 84, 4)).astype(np.uint8)
    # The example's phi calls np.asarray on the observation, which the JAX
    # shell traces inside jit: its act fails (ROADMAP C88). The port takes
    # atari_phi, the same division; the JAX shell acts here with it in jnp.
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jagent.batch_act(obs[:1])
    jagent.core.phi = lambda x: jnp.asarray(x, jnp.float32) / 255.0
    jagent._jit_act = None
    convert.dqn_shell_from_flax(tagent, np_tree(jagent.train_state))
    with jagent.eval_mode(), tagent.eval_mode():
        np.testing.assert_array_equal(tagent.batch_act(obs), np.asarray(jagent.batch_act(obs)))


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(atari_onpolicy_ale, "make_vector_envs", lambda *a, **k: spawned.append(a))
    for call in (lambda: atari_onpolicy_ale.run_a2c_ale(["--env", ENV_ID]),
                 lambda: atari_onpolicy_ale.run_ppo_ale(["--env", ENV_ID]),
                 lambda: atari_dqn_reproduction.run_ale(["--env", ENV_ID]),
                 lambda: atari_pipeline.run(["--env", ENV_ID]),
                 lambda: atari_dqn_batch.run_batch(str(tmp_path), env_id=ENV_ID)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not spawned


def test_profile_config_drives_run_ales_path(tmp_path):
    """``dqn-ale-host-per-1`` (``profile_slice --config`` and ``count_ops
    --config``, through ``profile_host``): ``run_ale --prioritized``'s shell
    over the stand-in's training and evaluation envs, its counts the run's."""
    from pfrl_tpu_torch.experiments import profile_slice
    from pfrl_tpu_torch.experiments.profile_host import HOST_PATHS, count_host_path_ops, make_host_path, run_host_batch

    assert "dqn-ale-host-per-1" in profile_slice.HOST_PATHS and HOST_PATHS["dqn-ale-host-per-1"].lanes == 1
    agent, env, eval_env = make_host_path("dqn-ale-host-per-1", device="cpu", capacity=512, replay_start_size=40)
    assert agent.buffer.tree_capacity == 512 and not agent.buffer.wants_next_obs
    assert type(env).__name__ == "FrameStack" and isinstance(eval_env, RandomizeAction)
    record = run_host_batch(agent, env, eval_env, steps=80, eval_interval=80, eval_n_episodes=1, outdir=str(tmp_path))
    assert record["t"] == 80 and record["n_updates"] == (80 - 40) // 4 + 1 and record["ring_slots"] == 512
    assert record["timings"]["update"]["n"] == record["n_updates"] and len(record["eval"]) == 1
    full = make_host_path("dqn-ale-host-per-1", device="cpu")[0]
    assert full.buffer.tree_capacity == 2**20 and full.replay_start_size == 50_000
    ops = count_host_path_ops("dqn-ale-host-per-1", device="cpu", capacity=512)
    assert ops["lanes"] == 1 and ops["ops_per_update"] > ops["ops_per_batch_act"] > 0
