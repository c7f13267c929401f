"""``experiments/atari_dqn_batch.py`` (``train_dqn_batch_ale.py``'s
``run_batch``) against the example's own ``build_agent``.

(a) The recipe holds the example's settings at its defaults: the network's
    flax scopes, Adam's rate and eps, the 10^6-slot ring without stored
    next observations and with the fused 1/255, the exploration schedule,
    the replay start, batch, update and target-sync intervals.
(b) A small run (the ring cut to 512 slots, the replay start to 40, the
    target sync to 40; the Nature CNN at full width): the port's shell and
    the example's JAX shell, the same initial state, go through their
    package's ``train_agent_batch_with_evaluation`` over two lanes of the
    same stack (``wrap_deepmind`` around ``MaxAndSkipEnv(SyntheticALE(seed),
    skip=4)``, each package's own wrappers and frame ops), and the JAX run
    pops the port's logged draws (``install_tape``, ``jax.disable_jit``).
    Held: the observations, actions, syncs and updates exactly; the
    statistics within 1e-5 relative; the parameters and moments as
    ``test_torch_host_agents.py`` holds them (3e-6, or 4x what ulp nudges
    of the starting weights move them).
(c) The recipe's vector envs: two spawned ``MultiprocessVectorEnv`` of
    ``envs.synthetic_ale.make_ale_env`` (84x84x4 uint8 stacks); the
    evaluation envs randomize 5% of the actions.
(d) Its entry points need a card or ``device="cpu"``, and raise before
    any worker spawns.
"""

import functools
import importlib.util
import os
import types

import jax
import numpy as np
import pytest
import torch
from test_torch_host_agents import NUDGES, assert_dqn_states_close, assert_stats_close, new_log, record, scale_weights
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu.envs import SerialVectorEnv as JaxSerialVectorEnv
from pfrl_tpu.envs.synthetic_ale import SyntheticALE as JaxSyntheticALE
from pfrl_tpu.experiments import train_agent_batch_with_evaluation as jax_train_batch
from pfrl_tpu.wrappers import atari_wrappers as jax_atari_wrappers
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.envs import SerialVectorEnv, synthetic_ale
from pfrl_tpu_torch.experiments import atari_dqn_batch, train_agent_batch_with_evaluation
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.replay import ReplayBuffer
from pfrl_tpu_torch.wrappers import RandomizeAction

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(replay_capacity=512, replay_start_size=40, target_update_interval=40)


def load_example():
    path = os.path.join(REPO, "examples/atari/train_dqn_batch_ale.py")
    spec = importlib.util.spec_from_file_location("train_dqn_batch_ale", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EXAMPLE = load_example()


def _args(**overrides):
    """``train_dqn_batch_ale.py``'s defaults (``:230-262``)."""
    return types.SimpleNamespace(**{**dict(
        seed=0, bf16=False, lr=2.5e-4, batch_size=32, num_envs=8, replay_capacity=10**6,
        replay_start_size=5 * 10**4, update_interval=4, target_update_interval=10**4), **overrides})


def test_recipe_holds_the_examples_settings():
    jagent = EXAMPLE.build_agent(6, 8, _args())
    tagent = atari_dqn_batch.make_dqn_batch_agent(device="cpu")
    assert isinstance(tagent.core.model, NatureQ) and tagent.core.phi.__name__ == "atari_phi"
    jbuf, tbuf = jagent.buffer, tagent.buffer
    assert isinstance(tbuf, ReplayBuffer) and type(tbuf).__name__ == type(jbuf).__name__
    for attr in ("capacity", "num_lanes", "num_steps", "gamma", "store_next_obs", "fused_dequant_scale",
                 "wants_next_obs"):
        assert getattr(tbuf, attr) == getattr(jbuf, attr), attr
    assert tbuf.capacity == 10**6 and not tbuf.wants_next_obs and tbuf.fused_dequant_scale == 1 / 255
    for attr in ("replay_start_size", "minibatch_size", "update_interval", "target_update_interval",
                 "n_times_update", "gamma"):
        assert getattr(tagent, attr) == getattr(jagent, attr), attr
    assert (tagent.replay_start_size, tagent.update_interval, tagent.target_update_interval) == (50_000, 4, 10_000)
    tex, jex = tagent.core.explorer, jagent.core.explorer
    assert (tex.start_epsilon, tex.end_epsilon, tex.decay_steps, tex.n_actions) == \
        (jex.start_epsilon, jex.end_epsilon, jex.decay_steps, jex.n_actions) == (1.0, 0.01, 10**6, 6)
    assert isinstance(tagent.core.optimizer, Adam)
    assert (tagent.core.optimizer.learning_rate, tagent.core.optimizer.eps) == (2.5e-4, 1.5e-4)
    assert (tagent.core.gamma, tagent.core.batch_accumulator, tagent.core.clip_delta) == \
        (jagent.core.gamma, jagent.core.batch_accumulator, jagent.core.clip_delta)
    # The example's network converts into the recipe's, scope for scope.
    jagent._ensure_init(np.zeros((1, 84, 84, 4), np.uint8))
    convert.dqn_shell_from_flax(tagent, np_tree(jagent.train_state))
    obs = np.random.RandomState(0).randint(0, 256, (3, 84, 84, 4)).astype(np.uint8)
    with tagent.eval_mode(), jagent.eval_mode():
        np.testing.assert_array_equal(tagent.batch_act(obs), np.asarray(jagent.batch_act(obs)))


def _jax_stack(seed, idx):
    env = jax_atari_wrappers.MaxAndSkipEnv(JaxSyntheticALE(seed + idx), skip=4)
    return jax_atari_wrappers.wrap_deepmind(env, episode_life=False, clip_rewards=True, channel_order="hwc")


def _log_obs(venv, log):
    step = venv.step

    def logged_step(actions):
        out = step(actions)
        log.append(np.asarray(out[0]))
        return out

    venv.step = logged_step
    return venv


def test_small_run_matches_the_examples_shell(tmp_path):
    jagent = EXAMPLE.build_agent(6, 2, _args(num_envs=2, **SMALL))
    jagent._ensure_init(np.zeros((1, 84, 84, 4), np.uint8))
    jstate = np_tree(jagent.train_state)
    kw = dict(steps=120, eval_n_steps=None, eval_n_episodes=1, eval_interval=10**6)

    def port_run(scale, outdir):
        tape, log, frames = Tape(13), new_log(), []
        tagent = atari_dqn_batch.make_dqn_batch_agent(
            num_envs=2, capacity=512, replay_start_size=40, target_update_interval=40, device="cpu", draws=tape)
        scale_weights(convert.dqn_shell_from_flax(tagent, jstate), scale)
        env = _log_obs(SerialVectorEnv([synthetic_ale.make_ale_env(0, i, False) for i in range(2)]), frames)
        train_agent_batch_with_evaluation(record(tagent, log), env, outdir=outdir, **kw)
        return tagent, tape, log, frames

    tagent, tape, tlog, tframes = port_run(1.0, str(tmp_path / "port"))
    nudged = [port_run(s, str(tmp_path / f"nudged{i}"))[0] for i, s in enumerate(NUDGES)]
    assert tagent.replay_state.storage["obs"].shape == (512, 28_288)  # 84 * 84 * 4 = 28,224, padded
    assert "next_obs" not in tagent.replay_state.storage
    jlog, jframes = new_log(), []
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        env = _log_obs(JaxSerialVectorEnv([_jax_stack(0, i) for i in range(2)]), jframes)
        jax_train_batch(record(jagent, jlog), env, outdir=str(tmp_path / "jax"), **kw)
        assert not tape.log
    assert len(tframes) == len(jframes) == 60
    for got, want in zip(tframes, jframes):
        np.testing.assert_array_equal(got, want)
    assert len(tlog["actions"]) == len(jlog["actions"]) == 60
    for got, want in zip(tlog["actions"], jlog["actions"]):
        np.testing.assert_array_equal(got, want)
    assert tlog["syncs"] == jlog["syncs"] == 3
    assert tagent.t == jagent.t == 120 and tagent.optim_t == jagent.optim_t == (120 - 40) // 4 + 1
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics())
    assert_dqn_states_close(tagent, jagent, nudged, "dqn-batch-ale")


def test_recipe_vector_envs_spawn_the_examples_stack():
    env, eval_env = atari_dqn_batch.make_vector_envs(num_envs=2, seed=3, make_env=synthetic_ale.make_ale_env)
    try:
        assert env.num_envs == eval_env.num_envs == 2 and env.action_space.n == 6
        obs = env.reset()
        assert np.asarray(obs[0]).shape == (84, 84, 4) and np.asarray(obs[0]).dtype == np.uint8
        direct = synthetic_ale.make_ale_env(3, 1, False)
        np.testing.assert_array_equal(np.asarray(obs[1]), np.asarray(direct.reset()))
        obs, rewards, dones, infos = env.step([1, 2])
        np.testing.assert_array_equal(np.asarray(obs[1]), np.asarray(direct.step(2)[0]))
        assert rewards.dtype == np.float32 and dones.dtype == bool
    finally:
        env.close()
        eval_env.close()
    test_env = synthetic_ale.make_ale_env(3, 0, True)
    assert isinstance(test_env, RandomizeAction) and test_env.random_fraction == 0.05


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(atari_dqn_batch, "make_vector_envs", lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        atari_dqn_batch.make_dqn_batch_agent()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        atari_dqn_batch.run_batch(str(tmp_path))
    assert not spawned
    assert atari_dqn_batch.make_dqn_batch_agent(device="cpu", capacity=64).device == torch.device("cpu")


def test_host_batch_profile_counts_the_run(tmp_path):
    """``profile_host.run_host_batch`` (what ``chip_smoke.py`` and
    ``profile_slice --config dqn-batch-ale-8`` measure with) over two lanes
    on the CPU: its counts are the run's, its timers are taken off again,
    and the evaluation lands in the record."""
    from pfrl_tpu_torch.experiments.profile_host import count_host_ops, run_host_batch

    agent = atari_dqn_batch.make_dqn_batch_agent(num_envs=2, capacity=512, replay_start_size=40,
                                                 target_update_interval=40, device="cpu")
    env = SerialVectorEnv([synthetic_ale.make_ale_env(0, i, False) for i in range(2)])
    eval_env = SerialVectorEnv([synthetic_ale.make_ale_env(0, i, True) for i in range(2)])
    record = run_host_batch(agent, env, eval_env, steps=120, eval_interval=120, eval_n_episodes=1,
                            outdir=str(tmp_path))
    assert record["t"] == 120 and record["n_updates"] == (120 - 40) // 4 + 1 and record["target_syncs"] == 3
    timings = record["timings"]
    assert timings["batch_act"]["n"] == timings["env round trip"]["n"] == 60
    assert timings["update"]["n"] == record["n_updates"]
    assert timings["batch_observe (ring add)"]["n"] + timings["batch_observe with updates"]["n"] == 60
    assert record["env_steps_per_s_before_replay_start"] > 0 and record["updates_per_s_after_replay_start"] > 0
    assert record["ring_bytes"] == 512 * (28_288 + 4 + 4 + 1 + 1) and record["ring_slots"] == 512  # int32 actions
    assert len(record["eval"]) == 1 and record["eval"][0]["step"] == 120 and "profiled" not in record
    assert not {"batch_act", "batch_observe", "_update_once"} & set(vars(agent)) and "step" not in vars(env)
    ops = count_host_ops(atari_dqn_batch.make_dqn_batch_agent(capacity=512, device="cpu"))
    assert ops["lanes"] == 8 and ops["ops_per_update"] > ops["ops_per_batch_act"] > ops["ops_per_batch_observe"] > 0
