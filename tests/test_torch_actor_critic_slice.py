"""The actor-critic slice as a whole at a small size: SAC and TD3 on
MujocoSim and DDPG on the time-limited Pendulum through the port's
``OffPolicyRunner`` and ``EvalLoop``, against the JAX package.

The port's runner draws from ``LoggedDraws``; the JAX side replays the log
through the package's own ``VectorJaxEnv``, ``ReplayBuffer`` and cores,
jitted, in the order of ``OffPolicyRunner._one_step``, with ``ValueKeys``
(``test_torch_continuous_envs.py``) installed so that every key is the
array of values to draw: act noise and burn-in actions, env resets, the
minibatch ids of a scan step, each update's noise. ``EvalLoop`` is held
against the real ``JaxEvalLoop`` on a real key: greedy actions draw
nothing, so the returns depend only on the start states, which the port is
handed by value.

4 lanes, hidden 32, batch 16, updates from 32 transitions, 30 scan steps
(88 to 92 updates for SAC and TD3, 46 for DDPG), one extra target sync of
the runner's at 48 transitions; episodes are cut to 12 (MujocoSim) and 10
steps (Pendulum) so that lanes are truncated and reset inside the run.
Over this horizon nothing is chaotic. Tolerances: flags, counters and ids
exact; observations, actions and rewards in the ring 1e-5; losses 1e-4
relative; parameters and targets 2e-5 absolute (Adam at 1e-3 to 3e-4 over
up to 92 updates); evaluation returns 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_actor_critic_modules import JaxDetPolicy, JaxSACPolicy, np_tree
from test_torch_continuous_envs import (
    LoggedDraws,
    ValueKeys,
    jax_mujoco_pair,
    mujoco_keys,
    pendulum_keys,
    step_keys,
)
from test_torch_sac import assert_adam, assert_network

from pfrl_tpu import envs as jenvs
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.agents.ddpg import DDPGCore as JaxDDPGCore
from pfrl_tpu.agents.soft_actor_critic import SACCore as JaxSACCore
from pfrl_tpu.agents.td3 import TD3Core as JaxTD3Core
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.agents import DDPGCore, SACCore, TD3Core
from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.replay import ReplayBuffer, Transition

torch.set_num_threads(1)

LANES, HIDDEN, BATCH, START, CAPACITY = 4, 32, 16, 32, 96  # the ring wraps inside the run
STEPS = 30
SYNC_EVERY = 48
MUJOCO_EPISODE, PENDULUM_LIMIT, BURNIN = 12, 10, 24
SMALL = dict(num_envs=LANES, capacity=CAPACITY, replay_start_size=START, minibatch_size=BATCH, hidden=HIDDEN)


def _jqf():
    return jq.FCSAQFunction(n_hidden_layers=2, n_hidden_channels=HIDDEN)


def _jburn(rng, n):
    return jax.random.uniform(rng, (n, 1), minval=-1.0, maxval=1.0)


def _setup(kind):
    """(JAX env, JAX core, port runner, obs width, action width, converter)
    of one configuration, before ``ValueKeys`` is installed."""
    if kind == "ddpg":
        jenv = jenvs.NormalizeActionSpace(jenvs.TimeLimit(jenvs.Pendulum(), PENDULUM_LIMIT))
        tenv = tenvs.NormalizeActionSpace(tenvs.TimeLimit(tenvs.Pendulum(device="cpu"), PENDULUM_LIMIT))
        jcore = JaxDDPGCore(
            policy=JaxDetPolicy(act_dim=1, hidden=HIDDEN), q_func=_jqf(),
            policy_optimizer=optax.adam(1e-3), q_optimizer=optax.adam(1e-3),
            explorer=jexplorers.AdditiveGaussian(0.1, low=-1.0, high=1.0), gamma=0.99,
            burnin_action_func=_jburn, burnin_steps=BURNIN,
        )
        runner = mac.make_ddpg_runner(update_interval=2, burnin_steps=BURNIN, env=tenv, **SMALL)
        return jenv, jcore, runner, 3, 1, convert.actor_critic_state_from_flax
    jenv, tenv = jax_mujoco_pair(episode_len=MUJOCO_EPISODE)
    adams = dict(policy_optimizer=optax.adam(3e-4), q_func1_optimizer=optax.adam(3e-4),
                 q_func2_optimizer=optax.adam(3e-4))
    if kind == "sac":
        jcore = JaxSACCore(policy=JaxSACPolicy(act_dim=6, hidden=HIDDEN), q_func1=_jqf(), q_func2=_jqf(),
                           gamma=0.99, entropy_target=-6.0, **adams)
        return jenv, jcore, mac.make_sac_runner(env=tenv, **SMALL), 17, 6, convert.sac_state_from_flax
    jcore = JaxTD3Core(policy=JaxDetPolicy(act_dim=6, hidden=HIDDEN), q_func1=_jqf(), q_func2=_jqf(),
                       explorer=jexplorers.AdditiveGaussian(0.1, low=-1.0, high=1.0), gamma=0.99,
                       policy_update_delay=2, **adams)
    return jenv, jcore, mac.make_td3_runner(env=tenv, **SMALL), 17, 6, convert.td3_state_from_flax


def _run_jax(monkeypatch, kind, jenv, jcore, train, draws, obs_dim, act_dim, updates_per_step):
    """``OffPolicyRunner._one_step``'s order over the JAX package's own
    vector env, ring and core, on the port's logged draws."""
    ValueKeys(monkeypatch)
    monkeypatch.setattr(
        jax.random, "randint", lambda key, shape, minval, maxval, dtype=jnp.int32: key.astype(dtype)
    )
    reset_keys = (lambda: pendulum_keys(draws, LANES)) if kind == "ddpg" else (
        lambda: mujoco_keys(draws, LANES, obs_dim))
    jvec = VectorJaxEnv(jenv, LANES)
    buf = JaxReplay(CAPACITY, gamma=0.99, num_lanes=LANES)
    assert buf.store_next_obs and buf.iid_samples
    select = jax.jit(lambda s, k, o, t: jcore.select_action(s, k, o, t, True))
    update, sync = jax.jit(jcore.update), jax.jit(jcore.sync_target)
    vstep, add = jax.jit(jvec.step), jax.jit(buf.add)
    sample_indices = jax.jit(buf.sample_indices, static_argnums=2)
    gather = jax.jit(buf.gather)

    env_states, obs = jvec.reset(reset_keys())
    replay = buf.init(JaxTransition(
        obs=obs[0], action=jnp.zeros((act_dim,)), reward=jnp.zeros(()), next_obs=obs[0],
        terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict(),
    ))
    t, metrics, finished = 0, {"loss": [], "reward_mean": [], "done_count": []}, []
    ep_ret = np.zeros(LANES, np.float32)
    zeros = jnp.zeros((LANES, act_dim))
    for _ in range(STEPS):
        (eps,) = draws.take("normal")
        burn = draws.take("uniform")[0].reshape(LANES, act_dim) if kind == "ddpg" and t < BURNIN else zeros
        act_key = jnp.stack([jnp.asarray(eps.reshape(LANES, act_dim)), jnp.asarray(burn)])
        actions = select(train, act_key, obs, jnp.int32(t))
        env_states, vec = vstep(step_keys(reset_keys()), env_states, actions)
        ts = vec.ts
        replay = add(replay, JaxTransition(
            obs=obs, action=actions, reward=ts.reward, next_obs=ts.obs,
            terminated=ts.terminated, done=ts.done, extras=FrozenDict(),
        ))
        t_prev, t = t, t + LANES
        ep_ret += np.asarray(ts.reward)
        done = np.asarray(ts.done)
        finished += list(ep_ret[done])
        ep_ret[done] = 0.0
        loss = 0.0
        if t >= START:
            (id_values,) = draws.take("randint_below")
            ids = sample_indices(replay, jnp.asarray(id_values), updates_per_step * BATCH)
            for row in ids.reshape(updates_per_step, BATCH):
                if kind == "sac":
                    key = jnp.stack([jnp.asarray(e.reshape(BATCH, act_dim)) for e in draws.take("normal", "normal")])
                elif kind == "td3":
                    (e,) = draws.take("normal")
                    key = jnp.stack([jnp.asarray(e.reshape(BATCH, act_dim)), jnp.zeros((BATCH, act_dim))])
                else:
                    key = jnp.zeros((2,))
                train, aux = update(train, key, gather(replay, row))
                loss = float(aux["loss"])
        if t // SYNC_EVERY != t_prev // SYNC_EVERY:
            train = sync(train)
        metrics["loss"].append(loss)
        metrics["reward_mean"].append(float(jnp.mean(ts.reward)))
        metrics["done_count"].append(int(done.sum()))
        obs = vec.obs
    assert not draws.log  # every draw the port made was replayed
    return t, replay, train, metrics, finished


NETS = {
    "sac": (("policy", "policy_params"), ("q_func1", "q1_params"), ("q_func2", "q2_params"),
            ("target_q_func1", "target_q1_params"), ("target_q_func2", "target_q2_params")),
    "td3": (("policy", "policy_params"), ("q_func1", "q1_params"), ("q_func2", "q2_params"),
            ("target_policy", "target_policy_params"), ("target_q_func1", "target_q1_params"),
            ("target_q_func2", "target_q2_params")),
    "ddpg": (("policy", "policy_params"), ("q_func", "q_params"),
             ("target_policy", "target_policy_params"), ("target_q_func", "target_q_params")),
}
ADAMS = {
    "sac": (("policy_opt_state", "policy"), ("q1_opt_state", "q_func1"), ("q2_opt_state", "q_func2")),
    "td3": (("policy_opt_state", "policy"), ("q1_opt_state", "q_func1"), ("q2_opt_state", "q_func2")),
    "ddpg": (("policy_opt_state", "policy"), ("q_opt_state", "q_func")),
}


@pytest.fixture(scope="module")
def trained():
    """The three small runs, port and JAX, shared by the tests below."""
    out = {}
    for kind in ("sac", "td3", "ddpg"):
        with pytest.MonkeyPatch.context() as monkeypatch:
            jenv, jcore, runner, obs_dim, act_dim, from_flax = _setup(kind)
            runner.config.target_update_interval = SYNC_EVERY
            jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, obs_dim)), jnp.zeros((LANES, act_dim)))
            draws = LoggedDraws(0)
            state = runner.init(0, draws=draws)
            state.train_state = from_flax(runner.core, np_tree(jtrain), device="cpu")
            state, metrics = runner.run_chunk(state, STEPS)
            kinds = [k for k, _ in draws.log]
            jax_run = _run_jax(
                monkeypatch, kind, jenv, jcore, jtrain, draws, obs_dim, act_dim, runner.config.updates_per_step
            )
        out[kind] = dict(runner=runner, state=state, metrics=metrics, kinds=kinds, jax=jax_run,
                         jenv=jenv, jcore=jcore)
    return out


@pytest.mark.parametrize("kind", ["sac", "td3", "ddpg"])
def test_runner_matches_jax_module_loop(trained, kind):
    run = trained[kind]
    runner, state, metrics = run["runner"], run["state"], run["metrics"]
    t, replay, train, jmetrics, finished = run["jax"]
    cfg = runner.config
    update_steps = sum(1 for k in range(1, STEPS + 1) if k * LANES >= START)
    assert cfg.updates_per_step == (2 if kind == "ddpg" else 4)
    assert state.t == t == STEPS * LANES
    assert int(state.replay_state.cursor) == int(replay.cursor) == STEPS * LANES > CAPACITY
    n_updates = update_steps * cfg.updates_per_step
    assert state.train_state.n_updates == int(train.n_updates) == n_updates
    # One id draw per scan step with updates; per update two noise draws (SAC), one (TD3), none (DDPG).
    assert run["kinds"].count("randint_below") == update_steps
    per_update = {"sac": 2, "td3": 1, "ddpg": 0}[kind]
    assert run["kinds"].count("normal") == STEPS + per_update * n_updates + (0 if kind == "ddpg" else STEPS + 1)
    assert run["kinds"].count("uniform") == (2 * (STEPS + 1) + BURNIN // LANES if kind == "ddpg" else 0)

    storage = state.replay_state.storage
    assert set(storage) == {"obs", "action", "reward", "terminated", "done", "next_obs"}
    assert storage["action"].shape == (CAPACITY, runner.env.action_space.shape[0])  # a 2-D float leaf, unpadded
    assert storage["obs"].dtype == storage["action"].dtype == torch.float32
    for name in ("terminated", "done"):
        np.testing.assert_array_equal(storage[name].numpy(), np.asarray(getattr(replay.storage, name)), err_msg=name)
    for name in ("obs", "action", "reward", "next_obs"):
        np.testing.assert_allclose(
            storage[name].numpy(), np.asarray(getattr(replay.storage, name)), atol=1e-5, rtol=0, err_msg=name
        )
    assert storage["done"].any() and not storage["terminated"].any()  # truncated, never terminated
    assert float(storage["action"].abs().max()) <= 1.0

    np.testing.assert_allclose(metrics["loss"].numpy(), jmetrics["loss"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(metrics["reward_mean"].numpy(), jmetrics["reward_mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(metrics["done_count"].numpy(), jmetrics["done_count"])
    assert (metrics["loss"][: START // LANES - 1] == 0).all() and (metrics["loss"][START // LANES - 1:] > 0).all()
    assert int(state.recent_count) == len(finished) > 0
    np.testing.assert_allclose(runner.recent_return_mean(state), np.mean(finished), rtol=1e-5, atol=1e-5)

    ts = state.train_state
    for attr, field in NETS[kind]:
        assert_network(getattr(ts, attr), getattr(train, field), 2e-5, f"{kind} {attr}")
    for attr, module in ADAMS[kind]:
        assert_adam(getattr(ts, attr), getattr(ts, module), getattr(train, attr), f"{kind} {attr}")
    if kind == "sac":
        np.testing.assert_allclose(float(ts.log_temperature.detach()), float(train.log_temperature), atol=2e-5)
        assert ts.temperature_opt_state.count == n_updates and float(ts.log_temperature.detach()) < -1e-3
    if kind == "td3":
        assert ts.policy_opt_state.count == int(train.policy_opt_state[0].count) == n_updates // 2
    assert isinstance(runner.core, {"sac": SACCore, "td3": TD3Core, "ddpg": DDPGCore}[kind])


def test_a_time_limit_truncation_still_bootstraps(trained):
    """The ring's rows at a time-limit boundary: ``done`` without
    ``terminated``, the stored ``next_obs`` the pre-reset observation, and
    a gathered batch whose ``is_terminal`` is false everywhere."""
    run = trained["ddpg"]
    runner, state = run["runner"], run["state"]
    storage = state.replay_state.storage
    done = storage["done"]
    # The ring holds scan steps 7 to 30 of every lane: the boundaries at 10, 20 and 30.
    assert int(done.sum()) == LANES * 3
    ids = torch.arange(STEPS * LANES - CAPACITY, STEPS * LANES, dtype=torch.int32)
    batch = runner.buffer.gather(state.replay_state, ids)
    assert not batch.is_terminal.any() and (batch.discount == np.float32(0.99)).all()
    # After a boundary the next row of the lane starts a fresh episode: its
    # obs is not the boundary row's next_obs; elsewhere it is.
    slots = ids % CAPACITY
    nxt = (ids + LANES) % CAPACITY
    inside = ids + LANES < STEPS * LANES
    same = (storage["next_obs"][slots] == storage["obs"][nxt]).all(dim=1)
    assert (same[inside] == ~done[slots][inside]).all()


@pytest.mark.parametrize("kind", ["sac", "td3", "ddpg"])
def test_eval_loop_matches_jax_eval_loop_through_a_truncation(trained, kind):
    """The real ``JaxEvalLoop`` on a real key against the port's
    ``EvalLoop`` handed the same start states: each lane scores its first
    episode, which ends by truncation (never termination); the loop runs on
    through the auto-reset."""
    run = trained[kind]
    lanes = 5
    episode = PENDULUM_LIMIT if kind == "ddpg" else MUJOCO_EPISODE
    max_steps = episode + 3
    _, _, jtrain, _, _ = run["jax"]
    key = jax.random.PRNGKey(7)
    want = JaxEvalLoop(run["jenv"], run["jcore"], lanes, max_steps).evaluate(jtrain, key)

    lane_keys = jax.random.split(jax.random.split(key)[1], lanes)
    rs = np.random.RandomState(0)
    if kind == "ddpg":
        halves = [jax.random.split(k) for k in lane_keys]
        first = [np.array([float(jax.random.uniform(h[i], ())) for h in halves], np.float32) for i in (0, 1)]
        later = lambda n: rs.uniform(size=n).astype(np.float32)  # noqa: E731
    else:
        first = [np.concatenate([np.asarray(jax.random.normal(k, (17,))) for k in lane_keys])]
        later = lambda n: rs.standard_normal(n).astype(np.float32)  # noqa: E731

    class StartStates:
        """The JAX loop's start states by value, then seeded draws."""

        calls = 0

        def _draw(self, n):
            self.calls += 1
            return torch.from_numpy(first.pop(0).copy() if first else later(n))

        uniform = normal = _draw

    draws = StartStates()
    loop = EvalLoop(run["runner"].env.env, run["runner"].core, lanes, max_steps, device="cpu")
    assert isinstance(loop, EvalLoop) and loop.device == torch.device("cpu")
    got = loop.evaluate(run["state"].train_state, draws)
    assert got.shape == want.shape == (lanes,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert draws.calls == (2 if kind == "ddpg" else 1) * (max_steps + 1)  # resets only: greedy actions draw nothing
    # A longer loop gives the same returns: the first episode scores, cut by the time limit.
    again = JaxEvalLoop(run["jenv"], run["jcore"], lanes, max_steps + 5).evaluate(jtrain, key)
    np.testing.assert_allclose(again, want, rtol=1e-6)


# ------------------------------------------------------------------- the ring
@pytest.mark.parametrize("num_steps", [1, 3])
def test_float_observations_and_vector_actions_in_the_ring_match_jax(num_steps):
    """Width-17 float32 observations (under 128: no pad), float32 ``[6]``
    actions and stored ``next_obs``: add and gather, wrapped, exactly."""
    lanes, cap = 3, 24
    rs = np.random.RandomState(num_steps)
    kw = dict(num_steps=num_steps, gamma=0.99, num_lanes=lanes, store_next_obs=True)
    jbuf, tbuf = JaxReplay(cap, **kw), ReplayBuffer(cap, device="cpu", **kw)
    steps = []
    for _ in range(13):
        done = rs.uniform(size=lanes) < 0.2
        steps.append(dict(
            obs=rs.normal(size=(lanes, 17)).astype(np.float32),
            action=rs.uniform(-1, 1, (lanes, 6)).astype(np.float32),
            reward=rs.normal(size=lanes).astype(np.float32),
            next_obs=rs.normal(size=(lanes, 17)).astype(np.float32),
            terminated=done & (rs.uniform(size=lanes) < 0.5),
            done=done,
        ))
    first = {k: v[0] for k, v in steps[0].items()}
    js = jbuf.init(JaxTransition(**{k: jnp.asarray(v) for k, v in first.items()}, extras=FrozenDict()))
    ts = tbuf.init(Transition(**{k: torch.from_numpy(np.asarray(v)) for k, v in first.items()}))
    for d in steps:
        js = jbuf.add(js, JaxTransition(**{k: jnp.asarray(v) for k, v in d.items()}, extras=FrozenDict()))
        ts = tbuf.add(ts, Transition(**{k: torch.from_numpy(v) for k, v in d.items()}))
    assert ts.storage["obs"].shape == (cap, 17) and ts.storage["action"].shape == (cap, 6)
    assert ts.storage["next_obs"].shape == (cap, 17)
    for name, s in ts.storage.items():
        np.testing.assert_array_equal(s.numpy(), np.asarray(getattr(js.storage, name)), err_msg=name)
    lo, hi = (int(x) for x in tbuf._sampleable_range(ts))
    assert (lo, hi) == tuple(int(x) for x in jbuf._sampleable_range(js))
    ids = np.arange(lo, hi, dtype=np.int32)
    tb, jb = tbuf.gather(ts, torch.from_numpy(ids)), jbuf.gather(js, jnp.asarray(ids))
    for name in ("obs", "action", "reward", "next_obs", "discount", "is_terminal"):
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tb.obs.shape == (len(ids), 17) and tb.action.shape == (len(ids), 6)


# ----------------------------------------------------------------- the recipes
def test_runners_hold_the_recipes_and_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (mac.make_sac_runner, mac.make_td3_runner, mac.make_ddpg_runner):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    sac, td3 = mac.make_sac_runner(device="cpu"), mac.make_td3_runner(device="cpu")
    for runner in (sac, td3):
        cfg, buf, core = runner.config, runner.buffer, runner.core
        assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.n_times_update, cfg.minibatch_size,
                cfg.updates_per_step, cfg.target_update_interval) == (32, 1_000, 1, 1, 256, 32, 1_000)
        assert (buf.capacity, buf.num_steps, buf.gamma, buf.num_lanes) == (100_000, 1, 0.99, 32)
        assert buf.store_next_obs and buf.fused_dequant_scale is None and buf.iid_samples
        assert isinstance(runner.env.env, tenvs.MujocoSim) and runner.env.env.episode_len == 1_000
        assert (core.gamma, core.soft_update_tau) == (0.99, 5e-3)
        for q in (core.q_func1, core.q_func2):
            assert [tuple(layer.weight.shape) for layer in q.mlp.layers] == [(256, 23), (256, 256), (1, 256)]
        for opt in (core.policy_optimizer, core.q_func1_optimizer, core.q_func2_optimizer):
            assert (opt.learning_rate, opt.b1, opt.b2, opt.eps) == (3e-4, 0.9, 0.999, 1e-8)
    assert [tuple(layer.weight.shape) for layer in sac.core.policy.mlp.layers] == [(256, 17), (256, 256), (12, 256)]
    assert (sac.core.entropy_target, sac.core.initial_temperature) == (-6.0, 1.0)
    assert sac.core.temperature_optimizer.learning_rate == 3e-4 and sac.core.explorer is None
    assert [tuple(layer.weight.shape) for layer in td3.core.policy.mlp.layers] == [(256, 17), (256, 256), (6, 256)]
    assert td3.core.policy_update_delay == 2 and td3.core.policy.squash is torch.tanh
    assert (td3.core.explorer.scale, td3.core.explorer.low, td3.core.explorer.high) == (0.1, -1.0, 1.0)

    ddpg = mac.make_ddpg_runner(device="cpu")
    cfg, core, env = ddpg.config, ddpg.core, ddpg.env.env
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.minibatch_size, cfg.updates_per_step) == (
        16, 1_000, 4, 128, 4)
    assert isinstance(env, tenvs.NormalizeActionSpace) and isinstance(env.env, tenvs.TimeLimit)
    assert isinstance(env.env.env, tenvs.Pendulum) and env.env.max_steps == 200
    assert [tuple(layer.weight.shape) for layer in core.policy.mlp.layers] == [(64, 3), (64, 64), (1, 64)]
    assert [tuple(layer.weight.shape) for layer in core.q_func.mlp.layers] == [(64, 4), (64, 64), (1, 64)]
    assert core.policy_optimizer.learning_rate == core.q_optimizer.learning_rate == 1e-3
    assert (core.burnin_steps, core.clip_delta, core.target_update_method, core.soft_update_tau) == (
        1_000, True, "soft", 5e-3)
    assert ddpg.buffer.capacity == 100_000 and ddpg.buffer.store_next_obs
