"""NAF and the gym examples in the port against the JAX package:
``MountainCarContinuous``, ``lower_triangular_matrix``,
``QuadraticActionValue``, ``SingleActionValue``,
``FCQuadraticStateQFunction`` (and its conversion), three NAF ``DQNCore``
updates, ``train_dqn_gym.py``'s device runner on Pendulum and MountainCar
against the JAX package's vector env, ring and core driven in the
runner's order, its host mode (``run_gymnasium``) on gymnasium's
``Pendulum-v1`` against the JAX script's shell, and
``train_categorical_dqn_gym.py``'s host mode on ``CartPole-v1``.

Draws: the runner comparisons draw ``LoggedDraws`` in the port and replay
them in JAX with ``ValueKeys`` (``test_torch_continuous_envs.py``); the
host shells draw ``Tape`` and the JAX shell replays it under
``jax.disable_jit`` (``install_tape``, C29).

Tolerances: MountainCar to the bit against eager JAX for 30 steps, then
(and against jitted XLA from the first step: ``cos`` and fusion an ulp
apart, C28) within 1e-6 over 200 steps with the goal crossed on the same
step by every lane; the triangular matrices and every d = 1 quadratic value to the bit;
d = 3 quadratic values (a three-term einsum summed in another order)
within 1e-6 of their scale; the network's outputs within 2e-6 of their
scale; the core's loss within 1e-6 relative and parameters within 1e-6
after one update and 3e-6 after three (C22); the device runs'
observations, actions and rewards in the ring within 1e-5, losses 1e-4
relative, parameters 2e-5 (as the actor-critic slice holds them); the
host shells' continuous actions and statistics within 1e-5 (relative for
the statistics) and learned tensors within 3e-6 (NAF's first moments
1e-5 of their scale, as IQN's), or 4x what ulp nudges of the starting
weights move them; discrete actions, counts and evaluation rows exactly,
and C51's statistics within 1e-5 relative.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_continuous_envs import LoggedDraws, ValueKeys, pendulum_keys, step_keys
from test_torch_host_actor_critic import assert_within_nudges
from test_torch_host_agents import (
    NUDGES,
    _dqn_tensors,
    _jax_dqn_tensors,
    assert_stats_close,
    new_log,
    record,
    scale_weights,
)
from test_torch_host_recipes import Kept, keep
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu import experiments as jexperiments
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.action_value import QuadraticActionValue as JaxQuadratic
from pfrl_tpu.action_value import SingleActionValue as JaxSingle
from pfrl_tpu.agents.dqn import DQNCore as JaxDQNCore
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.functions import lower_triangular_matrix as jax_ltm
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.replay import TransitionBatch as JaxBatch
from pfrl_tpu_torch import convert, spaces
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.action_value import QuadraticActionValue, SingleActionValue
from pfrl_tpu_torch.agents import DQNCore
from pfrl_tpu_torch.envs import MountainCarContinuous
from pfrl_tpu_torch.experiments import (
    categorical_dqn_gym,
    dqn_gym,
    train_agent_batch_with_evaluation,
    train_agent_with_evaluation,
)
from pfrl_tpu_torch.functions import lower_triangular_matrix
from pfrl_tpu_torch.q_functions import FCQuadraticStateQFunction
from pfrl_tpu_torch.replay import TransitionBatch

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- MountainCar
@pytest.mark.parametrize("jit", [False, True])
def test_mountain_car_matches_jax_per_step_through_the_goal(monkeypatch, jit):
    """Eager JAX agrees to the bit for the first 30 steps (the first ulp
    apart, from ``cos``, came at step 38 here); jitted XLA fuses the
    velocity update and is an ulp apart from step 1 (C28). Both stay within
    1e-6 over 200 steps, and every lane terminates on the same step."""
    lanes = 8
    jenv, tenv = jenvs.MountainCarContinuous(), MountainCarContinuous(device="cpu")
    draws = LoggedDraws(0)
    tstate, tobs = tenv.reset(draws, lanes)
    (u,) = draws.take("uniform")
    ValueKeys(monkeypatch)
    jstate, jobs = jax.vmap(jenv.reset)(jnp.asarray(u))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert tobs.dtype == torch.float32 and tobs.shape == (lanes, 2)
    vstep = jax.vmap(jenv.step, in_axes=(None, 0, 0))
    vstep = jax.jit(vstep) if jit else vstep
    rs = np.random.RandomState(1)
    reached = np.zeros(lanes, bool)
    for i in range(200):
        # Pump with the velocity, past the clip, and some noise.
        vel = tobs.numpy()[:, 1]
        actions = (np.where(vel >= 0, 1.3, -1.3) + rs.uniform(-0.5, 0.5, lanes)).astype(np.float32)[:, None]
        tstate, ts = tenv.step(tstate, _t(actions))
        jstate, jts = vstep(None, jstate, jnp.asarray(actions))
        for got, want in ((ts.obs, jts.obs), (ts.reward, jts.reward)):
            if i < 30 and not jit:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ts.terminated.numpy(), np.asarray(jts.terminated))
        np.testing.assert_array_equal(ts.truncated.numpy(), np.asarray(jts.truncated))
        reached |= ts.terminated.numpy()
        tobs = ts.obs
    assert reached.all()  # every lane crossed the goal (reward 100 - 0.1 f^2 there)
    assert (tobs.numpy()[:, 0] >= -1.2).all() and (np.abs(tobs.numpy()[:, 1]) <= 0.07).all()


def test_mountain_car_left_wall_zeroes_a_negative_velocity():
    env = MountainCarContinuous(device="cpu")
    state = tenvs.MCState(pos=torch.tensor([-1.19, -1.0]), vel=torch.tensor([-0.05, -0.05]))
    state, ts = env.step(state, torch.tensor([[-1.0], [-1.0]]))
    assert float(state.pos[0]) == np.float32(-1.2) and float(state.vel[0]) == 0.0 and float(state.vel[1]) < 0


# ------------------------------------------------------ triangular matrices
@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_lower_triangular_matrix_matches_jax(n):
    rs = np.random.RandomState(n)
    diag = rs.normal(size=(4, n)).astype(np.float32)
    non_diag = (np.arange(4 * (n * (n - 1) // 2), dtype=np.float32) + 10.0).reshape(4, -1)  # distinct values
    got = lower_triangular_matrix(_t(diag), _t(non_diag))
    want = jax_ltm(jnp.asarray(diag), jnp.asarray(non_diag))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows, cols = torch.tril_indices(n, n, -1)
    np.testing.assert_array_equal(np.stack([rows.numpy(), cols.numpy()]), np.stack(np.tril_indices(n, -1)))
    assert (torch.triu(got, 1) == 0).all()


# ----------------------------------------------------------- action values
def _quadratic_inputs(d, seed=0, b=16):
    rs = np.random.RandomState(seed)
    mu = rs.uniform(-1.0, 1.0, (b, d)).astype(np.float32)
    tril = np.tril(rs.normal(size=(b, d, d))).astype(np.float32)
    mat = np.einsum("bij,bkj->bik", tril, tril).astype(np.float32)
    v = rs.normal(size=b).astype(np.float32)
    a = rs.uniform(-1.0, 1.0, (b, d)).astype(np.float32)
    return mu, mat, v, a


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("bounded", [True, False])
def test_quadratic_action_value_matches_jax(d, bounded):
    mu, mat, v, a = _quadratic_inputs(d)
    lo, hi = (np.full(d, -0.5, np.float32), np.full(d, 0.7, np.float32)) if bounded else (None, None)
    tav = QuadraticActionValue(_t(mu), _t(mat), _t(v), None if lo is None else _t(lo), None if hi is None else _t(hi))
    jav = JaxQuadratic(mu=jnp.asarray(mu), mat=jnp.asarray(mat), v=jnp.asarray(v),
                       min_action=None if lo is None else jnp.asarray(lo), max_action=None if hi is None else jnp.asarray(hi))
    np.testing.assert_array_equal(tav.greedy_actions().numpy(), np.asarray(jav.greedy_actions()))
    for got, want in ((tav.evaluate_actions(_t(a)), jav.evaluate_actions(jnp.asarray(a))), (tav.max(), jav.max())):
        got, want = got.numpy(), np.asarray(want)
        if d == 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))
    if bounded:  # max evaluates the clipped greedy action: v only where mu lies within the bounds
        inside = ((mu >= -0.5) & (mu <= 0.7)).all(axis=1)
        assert inside.any() and (~inside).any()
        assert (tav.max().numpy()[~inside] < v[~inside]).all()
    else:
        np.testing.assert_array_equal(tav.max().numpy(), v)


def test_single_action_value_matches_jax():
    rs = np.random.RandomState(3)
    w, a, g = (rs.normal(size=(5, 2)).astype(np.float32) for _ in range(3))
    tav = SingleActionValue(lambda x: (x * _t(w)).sum(-1), lambda: _t(g))
    jav = JaxSingle(lambda x: (x * jnp.asarray(w)).sum(-1), lambda: jnp.asarray(g))
    np.testing.assert_array_equal(tav.greedy_actions().numpy(), np.asarray(jav.greedy_actions()))
    np.testing.assert_array_equal(tav.max().numpy(), np.asarray(jav.max()))
    np.testing.assert_array_equal(tav.evaluate_actions(_t(a)).numpy(), np.asarray(jav.evaluate_actions(jnp.asarray(a))))
    for av in (SingleActionValue(lambda x: x), JaxSingle(lambda x: x)):
        with pytest.raises(RuntimeError, match="without maximizer"):
            av.greedy_actions()


# ------------------------------------------------------ the NAF Q-function
def _naf_pair(d, scale_mu=True, obs=5, hidden=16, seed=0):
    low, high = tuple(float(x) for x in np.linspace(-2.0, -0.5, d)), tuple(float(x) for x in np.linspace(1.0, 2.5, d))
    jnet = jq.FCQuadraticStateQFunction(n_input_channels=obs, n_dim_action=d, n_hidden_channels=hidden,
                                        n_hidden_layers=2, action_space_low=low, action_space_high=high,
                                        scale_mu=scale_mu)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs)))
    tnet = FCQuadraticStateQFunction(obs, d, hidden, 2, low, high, scale_mu=scale_mu)
    convert.load_flax_params(tnet, np_tree(params))
    return jnet, params, tnet


@pytest.mark.parametrize("d,scale_mu", [(1, True), (3, True), (3, False)])
def test_fc_quadratic_q_function_matches_jax_from_converted_params(d, scale_mu):
    jnet, params, tnet = _naf_pair(d, scale_mu)
    assert tnet.mlp.layers[-1].out_features == 1 + 2 * d + d * (d - 1) // 2
    rs = np.random.RandomState(d)
    x = rs.normal(size=(12, 5)).astype(np.float32)
    a = rs.uniform(-2.0, 2.5, (12, d)).astype(np.float32)
    tav, jav = tnet(_t(x)), jnet.apply(params, jnp.asarray(x))
    for name, got, want in (("mu", tav.mu, jav.mu), ("mat", tav.mat, jav.mat), ("v", tav.v, jav.v),
                            ("greedy", tav.greedy_actions(), jav.greedy_actions()), ("max", tav.max(), jav.max()),
                            ("evaluate", tav.evaluate_actions(_t(a)), jav.evaluate_actions(jnp.asarray(a)))):
        got, want = got.detach().numpy(), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * max(1.0, float(np.abs(want).max())), err_msg=name)
    np.testing.assert_array_equal(tav.min_action.numpy(), np.asarray(jav.min_action))
    np.testing.assert_array_equal(tav.max_action.numpy(), np.asarray(jav.max_action))


def _naf_batch(seed, b=32, obs=3):
    rs = np.random.RandomState(seed)
    arrays = dict(
        obs=rs.normal(size=(b, obs)).astype(np.float32), action=rs.uniform(-2, 2, (b, 1)).astype(np.float32),
        reward=rs.normal(size=b).astype(np.float32), next_obs=rs.normal(size=(b, obs)).astype(np.float32),
        discount=np.full(b, 0.99, np.float32), is_terminal=rs.uniform(size=b) < 0.1,
        weight=np.ones(b, np.float32), indices=np.arange(b, dtype=np.int32))
    return (TransitionBatch(**{k: _t(v) for k, v in arrays.items()}),
            JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}, extras=FrozenDict()))


def test_naf_core_updates_match_jax():
    """``train_dqn_gym.py``'s NAF core (the recipe's ``make_core`` for
    Pendulum's bounds at width 16): one and three Adam steps."""
    space = spaces.box(-2.0, 2.0, (1,))
    tcore = dqn_gym.make_core(3, space, n_hidden_channels=16)
    assert isinstance(tcore.model, FCQuadraticStateQFunction) and tcore.explorer.scale == 0.3
    jcore = JaxDQNCore(model=jq.FCQuadraticStateQFunction(
        n_input_channels=3, n_dim_action=1, n_hidden_channels=16, n_hidden_layers=2, action_space_low=(-2.0,),
        action_space_high=(2.0,)), optimizer=optax.adam(1e-3), explorer=jexplorers.AdditiveGaussian(0.3, -2.0, 2.0),
        gamma=0.99)
    jstate = jcore.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)))
    tstate = convert.state_from_flax(tcore, np_tree(jstate), device="cpu")
    update = jax.jit(jcore.update)
    for i in range(3):
        tb, jb = _naf_batch(i)
        tstate, taux = tcore.update(tstate, tb)
        jstate, jaux = update(jstate, jnp.zeros((2,), jnp.uint32), jb)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-6)
        np.testing.assert_allclose(taux["errors"].numpy(), np.asarray(jaux["errors"]), rtol=1e-5, atol=1e-6)
        atol = 1e-6 if i == 0 else 3e-6
        for module, tree in ((tstate.model, jstate.params), (tstate.target_model, jstate.target_params)):
            for name, want in convert.torch_arrays(module, np_tree(tree)).items():
                got = dict(module.named_parameters())[name].detach().numpy()
                np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"update {i + 1} {name}")
    assert tstate.n_updates == int(jstate.n_updates) == 3


# --------------------------------------------------- the device recipe
LANES, BATCH, START, CAPACITY, SYNC_EVERY, LIMIT, STEPS = 4, 16, 32, 96, 48, 10, 30


def _run_jax_runner(monkeypatch, env_name, jenv, jcore, train, draws):
    """``OffPolicyRunner._one_step``'s order over the JAX package's own
    vector env, ring and DQN core, on the port's logged draws."""
    real_split = jax.random.split
    ValueKeys(monkeypatch)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, minval, maxval, dtype=jnp.int32: key.astype(dtype))
    # A real key (the update's, whose forwards draw no noise) splits for real.
    monkeypatch.setattr(jax.random, "split", lambda key, num=2: real_split(key, num) if key.dtype == jnp.uint32
                        else ValueKeys.split(key, num))
    if env_name == "pendulum":
        reset_keys = lambda: pendulum_keys(draws, LANES)  # noqa: E731
    else:
        reset_keys = lambda: jnp.asarray(draws.take("uniform")[0])  # noqa: E731
    jvec = VectorJaxEnv(jenv, LANES)
    buf = JaxReplay(CAPACITY, gamma=0.99, num_lanes=LANES)
    def select_action(state, eps, obs, t):
        """``DQNCore.select_action`` with the explorer's key the logged normals."""
        av = jcore.action_value(state.params, jax.random.PRNGKey(0), obs)
        return jcore.explorer.select_action(eps, t, av.greedy_actions(), av)

    select = jax.jit(select_action)
    update, sync = jax.jit(jcore.update), jax.jit(jcore.sync_target)
    vstep, add = jax.jit(jvec.step), jax.jit(buf.add)
    sample_indices = jax.jit(buf.sample_indices, static_argnums=2)
    gather = jax.jit(buf.gather)
    env_states, obs = jvec.reset(reset_keys())
    replay = buf.init(JaxTransition(obs=obs[0], action=jnp.zeros((1,)), reward=jnp.zeros(()), next_obs=obs[0],
                                    terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict()))
    t, metrics = 0, {"loss": [], "done_count": []}
    for _ in range(STEPS):
        (eps,) = draws.take("normal")
        actions = select(train, jnp.asarray(eps.reshape(LANES, 1)), obs, jnp.int32(t))
        env_states, vec = vstep(step_keys(reset_keys()), env_states, actions)
        ts = vec.ts
        replay = add(replay, JaxTransition(obs=obs, action=actions, reward=ts.reward, next_obs=ts.obs,
                                           terminated=ts.terminated, done=ts.done, extras=FrozenDict()))
        t_prev, t = t, t + LANES
        loss = 0.0
        if t >= START:
            (id_values,) = draws.take("randint_below")
            ids = sample_indices(replay, jnp.asarray(id_values), 2 * BATCH)
            for row in ids.reshape(2, BATCH):
                train, aux = update(train, jnp.zeros((2,), jnp.uint32), gather(replay, row))
                loss = float(aux["loss"])
        if t // SYNC_EVERY != t_prev // SYNC_EVERY:
            train = sync(train)
        metrics["loss"].append(loss)
        metrics["done_count"].append(int(np.asarray(ts.done).sum()))
        obs = vec.obs
    assert not draws.log  # every draw the port made was replayed
    return t, replay, train, metrics


@pytest.mark.parametrize("env_name", ["pendulum", "mountaincar"])
def test_device_recipe_matches_the_jax_runner(monkeypatch, env_name):
    """``make_dqn_gym_runner`` at the script's widths (FC 2 x 100) with a
    small ring, 2 batch-16 updates per scan step from 32 transitions, a
    sync at 48 and episodes cut to 10 steps: 30 scan steps, 46 updates."""
    tenv = tenvs.TimeLimit(dqn_gym.ENVS[env_name]("cpu").env, LIMIT)
    jenv = jenvs.TimeLimit(jenvs.Pendulum() if env_name == "pendulum" else jenvs.MountainCarContinuous(), LIMIT)
    runner, _ = dqn_gym.make_dqn_gym_runner(env=tenv, capacity=CAPACITY, num_envs=LANES, replay_start_size=START,
                                            update_interval=2, target_update_interval=SYNC_EVERY,
                                            minibatch_size=BATCH)
    space = tenv.action_space
    jcore = JaxDQNCore(model=jq.FCQuadraticStateQFunction(
        n_input_channels=tenv.observation_space.shape[0], n_dim_action=1, n_hidden_channels=100, n_hidden_layers=2,
        action_space_low=tuple(map(float, space.low)), action_space_high=tuple(map(float, space.high))),
        optimizer=optax.adam(1e-3), explorer=jexplorers.AdditiveGaussian(0.3, float(space.low[0]),
                                                                            float(space.high[0])), gamma=0.99)
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, tenv.observation_space.shape[0])))
    draws = LoggedDraws(0)
    state = runner.init(0, draws=draws)
    state.train_state = convert.dqn_state_from_flax(runner.core, np_tree(jtrain.params), np_tree(jtrain.target_params),
                                                    np_tree(jtrain.opt_state), device="cpu")
    state, metrics = runner.run_chunk(state, STEPS)
    t, jring, jts, jmetrics = _run_jax_runner(monkeypatch, env_name, jenv, jcore, jtrain, draws)
    assert state.t == t == STEPS * LANES
    assert state.train_state.n_updates == int(jts.n_updates) == 46
    ring = state.replay_state
    for name in ("obs", "action", "reward", "next_obs"):
        np.testing.assert_allclose(ring.storage[name].numpy(), np.asarray(getattr(jring.storage, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("terminated", "done"):
        np.testing.assert_array_equal(ring.storage[name].numpy(), np.asarray(getattr(jring.storage, name)))
    assert (ring.storage["done"] & ~ring.storage["terminated"]).any()  # truncated by the time limit
    np.testing.assert_array_equal(metrics["done_count"].numpy(), jmetrics["done_count"])
    np.testing.assert_allclose(metrics["loss"].numpy(), jmetrics["loss"], rtol=1e-4, atol=1e-7)
    ts = state.train_state
    for module, tree in ((ts.model, jts.params), (ts.target_model, jts.target_params)):
        for name, want in convert.torch_arrays(module, np_tree(tree)).items():
            got = dict(module.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=f"{env_name} {name}")


def test_device_recipes_hold_the_scripts_settings():
    for name, make in dqn_gym.ENVS.items():
        runner, evaluator = dqn_gym.make_dqn_gym_runner(name, device="cpu")
        cfg = runner.config
        assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
                cfg.minibatch_size) == (32, 1024, 32, 2048, 64)
        assert runner.buffer.capacity == 10**5 and evaluator.max_steps == 500 and evaluator.env.num_envs == 10
        limit = runner.env.env.max_steps
        assert limit == (500 if name == "cartpole" else 200)
        model = runner.core.model
        assert isinstance(model, FCQuadraticStateQFunction) == (name != "cartpole")
        assert runner.core.optimizer.learning_rate == 1e-3 and runner.core.gamma == 0.99
    c51, _ = categorical_dqn_gym.make_c51_gym_runner(device="cpu")
    assert c51.core.model.n_atoms == 51 and float(c51.core.model.z_values[-1]) == 500.0
    assert c51.config.update_interval == 32 and c51.buffer.capacity == 10**5


# ----------------------------------------------------------- host modes
GYM_FLAGS = ["--steps", "100", "--replay-start-size", "64", "--minibatch-size", "16", "--target-update-interval",
             "50", "--eval-interval", "50", "--n-hidden-channels", "16"]


def _load_script(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples/gym", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _kept(run, monkeypatch, targets):
    store = {}
    for target in targets:
        for name in ("train_agent_with_evaluation", "train_agent_batch_with_evaluation"):
            if hasattr(target, name):
                monkeypatch.setattr(target, name, keep(store))
    with pytest.raises(Kept):
        run()
    return store


def _actions_within(tlog, jlog, nudged_logs):
    """Continuous actions within 1e-5, or 4x what the nudged runs move them."""
    assert len(tlog["actions"]) == len(jlog["actions"]) > 0
    for i, (got, want) in enumerate(zip(tlog["actions"], jlog["actions"])):
        nudge = max(float(np.abs(log["actions"][i] - want).max()) for log in nudged_logs)
        assert float(np.abs(got - want).max()) <= max(1e-5, 4 * nudge), i


@pytest.mark.parametrize("script", ["dqn", "c51"])
def test_host_mode_matches_the_scripts_shell(tmp_path, monkeypatch, script):
    """``run_gymnasium`` of both scripts on the real gymnasium env (NAF on
    ``Pendulum-v1``, 2 lanes through the batch driver; C51 on
    ``CartPole-v1`` through the serial one): the drivers' arguments, then
    the JAX script's shell and the port's from its converted state through
    the same driver on the same draws."""
    monkeypatch.chdir(tmp_path)
    if script == "dqn":
        module, port = _load_script("train_dqn_gym.py"), dqn_gym
        flags = ["--env", "Pendulum-v1", "--num-envs", "2"] + GYM_FLAGS
    else:
        module, port = _load_script("train_categorical_dqn_gym.py"), categorical_dqn_gym
        flags = ["--env", "CartPole-v1", "--steps", "100", "--replay-start-size", "64", "--minibatch-size", "16",
                 "--target-update-interval", "50", "--eval-interval", "50"]
    monkeypatch.setattr(sys, "argv", ["script"] + flags)
    jstore = _kept(module.main, monkeypatch, [jexperiments])
    tstore = _kept(lambda: port.run(flags, device="cpu"), monkeypatch, [port])
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    jagent, tagent = jstore.pop("agent"), tstore.pop("agent")
    jenv, tenv, jeval, teval = jstore.pop("env"), tstore.pop("env"), jstore.pop("eval_env"), tstore.pop("eval_env")
    assert tstore == jstore
    for attr in ("replay_start_size", "minibatch_size", "update_interval", "target_update_interval", "gamma"):
        assert getattr(tagent, attr) == getattr(jagent, attr), attr
    assert tagent.buffer.capacity == jagent.buffer.capacity == 10**5
    assert type(tagent.core).__name__ == type(jagent.core).__name__
    obs_size = teval.observation_space.shape[0]
    jagent._ensure_init(np.zeros((1, obs_size), np.float32))
    jstate = np_tree(jagent.train_state)
    batch = script == "dqn"
    kw = dict(steps=100, eval_n_steps=None, eval_n_episodes=2, eval_interval=50)

    def port_run(scale, outdir):
        tape, log = Tape(31), new_log()
        agent = _port_shell(script, port, flags, tape)
        scale_weights(convert.dqn_shell_from_flax(agent, jstate), scale)
        env, eval_env = _gym_envs(script, port, flags)
        (train_agent_batch_with_evaluation if batch else train_agent_with_evaluation)(
            record(agent, log), env, outdir=outdir, eval_env=eval_env, **kw)
        return agent, tape, log

    tagent, tape, tlog = port_run(1.0, str(tmp_path / "port"))
    nudged = [port_run(s, str(tmp_path / f"nudged{i}")) for i, s in enumerate(NUDGES)]
    jlog = new_log()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        driver = jexperiments.train_agent_batch_with_evaluation if batch else jexperiments.train_agent_with_evaluation
        driver(record(jagent, jlog), jenv, outdir=str(tmp_path / "jax"), eval_env=jeval, **kw)
        assert not tape.log
    if script == "dqn":
        _actions_within(tlog, jlog, [log for _, _, log in nudged])
    else:
        for got, want in zip(tlog["actions"], jlog["actions"]):
            np.testing.assert_array_equal(got, want)
    assert tlog["syncs"] == jlog["syncs"] >= 1
    assert tagent.t == jagent.t == 100 and tagent.optim_t == jagent.optim_t > 30
    if script == "dqn":  # continuous actions move the statistics as they move the actions
        for i, ((k, got), (_, want)) in enumerate(zip(tagent.get_statistics(), jagent.get_statistics())):
            nudge = max(abs(float(a.get_statistics()[i][1]) - float(want)) for a, _, _ in nudged)
            assert abs(float(got) - float(want)) <= max(1e-5 * abs(float(want)), 4 * nudge), k
    else:
        assert_stats_close(tagent.get_statistics(), jagent.get_statistics(), atol=1e-6)
    # NAF's target reaches its max through ``evaluate_actions`` of the clipped
    # tanh-scaled greedy action (v only up to rounding) and its loss through
    # exp and the quadratic's einsum: its first moments round apart by up to
    # 1e-5 of their scale over the run, as IQN's do (test_torch_host_value_shells).
    ts, js = tagent.train_state, jagent.train_state
    assert ts.n_updates == int(js.n_updates) == tagent.optim_t and ts.opt_state.count == int(js.opt_state[0].count)
    assert_within_nudges(_dqn_tensors(tagent), _jax_dqn_tensors(tagent, jagent),
                         [_dqn_tensors(a) for a, _, _ in nudged], f"{script}-gym",
                         mu_rel=1e-5 if script == "dqn" else 3e-6)


def _port_shell(script, port, flags, tape):
    args = port.parser().parse_args(flags)
    if script == "dqn":
        probe = dqn_gym.wrapped_env(dqn_gym._gymnasium_env(args.env), args.seed)
        return dqn_gym.make_agent(
            probe.observation_space.shape[0], probe.action_space, steps=args.steps, num_envs=args.num_envs,
            replay_start_size=args.replay_start_size, minibatch_size=args.minibatch_size,
            target_update_interval=args.target_update_interval, n_hidden_channels=args.n_hidden_channels,
            device="cpu", draws=tape)
    return categorical_dqn_gym.make_c51_agent(4, 2, args.steps, replay_start_size=args.replay_start_size,
                                              minibatch_size=args.minibatch_size,
                                              target_update_interval=args.target_update_interval, device="cpu",
                                              draws=tape)


def _gym_envs(script, port, flags):
    """The scripts' training and evaluation envs, as ``run_gymnasium`` builds them."""
    from pfrl_tpu_torch.envs import SerialVectorEnv
    from pfrl_tpu_torch.wrappers import CastObservationToFloat32

    args = port.parser().parse_args(flags)
    factory = dqn_gym._gymnasium_env(args.env)
    if script == "dqn":
        env = SerialVectorEnv([dqn_gym.wrapped_env(factory, args.seed * args.num_envs + i)
                               for i in range(args.num_envs)])
        return env, SerialVectorEnv([dqn_gym.wrapped_env(factory, args.seed + 100 + i) for i in range(10)])
    return CastObservationToFloat32(factory(args.seed)), CastObservationToFloat32(factory(args.seed + 100))


def test_host_modes_take_an_env_factory(tmp_path):
    """The card's machine has no gymnasium: ``env_factory`` stands in for
    ``make_gymnasium_env(--env)``, under the scripts' wrappers."""
    from pfrl_tpu_torch.envs import CartPole, HostTorchEnv, Pendulum, TimeLimit

    flags = ["--env", "X", "--steps", "70", "--replay-start-size", "64", "--eval-interval", "70"]
    agent, _ = dqn_gym.run(flags + ["--num-envs", "1", "--n-hidden-channels", "8", "--outdir", str(tmp_path / "a")],
                           device="cpu",
                           env_factory=lambda s: HostTorchEnv(TimeLimit(Pendulum(device="cpu"), 200), seed=s))
    assert agent.t == 70 and agent.optim_t == 7 and isinstance(agent.core.model, FCQuadraticStateQFunction)
    agent, _ = categorical_dqn_gym.run(
        flags + ["--outdir", str(tmp_path / "b")], device="cpu",
        env_factory=lambda s: HostTorchEnv(TimeLimit(CartPole(device="cpu"), 500), seed=s))
    assert agent.t == 70 and agent.optim_t == 7 and type(agent).__name__ == "CategoricalDQN"
