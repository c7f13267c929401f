"""The on-policy slice as a whole at a small size: PPO on MujocoSim, A2C on
the time-limited CartPole and TRPO on the time-limited Pendulum through the
port's ``OnPolicyRunner.run_iterations``, against the JAX package's own
``OnPolicyRunner.run_iterations`` over 3 iterations, and ``EvalLoop``
against ``JaxEvalLoop``.

The port draws from :class:`LoggedDraws`. The JAX runner threads one key
through a scan over iterations and a scan over collect steps; here that key
is a :class:`ScriptedKey`, a pytree that holds the port's logged draws as
tables and two counters. While :func:`install_scripted_keys` is in force,
``jax.random.split`` of a scripted key hands out the next collect step's act
draw and env key (``split(rng, 3)``) or the next iteration's update key
(``split(rng)``), and every other key *is* the array of values to draw
(``ValueKeys``; ``permutation`` and ``categorical`` by value too). The JAX
runner then runs jitted, scans and all, on the port's numbers, in the order
the port drew them: per collect step the act draw, then the env's resets;
per iteration the update's permutations.

Sizes: 4 lanes, hidden 16; PPO rollout 16 (64 transitions, 2 epochs of
batch 16), MujocoSim episodes cut to 12 steps; A2C rollout 8, CartPole cut
to 20 steps (lanes terminate and are truncated); TRPO rollout 16, Pendulum
cut to 10 steps, 2 value-function epochs of batch 16. ``EvalLoop`` against
the real ``JaxEvalLoop`` on a real key, handed the start states by value
(greedy actions draw nothing).

Tolerances: ``t``, counters, flags and the ring's count exact; observations
and returns 1e-4 relative + 1e-5; the update's metrics 1e-4 relative; PPO's
and A2C's parameters 2e-5 absolute; TRPO's policy 2e-4 absolute (each
step's CG direction differs by up to 2e-3 of the step, see
``test_torch_a2c_trpo.py``) and its value function 2e-5; evaluation returns
1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import struct
from test_torch_actor_critic_modules import np_tree
from test_torch_categorical import value_categorical
from test_torch_continuous_envs import LoggedDraws, ValueKeys, jax_mujoco_pair
from test_torch_ppo import JaxGaussianPi, JaxGaussianPiV, JaxSoftmaxPiV
from test_torch_sac import assert_network

from pfrl_tpu import envs as jenvs
from pfrl_tpu.agents.a2c import A2CCore as JaxA2CCore
from pfrl_tpu.agents.ppo import PPOCore as JaxPPOCore
from pfrl_tpu.agents.trpo import TRPOCore as JaxTRPOCore
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunner as JaxOnPolicyRunner
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunnerState as JaxRunnerState
from pfrl_tpu.models import MLP as JaxMLP
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.agents import A2CCore, PPOCore, TRPOCore
from pfrl_tpu_torch.experiments import onpolicy as onp
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.parallel.mesh import Mesh
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

LANES, HIDDEN, ITERATIONS = 4, 16, 3
MUJOCO_EPISODE, CARTPOLE_LIMIT, PENDULUM_LIMIT = 12, 20, 10


class PermutingDraws(LoggedDraws):
    def permutation(self, n):
        return self._record("permutation", self.rs.permutation(n)).to(torch.int64)


@struct.dataclass
class ScriptedKey:
    """The JAX runner's key: the port's draws as tables, and counters."""

    step: jax.Array       # collect steps taken, int32 0-d
    iteration: jax.Array  # iterations taken, int32 0-d
    act: jax.Array        # [steps, L, ...] each collect step's act draw
    env: jax.Array        # [steps, 2L, k] each collect step's env key
    update: jax.Array     # [iterations, ...] each update's key


def install_scripted_keys(monkeypatch):
    ValueKeys(monkeypatch)
    value_split = ValueKeys.split

    def split(key, num=2):
        if not isinstance(key, ScriptedKey):
            return value_split(key, num)
        if num == 3:  # (rng, rng_act, rng_env) of a collect step
            return key.replace(step=key.step + 1), key.act[key.step], key.env[key.step]
        assert num == 2, num  # (rng, rng_upd) of an iteration
        return key.replace(iteration=key.iteration + 1), key.update[key.iteration]

    monkeypatch.setattr(jax.random, "split", split)
    monkeypatch.setattr(jax.random, "permutation", lambda key, x, axis=0, independent=False: key)
    monkeypatch.setattr(jax.random, "categorical", value_categorical)


# ---------------------------------------------------------------- configs
def _setup(kind):
    """(JAX env, JAX core, port runner, converter, obs width, per-lane reset
    draws as (kind, width) pairs, the act draw's kind and width, update
    draws per iteration)."""
    if kind == "ppo":
        jenv, tenv = jax_mujoco_pair(episode_len=MUJOCO_EPISODE)
        kw = dict(epochs=2, minibatch_size=16, entropy_coef=0.0, standardize_advantages=True)
        jcore = JaxPPOCore(JaxGaussianPiV(act_dim=6), optax.adam(3e-4), **kw)
        runner = onp.make_ppo_runner(num_envs=LANES, rollout_len=16, epochs=2, minibatch_size=16, hidden=HIDDEN, env=tenv)
        return jenv, jcore, runner, convert.ppo_state_from_flax, 17, [("normal", 17)], ("normal", 6), 2
    if kind == "a2c":
        jenv = jenvs.TimeLimit(jenvs.CartPole(), CARTPOLE_LIMIT)
        tenv = tenvs.TimeLimit(tenvs.CartPole(device="cpu"), CARTPOLE_LIMIT)
        jcore = JaxA2CCore(JaxSoftmaxPiV(), optax.rmsprop(7e-4, decay=0.99, eps=1e-5), gamma=0.99,
                           entropy_coeff=0.01, v_loss_coef=0.5, max_grad_norm=40.0)
        runner = onp.make_a2c_cartpole_runner(num_envs=LANES, rollout_len=8, hidden=HIDDEN, env=tenv)
        return jenv, jcore, runner, convert.ppo_state_from_flax, 4, [("uniform", 4)], ("uniform", 2), 0
    jenv = jenvs.TimeLimit(jenvs.Pendulum(), PENDULUM_LIMIT)
    tenv = tenvs.TimeLimit(tenvs.Pendulum(device="cpu"), PENDULUM_LIMIT)
    jcore = JaxTRPOCore(policy=JaxGaussianPi(act_dim=1), vf=JaxMLP(out_size=1, hidden_sizes=(HIDDEN, HIDDEN)),
                        vf_optimizer=optax.adam(1e-3), gamma=0.99, lambd=0.95, max_kl=0.01, vf_epochs=2,
                        vf_batch_size=16, entropy_coef=0.0)
    runner = onp.make_trpo_pendulum_runner(num_envs=LANES, rollout_len=16, vf_epochs=2, vf_batch_size=16,
                                           hidden=HIDDEN, env=tenv)
    return jenv, jcore, runner, convert.trpo_state_from_flax, 3, [("uniform", 1), ("uniform", 1)], ("normal", 1), 2


def _reset_keys(draws, resets):
    """One reset of every lane, from the log, as per-lane keys ``[L, k]``."""
    parts = [draws.take(kind)[0].reshape(LANES, width) for kind, width in resets]
    return jnp.asarray(np.concatenate(parts, axis=1))


def _run_jax(monkeypatch, jenv, jcore, jtrain, draws, resets, act, n_update, rollout_len):
    """The JAX runner's ``run_iterations`` on the port's logged draws."""
    install_scripted_keys(monkeypatch)
    jrunner = JaxOnPolicyRunner(jenv, jcore, LANES, rollout_len)
    env_states, obs = VectorJaxEnv(jenv, LANES).reset(_reset_keys(draws, resets))
    acts, envs, updates = [], [], []
    for _ in range(ITERATIONS):
        for _ in range(rollout_len):
            acts.append(draws.take(act[0])[0].reshape(LANES, act[1]))
            reset = np.asarray(_reset_keys(draws, resets))
            envs.append(np.concatenate([np.zeros_like(reset), reset]))
        updates.append(np.stack(draws.take(*["permutation"] * n_update)).astype(np.int32) if n_update else np.zeros(1))
    assert not draws.log  # every draw the port made is scripted
    key = ScriptedKey(step=jnp.int32(0), iteration=jnp.int32(0), act=jnp.asarray(np.stack(acts)),
                      env=jnp.asarray(np.stack(envs)), update=jnp.asarray(np.stack(updates)))
    state = JaxRunnerState(
        env_states=env_states, obs=obs, train_state=jtrain, rng=key, t=jnp.int32(0),
        episode_return=jnp.zeros(LANES), recent_returns=jnp.zeros(jrunner.return_window),
        recent_count=jnp.int32(0),
    )
    state = jax.tree.map(lambda x: jnp.array(x, copy=True), state)  # no aliased buffers to donate (see runner.init)
    state, aux = jrunner.run_iterations(state, ITERATIONS)
    assert int(state.rng.step) == ITERATIONS * rollout_len and int(state.rng.iteration) == ITERATIONS
    return jrunner, state, aux


@pytest.fixture(scope="module")
def trained():
    out = {}
    for kind in ("ppo", "a2c", "trpo"):
        with pytest.MonkeyPatch.context() as monkeypatch:
            jenv, jcore, runner, from_flax, obs_dim, resets, act, n_update = _setup(kind)
            jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, obs_dim)))
            draws = PermutingDraws(0)
            state = runner.init(0, draws=draws)
            state.train_state = from_flax(runner.core, np_tree(jtrain), device="cpu")
            state, aux = runner.run_iterations(state, ITERATIONS)
            kinds = [k for k, _ in draws.log]
            jax_run = _run_jax(monkeypatch, jenv, jcore, jtrain, draws, resets, act, n_update, runner.rollout_len)
        out[kind] = dict(runner=runner, state=state, aux=aux, kinds=kinds, jax=jax_run, jenv=jenv, jcore=jcore,
                         resets=resets)
    return out


@pytest.mark.parametrize("kind", ["ppo", "a2c", "trpo"])
def test_runner_matches_the_jax_runner_over_three_iterations(trained, kind):
    run = trained[kind]
    runner, state, aux = run["runner"], run["state"], run["aux"]
    jrunner, jstate, jaux = run["jax"]
    T = runner.rollout_len
    assert state.t == int(jstate.t) == ITERATIONS * T * LANES
    per_step = 1 + len(run["resets"])
    assert len(run["kinds"]) == len(run["resets"]) + ITERATIONS * (T * per_step + (0 if kind == "a2c" else 2))
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), rtol=1e-4, atol=1e-5)
    # The ring of finished returns and its count.
    count = int(state.recent_count)
    assert count == int(jstate.recent_count) > 0
    np.testing.assert_allclose(state.recent_returns.numpy(), np.asarray(jstate.recent_returns), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.episode_return.numpy(), np.asarray(jstate.episode_return), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(runner.recent_return_mean(state), jrunner.recent_return_mean(jstate), rtol=1e-4)
    # The update's metrics, one row per iteration.
    assert set(aux) == set(jaux)
    for name, got in aux.items():
        want = np.asarray(jaux[name])
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6, err_msg=name)
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates)
    if kind == "trpo":
        assert_network(ts.policy, jts.policy_params, 2e-4, "trpo policy")
        assert_network(ts.vf, jts.vf_params, 2e-5, "trpo vf")
        assert ts.vf_opt_state.count == int(jts.vf_opt_state[0].count) == ITERATIONS * 2 * 4
        assert aux["step_accepted"].tolist() == [1.0] * ITERATIONS
    else:
        assert_network(ts.model, jts.params, 2e-5, kind)
    assert isinstance(runner.core, {"ppo": PPOCore, "a2c": A2CCore, "trpo": TRPOCore}[kind])


def test_the_rollout_is_time_major_and_holds_the_last_iteration(trained):
    """The preallocated ``[T, L, ...]`` tensors after the last iteration:
    ``next_obs`` equals the next step's ``obs`` except where the lane's
    episode ended (there it is the pre-reset observation), and lanes were
    both truncated and terminated over the A2C run."""
    for kind in ("ppo", "a2c", "trpo"):
        r = trained[kind]["state"].rollout
        T = trained[kind]["runner"].rollout_len
        assert r.obs.shape[:2] == r.action.shape[:2] == r.reward.shape == r.done.shape == (T, LANES)
        same = (r.next_obs[:-1] == r.obs[1:]).all(-1)
        assert torch.equal(same, ~r.done[:-1])
        assert not (r.terminated & ~r.done).any()
    a2c = trained["a2c"]["state"].rollout
    assert a2c.action.dtype == torch.int64 and a2c.action.shape == (8, LANES)


@pytest.mark.parametrize("kind", ["ppo", "a2c", "trpo"])
def test_eval_loop_matches_jax_eval_loop(trained, kind):
    """The real ``JaxEvalLoop`` on a real key, and the port's ``EvalLoop``
    on the same cores, unchanged, handed the same start states."""
    run = trained[kind]
    lanes, episode = 5, {"ppo": MUJOCO_EPISODE, "a2c": CARTPOLE_LIMIT, "trpo": PENDULUM_LIMIT}[kind]
    max_steps = episode + 3
    _, jstate, _ = run["jax"]
    key = jax.random.PRNGKey(7)
    want = JaxEvalLoop(run["jenv"], run["jcore"], lanes, max_steps).evaluate(jstate.train_state, key)

    lane_keys = jax.random.split(jax.random.split(key)[1], lanes)
    if kind == "trpo":
        halves = [jax.random.split(k) for k in lane_keys]
        first = [np.array([float(jax.random.uniform(h[i], ())) for h in halves], np.float32) for i in (0, 1)]
    elif kind == "a2c":
        first = [np.concatenate([np.asarray(jax.random.uniform(k, (4,))) for k in lane_keys])]
    else:
        first = [np.concatenate([np.asarray(jax.random.normal(k, (17,))) for k in lane_keys])]
    rs = np.random.RandomState(0)

    class StartStates:
        def uniform(self, n):
            return torch.from_numpy(first.pop(0).copy() if first else rs.uniform(size=n).astype(np.float32))

        def normal(self, n):
            return torch.from_numpy(first.pop(0).copy() if first else rs.standard_normal(n).astype(np.float32))

    runner = run["runner"]
    got = EvalLoop(runner.env.env, runner.core, lanes, max_steps, device="cpu").evaluate(
        run["state"].train_state, StartStates()
    )
    assert got.shape == want.shape == (lanes,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_recipes_hold_the_published_widths_and_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = (onp.make_ppo_runner, onp.make_ppo_pendulum_runner, onp.make_trpo_pendulum_runner,
              onp.make_a2c_cartpole_runner)
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    ppo, ppo_p, trpo, a2c = (make(device="cpu") for make in makers)
    for runner, lanes, length in ((ppo, 8, 256), (ppo_p, 16, 128), (trpo, 16, 128), (a2c, 32, 8)):
        assert (runner.num_envs, runner.rollout_len, runner.device) == (lanes, length, torch.device("cpu"))
    assert isinstance(ppo.env.env, tenvs.MujocoSim) and ppo.env.env.episode_len == 1_000
    for runner in (ppo, ppo_p):
        core = runner.core
        assert (core.epochs, core.minibatch_size, core.entropy_coef, core.standardize_advantages) == (10, 64, 0.0, True)
        assert (core.gamma, core.lambd, core.clip_eps, core.clip_eps_vf, core.value_func_coef) == (0.99, 0.95, 0.2, None, 1.0)
        assert core.optimizer.learning_rate == 3e-4 and core.minibatch_shape(runner.num_envs * runner.rollout_len)[0] == 32
    act = (6, 1)
    for runner, a in zip((ppo, ppo_p), act):
        model = runner.core.model
        obs = 17 if a == 6 else 3
        assert [tuple(layer.weight.shape) for layer in model.pi] == [(64, obs), (64, 64), (a, 64)]
        assert [tuple(layer.weight.shape) for layer in model.v] == [(64, obs), (64, 64), (1, 64)]
        assert model.head.log_std.shape == (1,)
    assert ppo.core.model.pi[2].scale is None and ppo_p.core.model.pi[2].scale == 1e-4
    for runner, limit in ((ppo_p, 200), (trpo, 200), (a2c, 500)):
        assert isinstance(runner.env.env, tenvs.TimeLimit) and runner.env.env.max_steps == limit
    core = trpo.core
    assert (core.max_kl, core.vf_epochs, core.vf_batch_size, core.cg_max_iter, core.cg_damping, core.max_backtrack) == (
        0.01, 5, 64, 10, 0.1, 10)
    assert core.vf_optimizer.learning_rate == 1e-3 and core.standardize_advantages
    assert [tuple(layer.weight.shape) for layer in core.vf.layers] == [(64, 3), (64, 64), (1, 64)]
    core = a2c.core
    assert (core.gamma, core.entropy_coef, core.value_func_coef, core.use_gae) == (0.99, 0.01, 0.5, False)
    opt = core.optimizer
    assert opt.max_norm == 40.0 and (opt.inner.learning_rate, opt.inner.decay, opt.inner.eps) == (7e-4, 0.99, 1e-5)
    assert [tuple(layer.weight.shape) for layer in core.model.trunk] == [(64, 4), (64, 64)]
    assert [tuple(layer.weight.shape) for layer in core.model.out] == [(2, 64), (1, 64)]


def _trpo_runs_on_one_rank():
    """TRPO on Pendulum, 4 lanes, two iterations of 32 transitions, without a
    mesh and on a mesh of one Gloo rank."""
    import socket

    from pfrl_tpu_torch.parallel.mesh import make_mesh
    from pfrl_tpu_torch.parallel.multihost import initialize_multihost, shutdown

    def run(mesh):
        env = tenvs.TimeLimit(tenvs.Pendulum(device="cpu"), PENDULUM_LIMIT)
        recipe = onp.make_trpo_pendulum_runner(num_envs=4, rollout_len=8, vf_epochs=1, vf_batch_size=8,
                                               hidden=HIDDEN, env=env)
        runner = OnPolicyRunner(env, recipe.core, 4, 8, device="cpu", mesh=mesh)
        state = runner.init(0, draws=Draws(torch.Generator().manual_seed(0)))
        state, aux = runner.run_iterations(state, 2)
        return state.train_state, aux

    plain, plain_aux = run(None)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"localhost:{port}", 1, 0, device="cpu", timeout_s=60)
    try:
        meshed, aux = run(make_mesh(("dp",)))
    finally:
        shutdown()
    assert plain.n_updates == meshed.n_updates > 0
    for module in ("policy", "vf"):
        for (name, a), b in zip(getattr(plain, module).named_parameters(), getattr(meshed, module).parameters()):
            assert torch.equal(a, b), name
    for key, value in plain_aux.items():
        assert torch.equal(value, aux[key]), key


def test_unported_branches_raise_by_name():
    env = tenvs.CartPole(device="cpu")
    core = onp.make_a2c_cartpole_runner(device="cpu").core
    # The mesh branch is ported: the runner takes a mesh over one rank with
    # a core that splits its minibatches, and TRPO, which does not split:
    # every rank runs its whole update; on a mesh of one Gloo rank its run
    # equals the run without one to the bit.
    mesh = Mesh(("dp",), (1,), 0)
    runner = OnPolicyRunner(env, core, 4, 8, device="cpu", mesh=mesh)
    assert runner.mesh is mesh and runner.env.num_envs == 4 and runner.core.mesh is mesh
    trpo = onp.make_trpo_pendulum_runner(device="cpu", num_envs=4, rollout_len=8, vf_epochs=1, vf_batch_size=8,
                                         hidden=HIDDEN).core
    runner = OnPolicyRunner(env, trpo, 4, 8, device="cpu", mesh=mesh)
    assert runner.mesh is mesh and runner.core is trpo and not runner.splits
    _trpo_runs_on_one_rank()

    class Recurrent:
        recurrent = True

    # The recurrent branch is ported: the runner takes a recurrent core.
    assert OnPolicyRunner(env, Recurrent(), 4, 8, device="cpu").recurrent
