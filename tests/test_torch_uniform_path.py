"""The uniform-replay path of the port against the JAX package: the ring's
``sample_indices`` and ``sample``, and the runner's presample branch
(Nature DQN and Double DQN over a uniform ring) against a loop over the JAX
package's own module functions fed the very same draws.

The port's runner draws from ``KeyedDraws`` (``test_torch_slice.py``),
which logs each draw with the JAX key it came from; the JAX side replays
the log: the explorer's and the env's draws as values, the minibatch ids by
handing ``sample_indices`` the same key, for which JAX draws the very same
integers. One id draw serves all the updates of a scan step.

Tolerances: ids, the env, the ring and the step counter are exact;
parameters and losses go through the network's convolutions, which reduce
in another order in the two libraries: ``rtol 1e-5`` (floor ``1e-6``) for
parameters, ``rtol 1e-4`` for losses, accumulated over the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_replay import OBS, _assert_batches_equal, _fill, _steps
from test_torch_slice import JaxNatureQ, KeyedDraws, _jax_reset_states, _np_tree

from pfrl_tpu.agents import DQNCore as JaxDQNCore
from pfrl_tpu.agents.double_dqn import DoubleDQNCore as JaxDoubleDQNCore
from pfrl_tpu.envs import AtariSim as JaxAtariSim
from pfrl_tpu.explorers import LinearDecayEpsilonGreedy as JaxLinearDecay
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.utils import atari_phi as jax_atari_phi
from pfrl_tpu.utils.pytree import tree_where
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import DoubleDQNCore, DQNCore
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ, make_dqn_runner
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import RMSprop
from pfrl_tpu_torch.parallel.lane_sharding import LaneShardedBuffer, LaneShardedEpisodicBuffer
from pfrl_tpu_torch.parallel.mesh import Mesh
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer
from pfrl_tpu_torch.utils import atari_phi
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

N_ACTIONS, LANES, BATCH = 6, 4, 8
CAPACITY = 48      # the ring wraps inside the run
MEAN_EP_LEN = 5
# 68 transitions: updates from 32, one target sync at 48. No longer: a 1e-7
# change of the port's own initial parameters moves the DQN case's losses by
# 1e-3 from the 18th step on (the target's max switches between actions).
STEPS = 17
UPDATES_PER_STEP = 2  # update_interval 2 with 4 lanes


# ------------------------------------------------------------------ the ring
@pytest.mark.parametrize("num_steps,store_next_obs", [(1, True), (1, False), (3, False)])
@pytest.mark.parametrize("n_added", [2, 5, 13])  # nearly empty, partly filled, wrapped
def test_sample_indices_match_jax_in_range_and_dtype(num_steps, store_next_obs, n_added):
    lanes, cap = 3, 24
    kw = dict(num_steps=num_steps, gamma=0.9, num_lanes=lanes, store_next_obs=store_next_obs)
    jbuf, tbuf = JaxReplay(cap, **kw), ReplayBuffer(cap, device="cpu", **kw)
    js, ts = _fill(jbuf, tbuf, _steps(n_added, lanes, n_added))
    lo, hi = (int(x) for x in tbuf._sampleable_range(ts))

    draws = KeyedDraws(n_added)
    got = tbuf.sample_indices(ts, draws, 64)
    (key, _), = draws.log
    assert draws.kinds == ["randint_below"]
    assert got.dtype == torch.int32 and got.shape == (64,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbuf.sample_indices(js, key, 64)))
    if hi > lo:
        assert lo <= int(got.min()) and int(got.max()) < hi
    else:  # nothing sampleable yet: the bound is clamped to 1
        assert (got == lo).all()

    # The port's own source keeps the range and the dtype.
    own = tbuf.sample_indices(ts, Draws(torch.Generator().manual_seed(0)), 256)
    assert own.dtype == torch.int32
    assert lo <= int(own.min()) and int(own.max()) < max(hi, lo + 1)
    if hi - lo > 1:
        assert len(torch.unique(own)) > 1


def test_sample_is_gather_of_sample_indices_and_matches_jax():
    lanes, cap = 3, 24
    kw = dict(num_steps=3, gamma=0.9, num_lanes=lanes, store_next_obs=False, fused_dequant_scale=1.0 / 255.0)
    jbuf, tbuf = JaxReplay(cap, **kw), ReplayBuffer(cap, device="cpu", **kw)
    js, ts = _fill(jbuf, tbuf, _steps(7, lanes, 13))
    seeded = lambda: Draws(torch.Generator().manual_seed(5))  # noqa: E731
    batch = tbuf.sample(ts, seeded(), 16)
    ids = tbuf.sample_indices(ts, seeded(), 16)
    again = tbuf.gather(ts, ids)
    assert torch.equal(batch.indices, ids)
    for name in ("obs", "action", "reward", "next_obs", "discount", "is_terminal", "weight"):
        assert torch.equal(getattr(batch, name), getattr(again, name)), name
    assert batch.obs.shape == (16, *OBS) and (batch.weight == 1).all()

    draws = KeyedDraws(1)
    tb = tbuf.sample(ts, draws, 16)
    jb = jbuf.sample(js, draws.log[0][0], 16)
    np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
    _assert_batches_equal(tb, jb)
    assert tbuf.update_priorities(ts, ids, torch.ones(16)) is ts  # a no-op


def test_only_the_uniform_ring_draws_iid_samples():
    assert ReplayBuffer.iid_samples is True
    assert PrioritizedReplayBuffer.iid_samples is False
    assert JaxReplay.iid_samples is True


# ---------------------------------------------------------------- the runner
def _port_runner(double):
    core = (DoubleDQNCore if double else DQNCore)(
        model=NatureQ(N_ACTIONS),
        optimizer=RMSprop(2.5e-4, decay=0.95, eps=1e-2),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.1, 100, N_ACTIONS),
        gamma=0.99,
        batch_accumulator="sum",
        phi=atari_phi,
    )
    buffer = ReplayBuffer(
        CAPACITY, gamma=0.99, num_lanes=LANES, store_next_obs=False,
        fused_dequant_scale=1.0 / 255.0, device="cpu",
    )
    config = RunnerConfig(
        num_envs=LANES, replay_start_size=32, update_interval=2,
        target_update_interval=48, minibatch_size=BATCH,
    )
    env = AtariSim(N_ACTIONS, MEAN_EP_LEN, device="cpu")
    return OffPolicyRunner(env, core, buffer, config, device="cpu")


def _run_jax(log, params, double):
    """The uniform scan step over the JAX package's module functions: one
    ``sample_indices`` of U * B ids, reshaped, a row gather per update."""
    jenv = JaxAtariSim(N_ACTIONS, MEAN_EP_LEN)
    explorer = JaxLinearDecay(1.0, 0.1, 100, N_ACTIONS)
    core = (JaxDoubleDQNCore if double else JaxDQNCore)(
        model=JaxNatureQ(), optimizer=optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2),
        explorer=explorer, gamma=0.99, batch_accumulator="sum", phi=jax_atari_phi,
    )
    buf = JaxReplay(
        CAPACITY, gamma=0.99, num_lanes=LANES, store_next_obs=False, fused_dequant_scale=1.0 / 255.0,
    )
    assert buf.iid_samples
    add = jax.jit(buf.add, donate_argnums=0)
    sample_indices = jax.jit(buf.sample_indices, static_argnums=2)
    gather = jax.jit(buf.gather)
    update = jax.jit(core.update)
    greedy_of = jax.jit(lambda p, o: core.action_value(p, jax.random.PRNGKey(0), o).greedy_actions())
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0)))
    vobs = jax.jit(jax.vmap(jenv._obs))

    log = list(log)
    pop = lambda: log.pop(0)  # noqa: E731
    (_, seeds), (_, u) = pop(), pop()
    env_states = _jax_reset_states(seeds, u)
    obs = vobs(env_states)
    train = core.init(jax.random.PRNGKey(0), obs).replace(params=params, target_params=params)
    example = JaxTransition(
        obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()), next_obs=obs[0],
        terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict(),
    )
    replay = buf.init(example)
    t, losses, syncs, all_ids = 0, [], 0, []
    for _ in range(STEPS):
        greedy = greedy_of(train.params, obs)
        (_, u), (_, random_actions) = pop(), pop()
        actions = jnp.where(jnp.asarray(u) < explorer.epsilon_at(jnp.int32(t)), random_actions, greedy)
        new, ts = vstep(None, env_states, actions)
        (_, seeds), (_, u) = pop(), pop()
        reset = _jax_reset_states(seeds, u)
        env_states = tree_where(ts.done, reset, new)
        next_obs = tree_where(ts.done, vobs(reset), ts.obs)
        replay = add(replay, JaxTransition(
            obs=obs, action=actions, reward=ts.reward, next_obs=ts.obs,
            terminated=ts.terminated, done=ts.done, extras=FrozenDict(),
        ))
        t_prev, t = t, t + LANES
        loss = 0.0
        if t >= 32:
            key, logged_ids = pop()
            ids = sample_indices(replay, key, UPDATES_PER_STEP * BATCH)
            # The bound was a tensor on the port's side: the integers agree.
            lo, _ = buf._sampleable_range(replay)
            np.testing.assert_array_equal(np.asarray(ids), logged_ids + int(lo))
            all_ids.append(np.asarray(ids))
            for row in ids.reshape(UPDATES_PER_STEP, BATCH):
                train, aux = update(train, key, gather(replay, row))
                loss = float(aux["loss"])
        losses.append(loss)
        if t // 48 != t_prev // 48:
            train, syncs = core.sync_target(train), syncs + 1
        obs = next_obs
    assert not log  # every draw the port made was replayed
    return t, replay, train, np.asarray(losses, np.float32), syncs, all_ids


@pytest.mark.parametrize("double", [False, True], ids=["dqn", "double_dqn"])
def test_presample_branch_matches_jax_module_loop(double):
    runner = _port_runner(double)
    assert runner.buffer.iid_samples and runner.config.updates_per_step == UPDATES_PER_STEP
    draws = KeyedDraws(0)
    state = runner.init(0, draws=draws)
    flax_params = _np_tree(JaxNatureQ().init(jax.random.PRNGKey(1), jnp.zeros((1, 84, 84, 4))))
    fresh = _np_tree(optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2).init(flax_params))
    state.train_state = convert.dqn_state_from_flax(runner.core, flax_params, flax_params, fresh, device="cpu")

    state, metrics = runner.run_chunk(state, STEPS)
    t, replay, train, losses, syncs, all_ids = _run_jax(draws.log, flax_params, double)

    # One id draw of U * B per scan step from replay start on, none before.
    update_steps = sum(1 for k in range(1, STEPS + 1) if k * LANES >= 32)
    id_draws = [v for (_, v), kind in zip(draws.log, draws.kinds) if kind == "randint_below"]
    assert len(id_draws) == len(all_ids) == update_steps == 10
    assert all(v.shape == (UPDATES_PER_STEP * BATCH,) for v in id_draws)
    assert int(np.min(all_ids[-1])) >= STEPS * LANES - CAPACITY  # the ring wrapped: lo > 0

    assert state.t == t == STEPS * LANES
    assert int(state.replay_state.cursor) == int(replay.cursor) == STEPS * LANES
    assert state.train_state.n_updates == int(train.n_updates) == update_steps * UPDATES_PER_STEP
    assert syncs == 1
    for name, s in state.replay_state.storage.items():
        np.testing.assert_array_equal(s.numpy(), np.asarray(getattr(replay.storage, name)), err_msg=name)
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, rtol=1e-4, atol=1e-6)
    for module, tree in ((state.train_state.model, train.params), (state.train_state.target_model, train.target_params)):
        for name, want in convert.torch_arrays(module, _np_tree(tree)).items():
            got = dict(module.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


# -------------------------------------------------------------- entry points
def test_uniform_and_double_runners_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"double": True}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_dqn_runner(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EvalLoop(AtariSim(N_ACTIONS, device="cpu"), None, 2, 3)
    small = dict(num_envs=4, capacity=16, replay_start_size=4, minibatch_size=2, device="cpu")
    runner = make_dqn_runner(double=True, **small)
    assert isinstance(runner.core, DoubleDQNCore) and type(runner.buffer) is ReplayBuffer
    assert runner.device == torch.device("cpu")
    runner = make_dqn_runner(prioritized=True, **small)
    assert type(runner.core) is DQNCore and isinstance(runner.buffer, PrioritizedReplayBuffer)


class _Episodic(EpisodicReplayBuffer):
    def __init__(self, max_episodes, num_lanes, device):
        super().__init__(max_episodes, 8, num_lanes, device=device)

    def sample_episodes(self, state, draws, n):
        raise AssertionError("not reached")


class _Recurrent:
    def select_action_recurrent(self, *args):
        raise AssertionError("not reached")


class _Extras:
    def select_action_with_extras(self, *args):
        raise AssertionError("not reached")


class _Plain:
    batch_accumulator = "mean"

    def update(self, *args):
        raise AssertionError("not reached")

    def update_episodic(self, *args):
        raise AssertionError("not reached")


ONE_RANK = Mesh(("dp",), (1,), 0)


@pytest.mark.parametrize(
    "branch,core,buffer_cls,mesh",
    [
        ("mesh", _Plain(), ReplayBuffer, ONE_RANK),
        ("episodic", None, _Episodic, None),
        ("recurrent", _Recurrent(), ReplayBuffer, None),
        ("extras", _Extras(), ReplayBuffer, None),
        ("episodic buffers under a mesh", _Plain(), _Episodic, ONE_RANK),
        ("a noisy network under a mesh", "noisy", ReplayBuffer, ONE_RANK),
    ],
)
def test_runner_names_the_branch_it_has_not_ported(branch, core, buffer_cls, mesh):
    """The mesh, episodic, recurrent and extras branches are ported, and the
    runner takes them (a mesh: each rank's lanes, the buffer's rows
    sharded, the core's optimizers all-reducing); the episodic buffers and
    a noisy network run under a mesh too: a noisy network's run on a mesh
    of one Gloo rank equals its run without one to the bit."""
    env = AtariSim(N_ACTIONS, device="cpu")
    buffer = buffer_cls(64, num_lanes=4, device="cpu")
    if core == "noisy":
        _noisy_runs_on_one_rank(env)
        return
    runner = OffPolicyRunner(env, core, buffer, RunnerConfig(num_envs=4), device="cpu", mesh=mesh)
    assert runner.recurrent == (branch == "recurrent")
    assert runner.acts_with_extras == (branch == "extras")
    assert runner.mesh is mesh
    if branch == "mesh":
        assert isinstance(runner.buffer, LaneShardedBuffer) and runner.buffer.buffer is buffer
        assert runner.env.num_envs == 4 and runner.core.mesh is mesh and runner.core is not core
    if branch == "episodic buffers under a mesh":
        assert isinstance(runner.buffer, LaneShardedEpisodicBuffer) and runner.buffer.buffer is buffer
        assert runner.buffer.storage_rows == 64 and runner.core.mesh is mesh


def _noisy_runs_on_one_rank(env):
    """Noisy-net DQN on AtariSim over a ring of 64 slots: 6 scan steps (the
    last 3 updating) without a mesh and on one Gloo rank."""
    import socket

    from pfrl_tpu_torch.parallel.mesh import make_mesh
    from pfrl_tpu_torch.parallel.multihost import initialize_multihost, shutdown

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def run(mesh):
        recipe = make_dqn_runner(noisy_net_sigma=0.5, device="cpu", num_envs=4, capacity=64, replay_start_size=12,
                                 minibatch_size=4)
        runner = OffPolicyRunner(env, recipe.core, recipe.buffer, recipe.config, device="cpu", mesh=mesh)
        state = runner.init(0, draws=Draws(torch.Generator().manual_seed(0)))
        state, metrics = runner.run_chunk(state, 6)
        return state.train_state, metrics

    plain, plain_metrics = run(None)
    initialize_multihost(f"localhost:{port}", 1, 0, device="cpu", timeout_s=60)
    try:
        meshed, metrics = run(make_mesh(("dp",)))
    finally:
        shutdown()
    assert plain.n_updates == meshed.n_updates > 0
    for (name, a), b in zip(plain.model.named_parameters(), meshed.model.parameters()):
        assert torch.equal(a, b), name
    for key, value in plain_metrics.items():
        assert torch.equal(value, metrics[key]), key
