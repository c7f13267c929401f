"""The recurrent family as a whole, at a small width: the five recipes of
``experiments/recurrent.py`` of ``tools/record_curves.py`` through the
port's runners against the JAX package's own, and a narrow DRQN on
AtariSim (single 84x84x1 frames, the Nature CNN, an LSTM of 16) against the
JAX runner on the example's network.

Off-policy (DRQN on PO-ABC and DelayedCue, recurrent IQN on DelayedCue,
and DRQN-AtariSim in ``test_torch_recurrent_atari_slice.py``): ``OffPolicyRunner.run_chunk`` of the JAX package under
``jax.disable_jit`` (DRQN's update, which draws nothing, jitted inside it)
with ``install_recurrent_tape``: every draw it makes
pops the port's next logged draw (kind and size checked), so each act
step's taus and explorer draws, each env reset (handed to the vmapped
resets by value, :class:`TapeEnv`), each window sample (rows, offsets) and
each update's taus are the port's. On-policy (recurrent PPO and TRPO on
DelayedCue): ``OnPolicyRunner.run_iterations`` of the JAX package, jitted,
with a ``ScriptedKey`` of the port's draws (``test_torch_onpolicy_slice.py``;
the cues by value through ``bernoulli``). ``EvalLoop`` against
``JaxEvalLoop`` on the same draws.

Sizes: 4 lanes, hidden 16 (IQN: 4 taus). Off-policy: rows of 12 steps
for DelayedCue (2 per lane) with windows of 4, of 5 for PO-ABC (3 per
lane), of 8 for AtariSim (2 per lane, sealed by filling; windows of 4,
burn-in 2), every lane's ring wrapping; one batch-4 update per scan step
from replay start on, target syncs every 32 transitions. On-policy: rollout 12, chunks of 4 (12 chunks),
PPO 2 epochs of batch 4, TRPO 2 value epochs of batch 4; 3 iterations.

Tolerances: counters, flags, rows, actions and the stored frames exact;
stored observations and carries 1e-5; losses 2e-5 relative; parameters
2e-5 absolute (Adam over 5-18 updates, ROADMAP C22; measured at most
5.4e-7, and 3.3e-6 for TRPO's policy after three float32 CG steps, ROADMAP
C21); on-policy metrics 1e-4 relative; evaluation returns exact.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_onpolicy_slice import PermutingDraws, ScriptedKey, install_scripted_keys
from test_torch_recurrent_cores import JaxRPiV, JaxRPolicy, JaxRPsi, JaxRQ, JaxRVF, np_tree
from test_torch_recurrent_modules import install_recurrent_tape
from test_torch_sac import assert_network
from test_torch_value_modules import Tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu.agents import RecurrentDQNCore as JaxRDQN
from pfrl_tpu.agents import RecurrentIQNCore as JaxRIQN
from pfrl_tpu.agents import RecurrentPPOCore as JaxRPPO
from pfrl_tpu.agents import RecurrentTRPOCore as JaxRTRPO
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
from pfrl_tpu.experiments import RunnerConfig as JaxConfig
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunner as JaxOnPolicyRunner
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunnerState as JaxOnPolicyState
from pfrl_tpu.experiments.runner import RunnerState as JaxRunnerState
from pfrl_tpu.explorers import ConstantEpsilonGreedy as JaxConstantEps
from pfrl_tpu.explorers import LinearDecayEpsilonGreedy as JaxLinearDecay
from pfrl_tpu.q_functions import RecurrentImplicitQuantileQFunction as JaxRIQF
from pfrl_tpu.replay import EpisodicReplayBuffer as JaxEpisodic
from pfrl_tpu.replay import PrioritizedEpisodicReplayBuffer as JaxPrioritizedEpisodic
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents.recurrent_dqn import RecurrentDQNCore
from pfrl_tpu_torch.agents.recurrent_iqn import RecurrentIQNCore
from pfrl_tpu_torch.agents.recurrent_ppo import RecurrentPPOCore
from pfrl_tpu_torch.agents.recurrent_trpo import RecurrentTRPOCore
from pfrl_tpu_torch.envs import ABC, AtariSim, DelayedCue
from pfrl_tpu_torch.experiments import recurrent as rec
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer
from pfrl_tpu_torch.replay.prioritized_episodic import PrioritizedEpisodicReplayBuffer
from pfrl_tpu_torch.utils import recurrent as tutils

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES, HIDDEN, TAUS = 4, 16, 4


def load_example(relpath):
    spec = importlib.util.spec_from_file_location(relpath.replace("/", "_")[:-3], os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --------------------------------------------------------- env draw bridges
class TapeEnv(VectorJaxEnv):
    """``VectorJaxEnv`` whose resets are the port's next logged draws,
    handed to the vmapped resets by value: DelayedCue's cue uniform, or
    AtariSim's seed and episode-length draws as ``[seed, u]`` per lane; ABC
    (deterministic PO) draws nothing."""

    def __init__(self, env, num_envs, tape, kind):
        super().__init__(env, num_envs)
        self.tape, self.kind = tape, kind

    def _reset_keys(self):
        if self.kind == "cue":
            (u,) = self.tape.take("uniform")
            return jnp.asarray(u)
        if self.kind == "atari":
            seed, u = self.tape.take("randint", "uniform")
            return jnp.stack([jnp.asarray(seed, jnp.float32), jnp.asarray(u)], axis=1)
        return jnp.zeros((self.num_envs, 2), jnp.uint32)

    def reset(self, rng):
        return super().reset(self._reset_keys())

    def step(self, rng, states, actions):
        reset = self._reset_keys()
        return super().step(jnp.concatenate([jnp.zeros_like(reset), reset]), states, actions)


# --------------------------------------------------------------- recipes
SMALL_CUE = dict(num_envs=LANES, max_episodes=9, max_episode_len=12, subseq_len=4, replay_start_size=52,
                 update_interval=4, target_update_interval=32, minibatch_size=4)
SMALL_ABC = dict(SMALL_CUE, max_episodes=12, max_episode_len=5, subseq_len=None, replay_start_size=16)
SMALL_ATARI = dict(SMALL_CUE, max_episode_len=8, replay_start_size=40)
STEPS = {"drqn-po-abc": 14, "drqn-delayedcue": 26, "riqn-delayedcue": 25, "drqn-atarisim": 17}


def _jax_example_q(n_actions):
    example = load_example("examples/atari/train_drqn_ale.py")
    return example.RecurrentQ(n_actions=n_actions, lstm_size=HIDDEN), example.phi


def setup_offpolicy(kind):
    """(port runner, eval loop, JAX core, JAX env, env kind, sizes)."""
    if kind == "drqn-po-abc":
        runner, loop = rec.make_drqn_po_abc_runner(hidden=HIDDEN, device="cpu", **SMALL_ABC)
        jcore = JaxRDQN(model=JaxRQ(n_actions=3), optimizer=optax.adam(5e-3), explorer=JaxConstantEps(0.3, 3),
                        gamma=0.9)
        return runner, loop, jcore, jenvs.ABC(size=3, partially_observable=True, deterministic=True), "abc", SMALL_ABC
    if kind == "drqn-delayedcue":
        runner, loop = rec.make_drqn_delayed_cue_runner(hidden=HIDDEN, device="cpu", **SMALL_CUE)
        jcore = JaxRDQN(model=JaxRQ(), optimizer=optax.adam(5e-3), explorer=JaxConstantEps(0.2, 2), gamma=0.95)
        return runner, loop, jcore, jenvs.DelayedCue(12, 8), "cue", SMALL_CUE
    if kind == "riqn-delayedcue":
        sizes = dict(SMALL_CUE, replay_start_size=84)  # five updates: its JAX update runs eagerly
        runner, loop = rec.make_riqn_delayed_cue_runner(hidden=HIDDEN, n_taus=TAUS, device="cpu", **sizes)
        jcore = JaxRIQN(model=JaxRIQF(psi=JaxRPsi(), n_actions=2, n_basis_functions=32), optimizer=optax.adam(3e-3),
                        explorer=JaxConstantEps(0.2, 2), gamma=0.95, quantile_thresholds_N=TAUS,
                        quantile_thresholds_N_prime=TAUS, quantile_thresholds_K=TAUS)
        return runner, loop, jcore, jenvs.DelayedCue(12, 8), "cue", sizes
    runner, loop = rec.make_drqn_atarisim_runner(lstm_size=HIDDEN, final_exploration_frames=100, burn_in=2,
                                                 device="cpu", **SMALL_ATARI)
    jmodel, phi = _jax_example_q(6)
    jcore = JaxRDQN(model=jmodel, optimizer=optax.adam(2.5e-4, eps=1e-2),
                    explorer=JaxLinearDecay(1.0, 0.01, 100, 6), gamma=0.99, phi=phi, burn_in=2)
    return runner, loop, jcore, jenvs.AtariSim(n_actions=6, frame_shape=(84, 84, 1)), "atari", SMALL_ATARI


def _run_jax_offpolicy(jcore, jenv, env_kind, sizes, jtrain, tape, steps, prioritized=False):
    config = JaxConfig(**{k: sizes[k] for k in ("num_envs", "replay_start_size", "update_interval",
                                                  "target_update_interval", "minibatch_size")})
    buffer = (JaxPrioritizedEpisodic if prioritized else JaxEpisodic)(
        sizes["max_episodes"], sizes["max_episode_len"], num_lanes=LANES, subseq_len=sizes["subseq_len"])
    buffer.sample_episodes = _logging_rows(buffer.sample_episodes)
    if not isinstance(jcore, JaxRIQN):
        # DRQN's update draws nothing: it runs jitted inside the eager runner.
        jitted = jax.jit(jcore.update_episodic)

        def update_episodic(state, rng, batch):
            with jax.disable_jit(False):
                return jitted(state, rng, batch)

        jcore.update_episodic = update_episodic
    jrunner = JaxRunner(jenv, jcore, buffer, config)
    jrunner.env = TapeEnv(jenv, LANES, tape, env_kind)
    env_states, obs = jrunner.env.reset(None)
    act_state = jcore.init_act_state(LANES)
    one = jax.tree.map(lambda x: x[0], act_state)
    action = jnp.zeros((), jnp.int32)
    example = JaxTransition(obs=obs[0], action=action, reward=jnp.zeros(()), next_obs=obs[0],
                            terminated=jnp.zeros((), bool), done=jnp.zeros((), bool),
                            extras=FrozenDict({"carry": one, "next_carry": one}))
    state = JaxRunnerState(
        env_states=env_states, obs=obs, train_state=jtrain, replay_state=buffer.init(example),
        rng=jnp.zeros((2,), jnp.uint32), t=jnp.int32(0), episode_return=jnp.zeros(LANES),
        recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0), act_state=act_state,
    )
    with jax.disable_jit():
        state, metrics = jrunner.run_chunk(state, steps)
    return jrunner, state, metrics


def _logging_rows(sample_episodes):
    """``sample_episodes`` that logs each batch's rows in ``.rows``."""

    def sample(*args, **kwargs):
        batch = sample_episodes(*args, **kwargs)
        sample.rows.append(np.asarray(batch.rows))
        return batch

    sample.rows = []
    return sample


def small_offpolicy(kind, prioritized=False):
    """With ``prioritized`` the recipe's runner over the prioritized
    episodic buffer (defaults: uniform share 0.1, alpha 1, eps 1e-3), on
    both sides."""
    runner, loop, jcore, jenv, env_kind, sizes = setup_offpolicy(kind)
    if prioritized:
        buffer = PrioritizedEpisodicReplayBuffer(sizes["max_episodes"], sizes["max_episode_len"], num_lanes=LANES,
                                                 subseq_len=sizes["subseq_len"], device="cpu")
        runner = OffPolicyRunner(runner.env.env, runner.core, buffer, runner.config, device="cpu")
    runner.buffer.sample_episodes = _logging_rows(runner.buffer.sample_episodes)
    obs_shape = (84, 84, 1) if env_kind == "atari" else (runner.env.observation_space.shape[0],)
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES,) + obs_shape, jnp.uint8 if env_kind == "atari"
                                                         else jnp.float32))
    tape = Tape(0)
    state = runner.init(0, draws=tape)
    state.train_state = convert.dqn_state_from_flax(runner.core, np_tree(jtrain.params), np_tree(jtrain.target_params),
                                                    np_tree(jtrain.opt_state), device="cpu")
    state, metrics = runner.run_chunk(state, STEPS[kind])
    kinds = [k for k, _ in tape.log]
    with pytest.MonkeyPatch.context() as mp:
        install_recurrent_tape(mp, tape)
        jax_run = _run_jax_offpolicy(jcore, jenv, env_kind, sizes, jtrain, tape, STEPS[kind], prioritized)
    assert not tape.log  # every draw the port made was replayed
    return dict(runner=runner, loop=loop, state=state, metrics=metrics, kinds=kinds, jax=jax_run, jcore=jcore,
                jenv=jenv, env_kind=env_kind, sizes=sizes)


# --------------------------------------------------------------- on-policy
ON_ROLLOUT, ITERATIONS = 12, 3


def setup_onpolicy(kind):
    if kind == "rppo-delayedcue":
        runner, loop = rec.make_rppo_delayed_cue_runner(hidden=HIDDEN, num_envs=LANES, rollout=ON_ROLLOUT, epochs=2,
                                                        minibatch_size=4, device="cpu")
        jcore = JaxRPPO(JaxRPiV(), optax.adam(5e-3), gamma=0.95, epochs=2, minibatch_size=4, entropy_coef=1e-2,
                        chunk_len=4)
        return runner, loop, jcore, convert.ppo_state_from_flax, 2
    runner, loop = rec.make_rtrpo_delayed_cue_runner(hidden=HIDDEN, num_envs=LANES, rollout=ON_ROLLOUT, vf_epochs=2,
                                                     vf_batch_size=4, device="cpu")
    jcore = JaxRTRPO(policy=JaxRPolicy(), vf=JaxRVF(), vf_optimizer=optax.adam(3e-3), gamma=0.95, entropy_coef=1e-2,
                     max_kl=0.01, vf_epochs=2, vf_batch_size=4, chunk_len=4)
    return runner, loop, jcore, convert.trpo_state_from_flax, 2


def small_onpolicy(kind):
    runner, loop, jcore, from_flax, n_perm = setup_onpolicy(kind)
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, 13)))
    draws = PermutingDraws(0)
    state = runner.init(0, draws=draws)
    state.train_state = from_flax(runner.core, np_tree(jtrain), device="cpu")
    state, aux = runner.run_iterations(state, ITERATIONS)
    kinds = [k for k, _ in draws.log]
    with pytest.MonkeyPatch.context() as mp:
        install_scripted_keys(mp)
        mp.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None: key < p)
        jenv = jenvs.DelayedCue(12, 8)
        jrunner = JaxOnPolicyRunner(jenv, jcore, LANES, ON_ROLLOUT)
        env_states, obs = VectorJaxEnv(jenv, LANES).reset(jnp.asarray(draws.take("uniform")[0]))
        acts, envs, updates = [], [], []
        for _ in range(ITERATIONS):
            for _ in range(ON_ROLLOUT):
                acts.append(draws.take("uniform")[0].reshape(LANES, 2))
                (u,) = draws.take("uniform")
                envs.append(np.concatenate([np.zeros_like(u), u]))
            updates.append(np.stack(draws.take(*["permutation"] * n_perm)).astype(np.int32))
        assert not draws.log
        key = ScriptedKey(step=jnp.int32(0), iteration=jnp.int32(0), act=jnp.asarray(np.stack(acts)),
                          env=jnp.asarray(np.stack(envs)), update=jnp.asarray(np.stack(updates)))
        jstate = JaxOnPolicyState(
            env_states=env_states, obs=obs, train_state=jtrain, rng=key, t=jnp.int32(0),
            episode_return=jnp.zeros(LANES), recent_returns=jnp.zeros(jrunner.return_window),
            recent_count=jnp.int32(0), act_state=jcore.init_act_state(LANES),
        )
        jstate = jax.tree.map(lambda x: jnp.array(x, copy=True), jstate)
        jstate, jaux = jrunner.run_iterations(jstate, ITERATIONS)
    return dict(runner=runner, loop=loop, state=state, aux=aux, kinds=kinds, jax=(jrunner, jstate, jaux),
                jcore=jcore)


# xdist hands out whole files: the narrow DRQN-AtariSim run is held by
# ``test_torch_recurrent_atari_slice.py`` through the same functions.
OFF = ("drqn-po-abc", "drqn-delayedcue", "riqn-delayedcue")
ON = ("rppo-delayedcue", "rtrpo-delayedcue")


@pytest.fixture(scope="module")
def trained():
    runs = {kind: small_offpolicy(kind) for kind in OFF}
    runs.update({kind: small_onpolicy(kind) for kind in ON})
    return runs


# ------------------------------------------------------------------ tests
def _close(got, want, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("kind", OFF)
def test_offpolicy_recipe_matches_the_jax_runner(trained, kind):
    assert_offpolicy_matches(trained[kind], kind)


def assert_offpolicy_matches(run, kind):
    runner, state, metrics = run["runner"], run["state"], run["metrics"]
    jrunner, jstate, jmetrics = run["jax"]
    cfg, steps = runner.config, STEPS[kind]
    assert state.t == int(jstate.t) == steps * LANES
    update_steps = sum(1 for k in range(1, steps + 1) if k * LANES >= cfg.replay_start_size)
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates) == update_steps * cfg.updates_per_step >= 5
    rows, jrows = runner.buffer.sample_episodes.rows, jrunner.buffer.sample_episodes.rows
    assert len(rows) == len(jrows) == ts.n_updates
    for i, (got, want) in enumerate(zip(rows, jrows)):
        np.testing.assert_array_equal(got, want, err_msg=f"rows of update {i}")
    count = run["kinds"].count
    if kind == "riqn-delayedcue":  # per act step K taus; per update T online and T target tau draws
        assert count("uniform") == 1 + steps * 3 + update_steps * (2 + 2 * 4)

    replay, jreplay = state.replay_state, jstate.replay_state
    for name in ("ep_len", "finished", "lane_row", "n_started"):
        np.testing.assert_array_equal(getattr(replay, name).numpy(), np.asarray(getattr(jreplay, name)), err_msg=name)
    rows_per_lane = runner.buffer.max_episodes // LANES
    assert int(replay.n_started) - LANES >= LANES * rows_per_lane  # every lane's ring wrapped
    for name in ("action", "terminated", "done", "reward"):
        want = np.asarray(getattr(jreplay.storage, name))
        np.testing.assert_array_equal(replay.storage[name].numpy().reshape(want.shape), want, err_msg=name)
    for name in ("obs", "next_obs"):
        want = np.asarray(getattr(jreplay.storage, name))
        _close(replay.storage[name].numpy().reshape(want.shape), want, 1e-5, name)
    for name in ("carry", "next_carry"):
        for g, w in zip(tutils.tree_leaves(replay.storage["extras"][name]), jax.tree.leaves(jreplay.storage.extras[name])):
            _close(g.numpy(), w, 1e-5, name)
    for g, w in zip(tutils.tree_leaves(state.act_state), jax.tree.leaves(jstate.act_state)):
        _close(g.numpy(), w, 1e-5, "act_state")

    _close(metrics["loss"].numpy(), jmetrics["loss"], 1e-7, "loss", rtol=2e-5)
    np.testing.assert_array_equal(metrics["done_count"].numpy(), np.asarray(jmetrics["done_count"]))
    assert int(state.recent_count) == int(jstate.recent_count)
    for module, tree in ((ts.model, jts.params), (ts.target_model, jts.target_params)):
        assert_network(module, tree, 2e-5, kind)
    if run["env_kind"] == "cue":
        assert int(state.recent_count) > 0


@pytest.mark.parametrize("kind", ON)
def test_onpolicy_recipe_matches_the_jax_runner(trained, kind):
    run = trained[kind]
    runner, state, aux = run["runner"], run["state"], run["aux"]
    jrunner, jstate, jaux = run["jax"]
    assert state.t == int(jstate.t) == ITERATIONS * ON_ROLLOUT * LANES
    _close(state.obs.numpy(), jstate.obs, 0.0, "obs")
    for g, w in zip(tutils.tree_leaves(state.act_state), jax.tree.leaves(jstate.act_state)):
        _close(g.numpy(), w, 1e-5, "act_state")
    assert int(state.recent_count) == int(jstate.recent_count) > 0
    _close(state.recent_returns.numpy(), jstate.recent_returns, 0.0, "returns")
    assert set(aux) == set(jaux)
    for name, got in aux.items():
        _close(got.numpy(), jaux[name], 1e-6, name, rtol=1e-4)
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates)
    if kind == "rtrpo-delayedcue":
        assert_network(ts.policy, jts.policy_params, 2e-5, "policy")
        assert_network(ts.vf, jts.vf_params, 2e-5, "vf")
        assert isinstance(runner.core, RecurrentTRPOCore)
    else:
        assert_network(ts.model, jts.params, 2e-5, "model")
        assert isinstance(runner.core, RecurrentPPOCore)
    # The rollout stored the carry before each act and V(s') after it.
    r = state.rollout
    assert r.next_value.shape == r.value.shape == (ON_ROLLOUT, LANES)
    first = tutils.tree_leaves(r.carry)[0]
    assert first.shape[:2] == (ON_ROLLOUT, LANES)


@pytest.mark.parametrize("kind", OFF + ON)
def test_eval_loop_matches_jax_eval_loop(trained, kind):
    assert_eval_matches(trained[kind])


def assert_eval_matches(run):
    env_kind = run.get("env_kind", "cue")
    lanes, max_steps = 5, {"abc": 7, "cue": 14, "atari": 6}[env_kind]
    tape = Tape(1)
    loop = EvalLoop(run["runner"].env.env, run["runner"].core, lanes, max_steps, device="cpu")
    got = loop.evaluate(run["state"].train_state, tape)
    jenv = run.get("jenv") or jenvs.DelayedCue(12, 8)
    jloop = JaxEvalLoop(jenv, run["jcore"], lanes, max_steps)
    jloop.env = TapeEnv(jenv, lanes, tape, env_kind)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_recurrent_tape(mp, tape)
        want = jloop.evaluate(run["jax"][1].train_state, jnp.zeros((2,), jnp.uint32))
    assert not tape.log
    assert got.shape == want.shape == (lanes,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_recipes_hold_the_published_widths_and_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in rec.RECIPES.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    runner, loop = rec.make_drqn_po_abc_runner(device="cpu")
    assert isinstance(runner.env.env, ABC) and runner.env.env.partially_observable and runner.env.env.deterministic
    cfg, buf = runner.config, runner.buffer
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
            cfg.minibatch_size) == (16, 128, 16, 128, 16)
    assert (buf.max_episodes, buf.max_episode_len, buf.subseq_len, buf.stores_carries) == (512, 5, None, True)
    assert (loop.env.num_envs, loop.max_steps) == (10, 5) and runner.core.gamma == 0.9
    for make, core_cls in ((rec.make_drqn_delayed_cue_runner, RecurrentDQNCore),
                           (rec.make_riqn_delayed_cue_runner, RecurrentIQNCore)):
        runner, loop = make(device="cpu")
        cfg, buf = runner.config, runner.buffer
        assert type(runner.core) is core_cls and isinstance(runner.env.env, DelayedCue)
        assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
                cfg.minibatch_size, cfg.updates_per_step) == (16, 256, 8, 256, 32, 2)
        assert (buf.max_episodes, buf.max_episode_len, buf.subseq_len) == (256, 12, 4)
        assert (loop.env.num_envs, loop.max_steps) == (16, 12) and runner.core.gamma == 0.95
    assert runner.core.N == runner.core.N_prime == runner.core.K == 8
    for make, core_cls in ((rec.make_rppo_delayed_cue_runner, RecurrentPPOCore),
                           (rec.make_rtrpo_delayed_cue_runner, RecurrentTRPOCore)):
        runner, loop = make(device="cpu")
        assert type(runner.core) is core_cls and (runner.num_envs, runner.rollout_len) == (16, 24)
        assert runner.core.chunk_len == 4 and (loop.env.num_envs, loop.max_steps) == (32, 12)
    with pytest.raises(ValueError, match="float32 only"):
        rec.make_rtrpo_delayed_cue_runner(device="cpu", compute_dtype=torch.bfloat16)
    # The full-width DRQN-AtariSim at a small ring: every other width is the example's.
    runner, loop = rec.make_drqn_atarisim_runner(device="cpu", max_episodes=96)
    cfg, buf, core = runner.config, runner.buffer, runner.core
    assert isinstance(runner.env.env, AtariSim) and runner.env.env.frame_shape == (84, 84, 1)
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
            cfg.minibatch_size, cfg.updates_per_step) == (32, 10_000, 4, 10_000, 32, 8)
    assert (buf.max_episode_len, buf.subseq_len, buf.stores_carries) == (128, 32, True)
    assert core.model.lstm.features == 512 and core.model.head.out_features == 6
    assert (core.optimizer.learning_rate, core.optimizer.eps, core.gamma, core.burn_in) == (2.5e-4, 1e-2, 0.99, 0)
    assert (core.explorer.end_epsilon, core.explorer.decay_steps) == (0.01, 10**6)
    assert (loop.env.num_envs, loop.max_steps) == (5, 500)
    assert isinstance(EpisodicReplayBuffer(8, 4, 2, device="cpu"), EpisodicReplayBuffer)
    assert isinstance(DelayedCue(device="cpu"), DelayedCue)
