"""The port's actor-learner path against the JAX package's, on the CPU.

- The server's padded act: three rows padded to eight slots, acted by the
  port's ``DQN._actor_act_fn`` and by JAX's, through each package's
  ``BatchedInferenceServer._run_batch``, on the same weights and the same
  ε-greedy draws (the tape's, by value, ``install_tape``, ROADMAP C29): the
  padded batches and the actions equal, the draws covering all eight rows.
- The poller: one per-actor transition script, its actors interleaved out
  of order, drained by each package's ``_poller_loop`` (single-lane and
  two-lane vector actors; ``store_next_obs`` on and off): the ring rows,
  cursor and lane count equal.
- The learner in lockstep: the rings filled so, ``_learner_loop`` runs
  ``n_updates`` updates in the test's thread for ``DQN``, ``DoubleDQN``,
  ``CategoricalDQN`` and ``IQN`` (JAX under ``jax.disable_jit`` on the
  port's logged draws): every learned tensor within 3e-6 or 4x what ulp
  nudges of the port's starting weights move it (``assert_within_nudges``,
  C48's rule), the statistics within 1e-5 relative, the target syncs at
  each ``t % target_update_interval == 0``, the publications, ``t`` and
  the hooks' calls equal.
- ``AsyncEvaluator``: one scripted schedule through both packages'
  evaluators, then the same eight-thread hammer: the evaluations, the
  returned scores, the best saves and the ``scores.txt`` rows equal.
- ``train_agent_async``: the shared-model mode drives the ``A3C`` shell
  (both packages' A2C under the reference's name) over two CartPole lanes,
  held as ``test_torch_host_onpolicy.py`` holds A2C; the actor-learner
  mode drives one scripted agent over a scripted env (the calls, the step
  hooks and the saved directories equal), and an env that fails raises in
  both after the agent saved its ``_except`` model.
- ``Counter``, ``StoppableThread`` and ``run_async`` (the port's workers
  spawned, JAX's forked): the same counts, worker outputs and warning.
- The A3C recipe (``experiments/atari_a3c.py``, ``train_a3c.py --sim``'s
  network and optimizer) over three iterations of 4 AtariSim lanes with
  ``t_max`` 5 against the JAX ``OnPolicyRunner`` with ``A3CCore`` (jitted,
  a ``ScriptedKey`` of the port's draws, ``test_torch_acer_atari_slice.py``):
  ``t`` and observations exact, metrics 1e-4 relative, parameters 2e-5.
"""

import contextlib
import functools
import logging
import os
import threading
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_acer_atari_slice import EPISODE, LANES, PermutingTape, _reset_keys
from test_torch_host_agents import (
    NUDGES,
    _dqn_tensors,
    _jax_dqn_tensors,
    assert_stats_close,
    assert_within_nudges,
    new_log,
    record,
    scale_weights,
)
from test_torch_actor_learner_threads import time_limit
from test_torch_host_onpolicy import (
    PermutationTape,
    assert_scores_close,
    install_permutation_tape,
    jax_tensors,
    port_tensors,
)
from test_torch_host_onpolicy import assert_stats_close as assert_onpolicy_stats_close
from test_torch_host_value_shells import q_functions
from test_torch_onpolicy_slice import ScriptedKey, install_scripted_keys
from test_torch_ppo import JaxSoftmaxPiV
from test_torch_rainbow_modules import np_tree
from test_torch_recurrent_slice import load_example
from test_torch_sac import assert_network
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu import agents as jagents
from pfrl_tpu import envs as jenvs
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu.agents.a3c import A3C as JaxA3C
from pfrl_tpu.agents.a3c import A3CCore as JaxA3CCore
from pfrl_tpu.envs import CartPole as JaxCartPole
from pfrl_tpu.envs import HostJaxEnv
from pfrl_tpu.envs import TimeLimit as JaxTimeLimit
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.experiments import train_agent_async as jax_train_agent_async
from pfrl_tpu.experiments.evaluator import AsyncEvaluator as JaxAsyncEvaluator
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunner as JaxOnPolicyRunner
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunnerState as JaxOnPolicyState
from pfrl_tpu.parallel.inference_server import _Request as JaxRequest
from pfrl_tpu.replay import ReplayBuffer as JaxReplayBuffer
from pfrl_tpu_torch import agents as tagents
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch import explorers as texplorers
from pfrl_tpu_torch.agents import A3C, A3CCore
from pfrl_tpu_torch.envs import CartPole, HostTorchEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments import AsyncEvaluator, train_agent_async
from pfrl_tpu_torch.experiments.atari_a3c import A3CNet, make_a3c_atarisim_runner
from pfrl_tpu_torch.experiments.onpolicy import SoftmaxPiV
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.parallel.inference_server import _Request
from pfrl_tpu_torch.replay import ReplayBuffer

torch.set_num_threads(1)

KW = dict(replay_start_size=8, minibatch_size=4, update_interval=1, target_update_interval=4)
LOGGER = logging.getLogger(__name__)


def jax_shell(name, capacity=256, store_next_obs=True):
    jagent = getattr(jagents, name)(q_functions(name)[0], optax.adam(1e-2),
                                    JaxReplayBuffer(capacity, gamma=0.9, store_next_obs=store_next_obs), 0.9,
                                    jexplorers.ConstantEpsilonGreedy(0.3, 2), **KW)
    jagent._ensure_init(np.zeros((1, 4), np.float32))
    return jagent


def port_shell(name, jstate, draws, scale=1.0, capacity=256, store_next_obs=True):
    tagent = getattr(tagents, name)(q_functions(name)[1], Adam(1e-2),
                                    ReplayBuffer(capacity, gamma=0.9, store_next_obs=store_next_obs, device="cpu"),
                                    0.9, texplorers.ConstantEpsilonGreedy(0.3, 2), **KW, device="cpu", draws=draws)
    convert.dqn_shell_from_flax(tagent, jstate)
    return scale_weights(tagent, scale)


# ------------------------------------------------------------ the server
def test_server_pads_three_rows_to_eight_slots_and_acts_like_jax():
    jagent = jax_shell("DQN")
    tape = Tape(3)
    tagent = port_shell("DQN", np_tree(jagent.train_state), Tape(0))
    jagent.setup_actor_learner_training(n_actors=3, inference_slots=8)
    tagent.setup_actor_learner_training(n_actors=3, inference_slots=8, actor_draws=tape)
    for agent in (jagent, tagent):
        agent._inference.stop()  # batches run below, in this thread
    rs = np.random.RandomState(0)
    seen = {}

    def recording(act_fn, key):
        def act(seed, obs, t, training):
            seen[key] = (seed, np.asarray(obs).copy(), t, training)
            return act_fn(seed, obs, t, training)
        return act

    for training in (True, False):
        obs = rs.normal(size=(3, 4)).astype(np.float32)
        treq, jreq = _Request(obs, 3, training), JaxRequest(obs, 3, training)
        tagent._inference.act_fn = recording(tagent._actor_act_fn, "port")
        tagent._inference._run_batch([treq], 3)
        assert [k for k, _ in tape.log] == (["uniform", "randint"] if training else [])
        assert all(v.shape == (8,) for _, v in tape.log)  # the draws cover the padded batch
        jagent._inference.act_fn = recording(jagent._actor_act_fn, "jax")
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            install_tape(mp, tape)
            jagent._inference._run_batch([jreq], 3)
        assert not tape.log
        (tseed, tobs, tt, ttrain), (jseed, jobs, jt, jtrain) = seen["port"], seen["jax"]
        assert tseed == jseed and tt == jt == 0 and ttrain == jtrain == training
        np.testing.assert_array_equal(tobs, jobs)
        np.testing.assert_array_equal(tobs[3:], np.broadcast_to(obs[:1], (5, 4)))
        np.testing.assert_array_equal(treq.actions, np.asarray(jreq.actions))
        assert treq.actions.shape == (3,)
    assert tagent._acting is not None


# ------------------------------------------------------------ the poller
def transition_script(seed, n_actors, lanes, steps):
    """``(actor_id, data)`` messages: each actor's ``steps`` transitions in
    its order, the actors interleaved out of order."""
    rs = np.random.RandomState(seed)
    per_actor = []
    for i in range(n_actors):
        msgs = []
        for _ in range(steps):
            shape = (lanes,) if lanes > 1 else ()
            done = rs.uniform(size=shape) < 0.2
            reset = ~done & (rs.uniform(size=shape) < 0.1)
            msgs.append((i, dict(
                obs=rs.normal(size=shape + (4,)).astype(np.float32),
                action=(rs.randint(0, 2, size=shape) if lanes > 1 else np.int64(rs.randint(2))),
                reward=rs.normal(size=shape).astype(np.float32) if lanes > 1 else np.float32(rs.normal()),
                next_obs=rs.normal(size=shape + (4,)).astype(np.float32),
                terminated=done if lanes > 1 else bool(done), done=done | reset if lanes > 1 else bool(done | reset))))
        per_actor.append(msgs)
    order = rs.permutation(np.repeat(np.arange(n_actors), steps))
    return [per_actor[i].pop(0) for i in order]


def drain(agent, script, **setup):
    """``setup_actor_learner_training(**setup)``, then the script through
    the agent's own poller thread, stopped once every row is in the ring.
    Returns what ``setup`` returned."""
    out = agent.setup_actor_learner_training(**setup)
    make_actor, _, poller, exception_event = out
    transitions = make_actor(0).transition_queue
    for msg in script:
        transitions.put(msg)
    poller.daemon = True
    poller.start()
    lanes = setup.get("lanes_per_actor", 1)
    expected = len(script) * lanes
    deadline = time.time() + 60
    while agent._replay_inserted < expected and time.time() < deadline and not exception_event.is_set():
        time.sleep(0.01)
    poller.stop()
    poller.join(10)
    assert not poller.is_alive() and not exception_event.is_set() and agent._replay_inserted == expected
    return out


def assert_rings_equal(tagent, jagent):
    ts, js = tagent.replay_state, jagent.replay_state
    assert int(ts.cursor) == int(js.cursor) and tagent.buffer.num_lanes == jagent.buffer.num_lanes
    for name, s in ts.storage.items():
        np.testing.assert_array_equal(s.numpy(), np.asarray(getattr(js.storage, name)), err_msg=name)


@pytest.mark.parametrize("lanes,store_next_obs", [(1, True), (1, False), (2, True)])
def test_poller_fills_the_ring_like_jax_from_actors_out_of_order(lanes, store_next_obs):
    script = transition_script(1, 3, lanes, 14)
    jagent = jax_shell("DQN", store_next_obs=store_next_obs)
    tagent = port_shell("DQN", np_tree(jagent.train_state), Tape(0), store_next_obs=store_next_obs)
    with time_limit(120):
        drain(jagent, script, n_actors=3, lanes_per_actor=lanes)
        drain(tagent, script, n_actors=3, lanes_per_actor=lanes)
    assert tagent.buffer.num_lanes == 3 * lanes and tagent.cumulative_steps == jagent.cumulative_steps == 42 * lanes
    assert_rings_equal(tagent, jagent)
    assert tagent._inference._thread is not None and not tagent._inference._thread.is_alive()  # the poller stopped it


# ------------------------------------------------------------ the learner
N_UPDATES = 12


def lockstep(agent, script, hooks, tape_ctx=contextlib.nullcontext):
    """The rings filled by the poller, then ``N_UPDATES`` updates of the
    learner loop in this thread, with the target syncs counted."""
    _, _, _, exception_event = drain(agent, script, n_actors=2, actor_update_interval=3)
    syncs = []
    sync_target = agent.core.sync_target

    def counted(state):
        syncs.append(agent.t)
        return sync_target(state)

    agent.core.sync_target = counted
    with tape_ctx():
        agent._learner_loop(threading.Event(), exception_event, N_UPDATES, 3, [hooks["step"]],
                            [hooks["optimizer"]], LOGGER)
    assert not exception_event.is_set()
    return syncs


@pytest.mark.parametrize("name", ["DQN", "DoubleDQN", "CategoricalDQN", "IQN"])
def test_learner_loop_matches_jax_in_lockstep(name):
    script = transition_script(2, 2, 1, 20)
    jagent = jax_shell(name)
    jstate = np_tree(jagent.train_state)

    def port_run(scale):
        tape, hooks = Tape(9), {"step": mock.Mock(), "optimizer": mock.Mock()}
        tagent = port_shell(name, jstate, tape, scale)
        return tagent, tape, hooks, lockstep(tagent, script, hooks)

    with time_limit(300):
        tagent, tape, thooks, tsyncs = port_run(1.0)
        nudged = [port_run(s)[0] for s in NUDGES]
        jhooks = {"step": mock.Mock(), "optimizer": mock.Mock()}

        @contextlib.contextmanager
        def taped():
            with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
                install_tape(mp, tape)
                yield

        jsyncs = lockstep(jagent, script, jhooks, taped)
    assert not tape.log
    assert tagent.optim_t == jagent.optim_t == N_UPDATES == tagent.train_state.n_updates
    assert tagent.t == jagent.t == N_UPDATES * KW["update_interval"]
    assert tsyncs == jsyncs == [4, 8, 12]  # at t % target_update_interval == 0
    assert tagent.update_counter.value == jagent.update_counter.value == N_UPDATES // 3
    for key in ("step", "optimizer"):
        assert [c.args[2] for c in thooks[key].call_args_list] == [c.args[2] for c in jhooks[key].call_args_list]
        assert thooks[key].call_count == N_UPDATES and thooks[key].call_args_list[0].args[:2] == (None, tagent)
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics())
    assert_within_nudges(_dqn_tensors(tagent), _jax_dqn_tensors(tagent, jagent),
                         [_dqn_tensors(a) for a in nudged], name)
    # The last publication was after update 12: the acting copy is the online net.
    for a, b in zip(tagent._acting.model.parameters(), tagent.train_state.model.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------ AsyncEvaluator
SCORES = [1.0, 3.0, 2.0, 5.0, 5.0, 4.0]


def _fake_eval(scores, lock):
    def eval_performance(env, agent, n_steps, n_episodes, max_episode_len=None, logger=None):
        with lock:
            mean = next(scores)
        return {"mean": mean, "median": mean, "stdev": 0.0, "max": mean, "min": mean, "episodes": 1}
    return eval_performance


def _run_evaluator(cls, module, outdir, schedule, threads):
    agent = mock.Mock()
    agent.get_statistics.return_value = [("average_q", 0.5)]
    saved, returned, lock = [], [], threading.Lock()
    evaluator = cls(n_steps=None, n_episodes=1, eval_interval=10, outdir=outdir, step_offset=3)
    agent.save.side_effect = lambda dirname: saved.append(evaluator._max_score)
    with mock.patch(f"{module}.eval_performance", _fake_eval(iter(SCORES * 4), lock)):
        def actor(ts):
            for t in ts:
                out = evaluator.evaluate_if_necessary(t=t, episodes=t // 4, env=None, agent=agent)
                if out is not None:
                    with lock:
                        returned.append((t, out))

        workers = [threading.Thread(target=actor, args=(schedule[i::threads],)) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(30)
    rows = [line.split("\t") for line in open(os.path.join(outdir, "scores.txt")).read().splitlines()]
    return returned, saved, evaluator.max_score, [r[:2] + r[3:] for r in rows]


@pytest.mark.parametrize("threads", [1, 8])
def test_async_evaluator_matches_jax(tmp_path, threads):
    schedule = [3, 9, 13, 14, 22, 35, 36, 50, 51, 52, 70, 71, 89, 90]
    if threads > 1:
        schedule = list(range(4, 124))
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    with time_limit(60):
        got = _run_evaluator(AsyncEvaluator, "pfrl_tpu_torch.experiments.evaluator", str(tmp_path / "port"),
                             schedule, threads)
        want = _run_evaluator(JaxAsyncEvaluator, "pfrl_tpu.experiments.evaluator", str(tmp_path / "jax"),
                              schedule, threads)
    (treturned, tsaved, tmax, trows), (jreturned, jsaved, jmax, jrows) = got, want
    if threads == 1:  # one schedule: the same evaluation points, scores, saves and rows
        # The schedule advances one interval per evaluation (50, then 51).
        assert treturned == jreturned and [t for t, _ in treturned] == [13, 22, 35, 50, 51, 70, 71, 89, 90]
        assert tsaved == jsaved == [1.0, 3.0, 5.0] and tmax == jmax == 5.0 and trows == jrows
        return
    # Under threads the order varies: each interval is evaluated once (a row
    # per evaluation), and each new best is saved once, in increasing order.
    for returned, saved, rows in ((treturned, tsaved, trows), (jreturned, jsaved, jrows)):
        assert 11 <= len(returned) <= 12 and len(rows) == len(returned) + 1
        assert saved == sorted(set(saved)) and saved[-1] == max(s for _, s in returned)


# ------------------------------------------------------------ train_agent_async
def test_shared_model_mode_drives_the_a3c_shell_like_jax(tmp_path):
    """``train_agent_async`` without a stop event: two CartPole lanes of a
    ``SerialVectorEnv`` through ``train_agent_batch`` with an ``Evaluator``;
    the agent is the ``A3C`` shell (episodes cut at 50 steps)."""
    jagent = JaxA3C(JaxSoftmaxPiV(n_actions=2, hidden=16), optax.adam(1e-3), 0.99, 2, update_steps=5)
    with jagent.eval_mode():
        jagent.batch_act(np.zeros((1, 4), np.float32))
    jstate = np_tree(jagent.train_state)
    kw = dict(processes=2, steps=100, eval_interval=50, eval_n_steps=None, eval_n_episodes=2, max_episode_len=50)

    def port_run(scale, outdir):
        os.makedirs(outdir)
        tape, log = PermutationTape(21), new_log()
        tagent = A3C(SoftmaxPiV(4, 2, 16), Adam(1e-3), 0.99, 2, update_steps=5, device="cpu", draws=tape)
        assert isinstance(tagent.core, tagents.A2CCore)
        convert.onpolicy_shell_from_flax(tagent, jstate)
        with torch.no_grad():
            for p in tagent.train_state.model.parameters():
                p.mul_(scale)
        make_env = lambda i, test: HostTorchEnv(TimeLimit(CartPole(device="cpu"), 500), draws=tape)  # noqa: E731
        out = train_agent_async(outdir=outdir, make_env=make_env, agent=record(tagent, log), **kw)
        assert out is tagent
        return tagent, tape, log

    with time_limit(300):
        tagent, tape, tlog = port_run(1.0, str(tmp_path / "port"))
        nudged = [port_run(s, str(tmp_path / f"nudged{i}"))[0] for i, s in enumerate(NUDGES)]
        jlog = new_log()
        (tmp_path / "jax").mkdir()
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            install_permutation_tape(mp, tape)
            out = jax_train_agent_async(outdir=str(tmp_path / "jax"), agent=record(jagent, jlog),
                                        make_env=lambda i, test: HostJaxEnv(JaxTimeLimit(JaxCartPole(), 500)), **kw)
            assert out is jagent and not tape.log
    assert len(tlog["actions"]) == len(jlog["actions"]) > 0
    for got, want in zip(tlog["actions"], jlog["actions"]):
        np.testing.assert_array_equal(got, want)
    assert tagent.t == jagent.t == 100 and tagent.train_state.n_updates == int(jagent.train_state.n_updates) == 10
    assert_onpolicy_stats_close(tagent.get_statistics(), jagent.get_statistics())
    assert_scores_close(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_within_nudges(port_tensors(tagent), jax_tensors(tagent, jagent), [port_tensors(a) for a in nudged],
                         "a3c")
    assert (tmp_path / "port" / "100_finish").is_dir() and (tmp_path / "jax" / "100_finish").is_dir()


class ScriptedEnv:
    observation_space = action_space = None

    def __init__(self, fail_at=None):
        self.t, self.episode_t, self.fail_at = 0, 0, fail_at

    def reset(self):
        self.episode_t = 0
        return np.float32(0.0)

    def step(self, action):
        self.t += 1
        if self.t == self.fail_at:
            raise RuntimeError("env step failed")
        self.episode_t += 1
        done = self.episode_t >= 3 + self.t % 2
        info = {"needs_reset": True} if self.episode_t == 5 else {}
        if done:
            self.episode_t = 0
        return np.float32(self.t), float(action) + 0.5, done, info


class ScriptedAgent:
    """Acts ``int(obs) % 2``; logs every call."""

    training = True

    def __init__(self):
        self.calls = []

    def act(self, obs):
        self.calls.append(("act", float(obs), self.training))
        return int(obs) % 2

    def observe(self, obs, r, done, reset):
        self.calls.append(("observe", float(obs), r, bool(done), bool(reset), self.training))

    @contextlib.contextmanager
    def eval_mode(self):
        self.training = False
        try:
            yield
        finally:
            self.training = True

    def save(self, dirname):
        self.calls.append(("save", os.path.basename(dirname)))

    def get_statistics(self):
        return [("n", len(self.calls))]


@pytest.mark.parametrize("fail_at", [None, 7])
def test_actor_learner_mode_matches_jax_with_one_scripted_actor(tmp_path, fail_at):
    def run(fn, outdir):
        agent, hooked = ScriptedAgent(), []
        os.makedirs(outdir)
        kw = dict(outdir=outdir, processes=1, make_env=lambda i, test: ScriptedEnv(None if test else fail_at),
                  steps=30, eval_interval=10, eval_n_steps=None, eval_n_episodes=2, max_episode_len=4,
                  make_agent=lambda i: agent, stop_event=threading.Event(),
                  global_step_hooks=[lambda env, a, t: hooked.append(t)])
        if fail_at is None:
            fn(**kw)
        else:
            with pytest.raises(RuntimeError, match="env step failed"):
                fn(**kw)
        return agent.calls, hooked, sorted(os.listdir(outdir))

    with time_limit(60):
        got = run(train_agent_async, str(tmp_path / "port"))
        want = run(jax_train_agent_async, str(tmp_path / "jax"))
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2] == ["scores.txt"]
    saves = [c for c in got[0] if c[0] == "save"]
    assert saves == ([("save", "best"), ("save", "30_finish")] if fail_at is None else [("save", "6_except")])


# ------------------------------------------------------------ thread helpers
def test_thread_helpers_and_run_async_behave_as_jax(tmp_path):
    """``Counter`` and ``StoppableThread`` under threads, and ``run_async``
    (the port's workers spawned, JAX's forked): the same counts, the same
    worker outputs, the same warning on an abnormal exit."""
    from test_torch_actor_learner_threads import _exit_with, _touch

    from pfrl_tpu.utils import async_ as jasync
    from pfrl_tpu.utils import stoppable_thread as jthread
    from pfrl_tpu_torch.utils import async_ as tasync
    from pfrl_tpu_torch.utils import stoppable_thread as tthread

    got = {}
    for name, threads, runner in (("port", tthread, tasync), ("jax", jthread, jasync)):
        counter = threads.Counter(3)
        workers = [threading.Thread(target=lambda: [counter.increment(2) for _ in range(500)]) for _ in range(4)]
        stop = threading.Event()
        stoppable = threads.StoppableThread(stop_event=stop, target=stop.wait, daemon=True)
        stoppable.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join(10)
        stoppable.stop()
        stoppable.join(10)
        outdir = tmp_path / name
        outdir.mkdir()
        with time_limit(120):
            runner.run_async(2, functools.partial(_touch, str(outdir)))
            with pytest.warns(runner.AbnormalExitWarning, match="exited with code 5"):
                runner.run_async(2, functools.partial(_exit_with, 5))
        got[name] = (counter.value, counter.increment(), stoppable.is_stopped(), stoppable.is_alive(),
                     sorted(os.listdir(outdir)))
    assert got["port"] == got["jax"] == (4003, 4004, True, False, ["worker0", "worker1"])


# ------------------------------------------------------------ the A3C recipe
ITERATIONS = 3


def _run_jax_a3c(monkeypatch, jcore, jtrain, draws, rollout_len):
    install_scripted_keys(monkeypatch)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, minval, maxval, dtype=jnp.int32: key.astype(dtype))
    jenv = jenvs.AtariSim(n_actions=6, mean_episode_len=EPISODE)
    jrunner = JaxOnPolicyRunner(jenv, jcore, LANES, rollout_len)
    env_states, obs = VectorJaxEnv(jenv, LANES).reset(_reset_keys(draws))
    acts, envs = [], []
    for _ in range(ITERATIONS * rollout_len):
        acts.append(draws.take("uniform")[0].reshape(LANES, 6))
        reset = np.asarray(_reset_keys(draws))
        envs.append(np.concatenate([np.zeros_like(reset), reset]))
    assert not draws.log
    key = ScriptedKey(step=jnp.int32(0), iteration=jnp.int32(0), act=jnp.asarray(np.stack(acts)),
                      env=jnp.asarray(np.stack(envs)), update=jnp.zeros((ITERATIONS, 1)))
    state = JaxOnPolicyState(
        env_states=env_states, obs=obs, train_state=jtrain, rng=key, t=jnp.int32(0),
        episode_return=jnp.zeros(LANES), recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0),
    )
    return jrunner.run_iterations(jax.tree.map(lambda x: jnp.array(x, copy=True), state), ITERATIONS)


def test_a3c_recipe_matches_the_jax_runner_over_three_iterations(monkeypatch):
    example = load_example("examples/atari/reproduction/a3c/train_a3c.py")
    optimizer = optax.chain(optax.clip_by_global_norm(40.0), optax.rmsprop(7e-4, decay=0.99, eps=1e-1))
    jcore = JaxA3CCore(model=example.A3CNet(n_actions=6), optimizer=optimizer, gamma=0.99, entropy_coeff=1e-2,
                       v_loss_coef=0.5)
    env = tenvs.AtariSim(n_actions=6, mean_episode_len=EPISODE, device="cpu")
    runner = make_a3c_atarisim_runner(num_envs=LANES, rollout_len=5, env=env)
    assert isinstance(runner.core, A3CCore) and isinstance(runner.core.model, A3CNet)
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, 84, 84, 4), jnp.uint8))
    draws = PermutingTape(0)
    state = runner.init(0, draws=draws)
    state.train_state = convert.ppo_state_from_flax(runner.core, np_tree(jtrain), device="cpu")
    state, aux = runner.run_iterations(state, ITERATIONS)
    jstate, jaux = _run_jax_a3c(monkeypatch, jcore, jtrain, draws, runner.rollout_len)
    assert state.t == int(jstate.t) == ITERATIONS * LANES * runner.rollout_len
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(jstate.obs))
    assert int(state.recent_count) == int(jstate.recent_count) > 0
    assert set(aux) == set(jaux)
    for name, got in aux.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(jaux[name]), rtol=1e-4, atol=1e-6, err_msg=name)
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates) == ITERATIONS
    assert_network(ts.model, jts.params, 2e-5, "a3c")
    # The chain's RMSprop moments (optax's clip state is empty).
    assert ts.opt_state is not None and len(jax.tree.leaves(jts.opt_state[0])) == 0

