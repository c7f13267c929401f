"""The port's actor-learner path under threads, port side only (this module
imports no JAX; ``test_torch_actor_learner.py`` holds the same modules
against the JAX package's).

Case by case the JAX package's ``tests/agents_tests/test_actor_learner.py``
(the DQN, DoubleDQN, CategoricalDQN and IQN shells trained through
``train_agent_async``; the server's routing, errors, row batching and
concurrent submission under publications) and
``tests/experiments_tests/test_train_agent_async.py`` (both modes and the
exception path), plus what the port adds:

- the server pads every batch to ``n_slots`` rows with its first row, a
  request of the other ``training`` flag or one that would overflow starts
  the next batch, ``stop`` fails what is queued, and a server thread that
  dies fails its waiters;
- the acting copy (ROADMAP C51, C61): actors that act while the learner
  changes the online network in place, slowly and parameter by parameter,
  see only whole published weights; acting from the live network fails
  the same check;
- a failing learner, poller, server or actor thread fails the run
  (``atari_dqn_batch.run_actor_learner`` raises it after the join);
- ``StoppableThread``, ``Counter`` under threads, ``run_async`` over spawned
  workers, ``AsyncEvaluator``'s schedule-once and best-save-once under
  threads, and that the new entry points raise without a card unless
  given ``device="cpu"``.

Each threaded test runs under a ``time_limit`` of its own (SIGALRM), and
its threads are daemons or are stopped in a ``finally``.
"""

import contextlib
import functools
import os
import queue
import signal
import threading
import time
import warnings
from unittest import mock

import numpy as np
import pytest
import torch

from pfrl_tpu_torch import agents as tagents
from pfrl_tpu_torch.agents.state_q_function_actor import StateQFunctionActor, VectorStateQFunctionActor
from pfrl_tpu_torch.envs import ABC, HostTorchEnv, synthetic_ale
from pfrl_tpu_torch.experiments import AsyncEvaluator, atari_a3c, atari_dqn_batch, train_agent_async
from pfrl_tpu_torch.experiments.cartpole_value import ReLUMLP
from pfrl_tpu_torch.explorers import ConstantEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.parallel.inference_server import BatchedInferenceServer
from pfrl_tpu_torch.q_functions import (
    DistributionalFCStateQFunctionWithDiscreteAction,
    FCStateQFunctionWithDiscreteAction,
    ImplicitQuantileQFunction,
)
from pfrl_tpu_torch.replay import ReplayBuffer
from pfrl_tpu_torch.utils.async_ import AbnormalExitWarning, run_async
from pfrl_tpu_torch.utils.stoppable_thread import Counter, StoppableThread

torch.set_num_threads(1)


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raises ``TimeoutError`` in the test after ``seconds`` (SIGALRM; the
    tests run in the main thread, xdist's workers included)."""
    def on_alarm(signum, frame):
        raise TimeoutError(f"the test ran over its {seconds} s")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def _join_all(threads, seconds=10.0):
    for t in threads:
        t.join(seconds)
    assert not any(t.is_alive() for t in threads)


# ------------------------------------------------------------ thread helpers
def test_stoppable_thread_stops_on_its_event_and_counter_counts_under_threads():
    with time_limit(30):
        stop = threading.Event()
        ticks = Counter()
        thread = StoppableThread(stop_event=stop, target=lambda: [ticks.increment() for _ in iter(
            lambda: stop.wait(0.001), True)], daemon=True)
        thread.start()
        assert not thread.is_stopped()
        thread.stop()
        thread.join(5)
        assert thread.is_stopped() and not thread.is_alive() and ticks.value >= 0
        counter = Counter(5)
        workers = [threading.Thread(target=lambda: [counter.increment(2) for _ in range(1000)]) for _ in range(8)]
        for w in workers:
            w.start()
        _join_all(workers)
        assert counter.value == 5 + 8 * 1000 * 2
        assert counter.increment() == 5 + 16_001


def _touch(outdir, i):
    open(os.path.join(outdir, f"worker{i}"), "w").close()


def _exit_with(code, i):
    os._exit(code if i == 1 else 0)


def test_run_async_spawns_workers_and_warns_of_an_abnormal_exit(tmp_path):
    with time_limit(120):
        run_async(2, functools.partial(_touch, str(tmp_path)))
        assert sorted(os.listdir(tmp_path)) == ["worker0", "worker1"]
        with pytest.warns(AbnormalExitWarning, match="exited with code 3"):
            run_async(2, functools.partial(_exit_with, 3))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            run_async(1, functools.partial(_exit_with, 3))  # worker 0 exits with 0


# ------------------------------------------------------------ the server
def _started(act_fn, n_slots, **kw):
    server = BatchedInferenceServer(act_fn, n_slots=n_slots, **kw)
    server.start()
    return server


def test_batched_inference_server_routes_actions():
    """Requests from many threads come back to the right caller."""
    with time_limit(30):
        server = _started(lambda seed, obs, t, training: obs[:, 0], 4)
        results = {}

        def worker(i):
            results[i] = server.submit(np.asarray([float(i), 0.0]), True)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        _join_all(threads)
        server.stop()
        for i in range(8):
            assert results[i] == pytest.approx(float(i))


def test_batched_inference_server_propagates_errors():
    def act_fn(seed, obs, t, training):
        raise RuntimeError("boom")

    with time_limit(30):
        server = _started(act_fn, 2)
        with pytest.raises(RuntimeError, match="boom"):
            server.submit(np.zeros(2), True)
        server.stop()


def test_batched_inference_server_row_batched_requests():
    """Vector actors submit K rows per request; the server concatenates
    across requests up to n_slots and routes each slice back."""
    with time_limit(30):
        server = _started(lambda seed, obs, t, training: obs[:, 0], 8)
        results = {}

        def worker(i):
            obs = np.stack([[float(i * 4 + j), 0.0] for j in range(4)])
            results[i] = server.submit_batch(obs, True)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        _join_all(threads)
        server.stop()
        for i in range(4):
            np.testing.assert_allclose(results[i], [float(i * 4 + j) for j in range(4)])


def test_inference_server_concurrent_submission_under_snapshot_swaps():
    """Actor threads submit row-batches while a 'learner' thread swaps the
    published snapshot: every reply is routed to its caller, computed
    against one snapshot (no torn batch), and each actor's snapshots never
    go backwards."""
    published = {"v": 0}
    stop = threading.Event()

    def act_fn(seed, obs, t, training):
        v = published["v"]
        time.sleep(0.0005)
        return np.asarray([v * 1000 + int(o[0]) for o in obs])

    def swapper():
        while not stop.is_set():
            published["v"] += 1
            time.sleep(0.0002)

    with time_limit(60):
        server = _started(act_fn, 8)
        learner = threading.Thread(target=swapper, daemon=True)
        learner.start()
        errors = []

        def actor_loop(i):
            last_v = -1
            try:
                for _ in range(50):
                    out = server.submit_batch(np.stack([[float(i * 2 + j), 0.0] for j in range(2)]), True)
                    vs = {int(a) // 1000 for a in out}
                    assert len(vs) == 1, f"torn batch: {out}"
                    v = vs.pop()
                    assert v >= last_v, "snapshot went backwards"
                    last_v = v
                    assert [int(a) % 1000 for a in out] == [i * 2, i * 2 + 1], f"misrouted: {out}"
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=actor_loop, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        _join_all(threads, 30)
        stop.set()
        learner.join()
        server.stop()
        assert not errors, errors


def test_server_pads_to_n_slots_and_splits_batches_by_flag_and_width():
    """Each forward sees ``n_slots`` rows: the requests' rows, then copies
    of the first row. A request of the other ``training`` flag, or one
    that would overflow the width, waits for the next batch."""
    seen = []
    gate = threading.Event()

    def act_fn(seed, obs, t, training):
        gate.wait(5)
        seen.append((seed, obs.copy(), t, training))
        return obs[:, 0]

    with time_limit(30):
        server = _started(act_fn, 8, t_fn=lambda: 42, timeout=0.2)
        results = {}

        def submit(name, rows, training):
            results[name] = server.submit_batch(rows, training)

        requests = [("a", np.arange(3, dtype=np.float32)[:, None] + [0, 0.5], True),
                    ("b", np.arange(10, 13, dtype=np.float32)[:, None] + [0, 0.5], False),
                    ("c", np.arange(20, 26, dtype=np.float32)[:, None] + [0, 0.5], True)]
        threads = []
        for name, rows, training in requests:
            threads.append(threading.Thread(target=submit, args=(name, rows, training)))
            threads[-1].start()
            time.sleep(0.05)  # queued in this order inside the first window
        gate.set()
        _join_all(threads)
        server.stop()
    assert [s[0] for s in seen] == [1, 2, 3] and all(s[2] == 42 for s in seen)
    assert [s[3] for s in seen] == [True, False, True]
    for (_, obs, _, _), (name, rows, _) in zip(seen, requests):
        assert obs.shape == (8, 2)
        np.testing.assert_array_equal(obs[: len(rows)], rows)
        np.testing.assert_array_equal(obs[len(rows):], np.broadcast_to(rows[:1], (8 - len(rows), 2)))
        np.testing.assert_array_equal(results[name], rows[:, 0])
    assert server.batch_rows == [3, 3, 6] and len(server.round_trips) == 3


def test_server_merges_requests_and_starts_a_new_batch_on_overflow():
    seen = []
    gate = threading.Event()

    def act_fn(seed, obs, t, training):
        gate.wait(5)
        seen.append(obs[:, 0].copy())
        return obs[:, 0]

    with time_limit(30):
        server = _started(act_fn, 4, timeout=0.3)
        threads = []
        for i, n in enumerate((1, 2, 2)):  # 1 + 2 fit; the third would overflow
            rows = np.full((n, 1), float(i), np.float32)
            threads.append(threading.Thread(target=server.submit_batch, args=(rows, True)))
            threads[-1].start()
            time.sleep(0.05)
        gate.set()
        _join_all(threads)
        server.stop()
    np.testing.assert_array_equal(seen[0], [0, 1, 1, 0])
    np.testing.assert_array_equal(seen[1], [2, 2, 2, 2])
    assert server.batch_rows == [3, 2]


def test_server_takes_tensors_and_structured_observations():
    def act_fn(seed, obs, t, training):
        frames, extra = obs
        assert isinstance(frames, torch.Tensor) and frames.shape == (4, 3) and extra.shape == (4,)
        return frames[:, 0] + torch.as_tensor(extra)

    with time_limit(30):
        server = _started(act_fn, 4)
        out = server.submit_batch((torch.ones(2, 3), np.asarray([1.0, 2.0])), True)
        server.stop()
    np.testing.assert_array_equal(out, [2.0, 3.0])
    assert isinstance(out, np.ndarray)


def test_server_refuses_bad_requests():
    server = BatchedInferenceServer(lambda *a: None, n_slots=2)
    with pytest.raises(ValueError, match="one shared leading dimension"):
        server.submit_batch((np.zeros((2, 3)), np.zeros((3, 3))), True)
    with pytest.raises(ValueError, match="one shared leading dimension"):
        server.submit_batch(np.float32(1.0), True)
    with pytest.raises(ValueError, match="exceeds the server's batch width"):
        server.submit_batch(np.zeros((3, 1)), True)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_stop_fails_what_is_queued_and_a_dying_server_fails_its_waiters():
    with time_limit(30):
        server = BatchedInferenceServer(lambda *a: np.zeros(1), n_slots=1)  # never started
        errors = []

        def submit():
            try:
                server.submit(np.zeros(1), True)
            except RuntimeError as e:
                errors.append(e)

        waiter = threading.Thread(target=submit)
        waiter.start()
        time.sleep(0.1)
        server._thread = threading.Thread(target=server._serve)
        server._stop.set()
        server._thread.start()
        server.stop()
        waiter.join(5)
        assert [str(e) for e in errors] == ["inference server stopped"]

        def dies(seed, obs, t, training):
            raise SystemExit("the server thread ends")  # not an Exception: the loop itself ends

        server = _started(dies, 1)
        with pytest.raises(RuntimeError, match="inference server stopped"):
            server.submit(np.zeros(1), True)
        server._thread.join(5)
        assert not server._thread.is_alive()
        with pytest.raises(RuntimeError, match="inference server stopped"):
            server.submit(np.zeros(1), True)  # queued after the death: nobody serves it
        server.stop()


# ------------------------------------------------------------ the actors
def test_actors_ship_transitions_and_delegate_to_the_learner():
    inference = mock.Mock()
    inference.submit.side_effect = lambda obs, training: np.int64(obs[0] > 0)
    inference.submit_batch.side_effect = lambda obs, training: (obs[:, 0] > 0).astype(np.int64)
    learner = mock.Mock()
    learner.get_statistics.return_value = [("n_updates", 3)]
    q = queue.Queue()
    actor = StateQFunctionActor(inference, q, 2, learner_agent=learner)
    assert actor.act(np.asarray([1.0, 0.0])) == 1
    actor.observe(np.asarray([2.0, 0.0]), 0.5, False, True)
    actor_id, data = q.get_nowait()
    assert actor_id == 2 and actor.t == 1
    assert data["action"] == 1 and data["reward"] == np.float32(0.5) and data["reward"].dtype == np.float32
    assert data["done"] is True and data["terminated"] is False
    np.testing.assert_array_equal(data["obs"], [1.0, 0.0])
    np.testing.assert_array_equal(data["next_obs"], [2.0, 0.0])
    with actor.eval_mode():
        actor.act(np.zeros(2))
        actor.observe(np.zeros(2), 1.0, True, False)
    assert q.empty() and inference.submit.call_args[0][1] is False
    actor.save("d")
    actor.load("e")
    assert actor.get_statistics() == [("n_updates", 3)]
    learner.save.assert_called_once_with("d")
    learner.load.assert_called_once_with("e")
    assert StateQFunctionActor(inference, q, 0).get_statistics() == []

    vector = VectorStateQFunctionActor(inference, q, 1, 3, learner_agent=learner)
    with pytest.raises(TypeError, match="batch_act"):
        vector.act(np.zeros(2))
    with pytest.raises(TypeError, match="batch_observe"):
        vector.observe(np.zeros(2), 0.0, False, False)
    obs = [np.asarray([float(i) - 1, 0.0]) for i in range(3)]
    np.testing.assert_array_equal(vector.batch_act(obs), [0, 0, 1])
    vector.batch_observe(obs, [1, 2, 3], [True, False, False], [False, True, False])
    actor_id, data = q.get_nowait()
    assert actor_id == 1 and vector.t == 3 and data["reward"].dtype == np.float32
    np.testing.assert_array_equal(data["done"], [True, True, False])
    np.testing.assert_array_equal(data["terminated"], [True, False, False])
    assert data["obs"].shape == data["next_obs"].shape == (3, 2)


# ------------------------------------------------------------ AsyncEvaluator
def test_async_evaluator_evaluates_once_per_interval_and_saves_each_best_once(tmp_path):
    """Eight threads cross the same evaluation points: each point is
    evaluated by one of them, and each new best score is saved by one."""
    scores = iter([1.0, 3.0, 2.0, 5.0, 5.0, 4.0] * 4)
    lock = threading.Lock()

    def fake_eval(env, agent, n_steps, n_episodes, max_episode_len=None, logger=None):
        with lock:
            mean = next(scores)
        time.sleep(0.01)
        return {"mean": mean, "median": mean, "stdev": 0.0, "max": mean, "min": mean, "episodes": 1}

    hook = mock.Mock()
    evaluator = AsyncEvaluator(n_steps=None, n_episodes=1, eval_interval=10, outdir=str(tmp_path),
                               evaluation_hooks=[hook])
    agent = mock.Mock()
    agent.get_statistics.return_value = [("average_q", 0.5)]
    saved = []
    agent.save.side_effect = lambda dirname: saved.append(evaluator._max_score)
    counter = Counter()
    returned = []
    with time_limit(60), mock.patch("pfrl_tpu_torch.experiments.evaluator.eval_performance", fake_eval):
        def actor():
            for _ in range(15):
                t = counter.increment()
                out = evaluator.evaluate_if_necessary(t=t, episodes=0, env=None, agent=agent)
                if out is not None:
                    returned.append(out)

        threads = [threading.Thread(target=actor) for _ in range(8)]
        for t in threads:
            t.start()
        _join_all(threads)
    assert counter.value == 120 and len(returned) == 12 and hook.call_count == 12
    assert sorted(returned) == sorted([1.0, 3.0, 2.0, 5.0, 5.0, 4.0] * 2)
    # Each new best is saved once, in increasing order (evaluations finish
    # in any order; the second 5.0 is no new best).
    assert saved == sorted(set(saved)) and saved[-1] == evaluator.max_score == 5.0
    assert all(call.args == (str(tmp_path / "best"),) for call in agent.save.call_args_list)
    lines = open(tmp_path / "scores.txt").read().splitlines()
    assert lines[0].split("\t") == ["steps", "episodes", "elapsed", "mean", "median", "stdev", "max", "min",
                                    "average_q"]
    assert len(lines) == 13


# ------------------------------------------------------------ train_agent_async
class ScriptedEnv:
    observation_space = None
    action_space = None

    def __init__(self, ep_len=4, fail_at=None):
        self.ep_len = ep_len
        self.fail_at = fail_at
        self.t = 0
        self.episode_t = 0

    def reset(self):
        self.episode_t = 0
        return 0.0

    def step(self, action):
        self.t += 1
        if self.t == self.fail_at:
            raise RuntimeError("env step failed")
        self.episode_t += 1
        done = self.episode_t >= self.ep_len
        if done:
            self.episode_t = 0
        return float(self.t), 1.0, done, {}

    def close(self):
        pass


def make_mock_agent():
    agent = mock.Mock()
    agent.act.return_value = 0
    agent.batch_act.side_effect = lambda obss: np.zeros(len(obss), int)
    agent.get_statistics.return_value = []
    agent.process_idx = 0
    return agent


def test_synchronous_mode_trains_and_returns_agent(tmp_path):
    agent = make_mock_agent()
    agent.eval_mode = mock.MagicMock()
    out = train_agent_async(outdir=str(tmp_path), processes=2, make_env=lambda idx, test: ScriptedEnv(), steps=20,
                            eval_interval=10**6, eval_n_steps=None, eval_n_episodes=1, agent=agent)
    assert out is agent
    assert agent.batch_act.call_count >= 10
    assert agent.batch_observe.call_count == agent.batch_act.call_count


def test_actor_learner_mode_requires_make_agent(tmp_path):
    with pytest.raises(AssertionError):
        train_agent_async(outdir=str(tmp_path), processes=1, make_env=lambda idx, test: ScriptedEnv(),
                          stop_event=threading.Event())


def test_exception_event_aborts_actor_learner(tmp_path):
    """A set exception event stops the actor loops promptly (the reference's
    kill-all semantics); process 0 saves its model first."""
    stop, exc = threading.Event(), threading.Event()
    exc.set()
    made = []

    def make_agent(i):
        a = make_mock_agent()
        made.append(a)
        return a

    with time_limit(60):
        train_agent_async(outdir=str(tmp_path), processes=1, make_env=lambda idx, test: ScriptedEnv(), steps=10**6,
                          eval_interval=None, eval_n_steps=None, eval_n_episodes=1, make_agent=make_agent,
                          stop_event=stop, exception_event=exc)
    assert all(a.act.call_count < 10**4 for a in made)
    made[0].save.assert_called_once_with(os.path.join(str(tmp_path), "1_except"))


@pytest.mark.parametrize("where", ["step", "make_env"])
def test_a_failing_actor_fails_the_run_after_every_thread_joined(tmp_path, where):
    stop, exc = threading.Event(), threading.Event()
    made = []

    def make_env(idx, test):
        if where == "make_env" and idx == 1 and test:
            raise RuntimeError("env construction failed")
        return ScriptedEnv(fail_at=30 if where == "step" and idx == 1 and not test else None)

    def make_agent(i):
        made.append(make_mock_agent())
        return made[-1]

    with time_limit(60), pytest.raises(RuntimeError, match="env step failed|env construction failed"):
        train_agent_async(outdir=str(tmp_path), processes=3, make_env=make_env, steps=10**6, eval_interval=None,
                          eval_n_steps=None, eval_n_episodes=1, make_agent=make_agent, stop_event=stop,
                          exception_event=exc)
    assert stop.is_set() and exc.is_set()
    assert not any(t.name.startswith("actor-") for t in threading.enumerate())


def test_actor_learner_mode_counts_steps_and_saves_the_finished_agent(tmp_path):
    stop = threading.Event()
    made = []
    hook = mock.Mock()

    def make_agent(i):
        made.append(make_mock_agent())
        return made[-1]

    with time_limit(60):
        train_agent_async(outdir=str(tmp_path), processes=2, make_env=lambda idx, test: ScriptedEnv(), steps=40,
                          eval_interval=None, eval_n_steps=None, eval_n_episodes=1, make_agent=make_agent,
                          stop_event=stop, global_step_hooks=[hook])
    assert stop.is_set() and hook.call_count == sum(a.observe.call_count for a in made)
    assert 40 <= hook.call_count <= 41  # each thread may finish one step past ``steps``
    assert sorted(c.args[2] for c in hook.call_args_list) == list(range(1, hook.call_count + 1))
    assert any(c.args == (os.path.join(str(tmp_path), "40_finish"),) for a in made for c in a.save.call_args_list)


# ------------------------------------------------------------ the DQN family
def _fc():
    return FCStateQFunctionWithDiscreteAction(4, 2, 1, 16)


def _c51():
    return DistributionalFCStateQFunctionWithDiscreteAction(4, 2, 17, -1.0, 2.0, 1, 16)


def _iqn():
    return ImplicitQuantileQFunction(ReLUMLP(4, 16, 16), 16, 2, n_basis_functions=16)


AGENT_FAMILY = [("dqn", "DQN", _fc), ("double_dqn", "DoubleDQN", _fc), ("categorical_dqn", "CategoricalDQN", _c51),
                ("iqn", "IQN", _iqn)]


def make_agent(cls_name="DQN", qf=_fc, **buffer_kw):
    return getattr(tagents, cls_name)(
        q_function=qf(), optimizer=Adam(1e-2), replay_buffer=ReplayBuffer(256, num_lanes=2, device="cpu", **buffer_kw),
        gamma=0.9, explorer=ConstantEpsilonGreedy(0.3, 2), replay_start_size=8, minibatch_size=4, update_interval=1,
        target_update_interval=16, device="cpu")


def abc_env(process_idx, test):
    return HostTorchEnv(ABC(discrete=True, episodic=True, device="cpu"), seed=process_idx + (100 if test else 0))


@contextlib.contextmanager
def started(agent, **kw):
    """``setup_actor_learner_training(**kw)`` with the poller and learner
    started (as daemons), stopped and joined on the way out."""
    make_actor, learner, poller, exception_event = agent.setup_actor_learner_training(**kw)
    learner.daemon = poller.daemon = True
    poller.start()
    learner.start()
    try:
        yield make_actor, learner, poller, exception_event
    finally:
        learner.stop()
        learner.join(10)
        poller.stop()
        poller.join(10)
        assert not learner.is_alive() and not poller.is_alive()


@pytest.mark.parametrize("name,cls_name,qf", AGENT_FAMILY, ids=[a[0] for a in AGENT_FAMILY])
def test_actor_learner_training_fast(tmp_path, name, cls_name, qf):
    steps = 60
    agent = make_agent(cls_name, qf)
    assert agent.cumulative_steps == 0
    step_hook, optimizer_step_hook = mock.Mock(), mock.Mock()
    with time_limit(120), started(agent, n_actors=2, step_hooks=[step_hook],
                                  optimizer_step_hooks=[optimizer_step_hook]) as (make_actor, learner, _, exc):
        train_agent_async(outdir=str(tmp_path), processes=2, make_env=abc_env, steps=steps, eval_interval=30,
                          eval_n_steps=None, eval_n_episodes=2, make_agent=make_actor, stop_event=learner.stop_event,
                          exception_event=exc)
    assert not exc.is_set() and not agent.actor_learner_errors
    assert type(agent.core).__name__ == f"{cls_name}Core"
    assert 0 < agent.cumulative_steps <= steps + 2
    assert optimizer_step_hook.call_count == step_hook.call_count == agent.optim_t
    for i, call in enumerate(step_hook.call_args_list):
        assert call.args[0] is None and call.args[1] is agent and call.args[2] == (i + 1) * agent.update_interval
    for i, call in enumerate(optimizer_step_hook.call_args_list):
        assert call.args[2] == i + 1
    assert os.path.exists(tmp_path / f"{steps}_finish") or os.path.exists(tmp_path / "successful")
    assert os.path.exists(tmp_path / "scores.txt")
    assert agent.buffer.num_lanes == 2


def test_actor_learner_updates_happen(tmp_path):
    """With ``n_updates`` the learner ends the run after exactly that many
    updates and has published to the actors."""
    agent = make_agent()
    with time_limit(120), started(agent, n_actors=2, actor_update_interval=2, n_updates=3) as (
            make_actor, learner, _, exc):
        train_agent_async(outdir=str(tmp_path), processes=2, make_env=abc_env, steps=100000, eval_interval=None,
                          eval_n_steps=None, eval_n_episodes=2, make_agent=make_actor, stop_event=learner.stop_event,
                          exception_event=exc)
    assert not exc.is_set()
    assert agent.optim_t == 3 and agent.update_counter.value == 1
    assert agent.t == 3 * agent.update_interval and agent._acting is not None


def test_vector_actor_learner_training():
    """``lanes_per_actor`` K > 1: vector actors drive K lanes per thread, the
    poller concatenates their rows, and the learner updates from the
    ``n_actors * K``-lane ring (``store_next_obs=False``: the poller uploads
    no ``next_obs``)."""
    K = 3
    agent = make_agent(store_next_obs=False)
    stop = threading.Event()
    rows = []
    to_transition = agent._rows_to_transition

    def recording(parts):
        rows.append(to_transition(parts))
        return rows[-1]

    agent._rows_to_transition = recording
    with time_limit(120), started(agent, n_actors=2, lanes_per_actor=K, inference_slots=K, n_updates=2) as (
            make_actor, learner, _, exc):
        def actor_loop(i):
            envs = [abc_env(i * K + j, False) for j in range(K)]
            actor = make_actor(i)
            obs = [e.reset() for e in envs]
            while not (stop.is_set() or learner.stop_event.is_set()):
                actions = actor.batch_act(obs)
                nxt, rs, ds, rsts = [], [], [], []
                for e, a in zip(envs, actions):
                    o2, r, d, info = e.step(int(a))
                    nxt.append(o2)
                    rs.append(r)
                    ds.append(d)
                    rsts.append(info.get("needs_reset", False))
                actor.batch_observe(nxt, rs, ds, rsts)
                obs = [envs[j].reset() if ds[j] else nxt[j] for j in range(K)]

        threads = [threading.Thread(target=actor_loop, args=(i,), daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while not learner.stop_event.is_set() and time.time() < deadline:
            time.sleep(0.05)
        stop.set()
        _join_all(threads)
    assert not exc.is_set()
    assert agent.optim_t == 2 and agent.cumulative_steps >= 8
    assert agent.buffer.num_lanes == 2 * K
    assert rows and all(tr.next_obs is None and tr.obs.shape == (2 * K, 4) for tr in rows)
    assert agent._inference.batch_rows and max(agent._inference.batch_rows) <= K


# ------------------------------------------------------------ the acting copy
@pytest.mark.parametrize("live", [False, True], ids=["acting copy", "live network (must fail)"])
def test_acts_during_in_place_updates_see_only_whole_published_weights(live):
    """The learner changes the online network in place, one parameter at a
    time with a sleep between (every update adds exactly 1 to every
    weight), while two actor threads hammer the server. Each act records
    the weights it used: with the acting copy, every act sees one whole
    published version: 0, 1, 2 or 3 (refreshed after every update before
    the first publication) or a multiple of ``actor_update_interval``.
    Acting from the live network (the port's net with JAX's pointer
    semantics) sees torn weights: the check detects it."""
    agent = make_agent()
    agent._ensure_init(torch.zeros((1, 4)))
    start = [p.detach().clone() for p in agent.train_state.model.parameters()]

    @torch.no_grad()
    def slow_update(params, grads, state):
        for p in params:
            p.add_(1.0)
            time.sleep(0.002)

    agent.core.optimizer.update = slow_update
    if live:
        agent._make_acting_copy = lambda: setattr(agent, "_acting", agent.train_state)
        agent._publish = lambda: None
    versions = []
    select_action = agent.core.select_action

    def recording_select_action(state, draws, obs, t, training):
        versions.append(tuple(round(float((p - s).flatten()[0])) for p, s in zip(state.model.parameters(), start)))
        return select_action(state, draws, obs, t, training)

    agent.core.select_action = recording_select_action
    rs = np.random.RandomState(0)
    hammering = threading.Event()
    with time_limit(120), started(agent, n_actors=2, actor_update_interval=4, n_updates=40) as (
            make_actor, learner, _, exc):
        server, transitions = agent._inference, make_actor(0).transition_queue

        def hammer():
            obs = rs.normal(size=(1, 4)).astype(np.float32)
            while not learner.stop_event.is_set():
                server.submit_batch(obs, True)
                hammering.set()

        hammers = [threading.Thread(target=hammer, daemon=True) for _ in range(2)]
        for h in hammers:
            h.start()
        hammering.wait(10)
        for _ in range(40):  # rows of both lanes, straight onto the poller's queue
            for actor_id in range(2):
                transitions.put((actor_id, dict(
                    obs=rs.normal(size=4).astype(np.float32), action=np.int64(rs.randint(2)),
                    reward=np.float32(rs.normal()), next_obs=rs.normal(size=4).astype(np.float32),
                    terminated=False, done=False)))
        deadline = time.time() + 60
        while not learner.stop_event.is_set() and time.time() < deadline:
            time.sleep(0.01)
        _join_all(hammers)
    assert not exc.is_set() and agent.optim_t == 40
    torn = [v for v in versions if len(set(v)) > 1]
    seen = {v[0] for v in versions if len(set(v)) == 1}
    if live:
        assert torn, "acting from the live network went undetected"
        return
    assert not torn, torn[:5]
    assert seen <= {0, 1, 2, 3} | set(range(0, 41, 4)) and max(seen) >= 8, sorted(seen)


# ------------------------------------------------------------ the recipe
RECIPE_KW = dict(capacity=2_000, replay_start_size=200, target_update_interval=40)


def test_run_actor_learner_trains_the_example_small_and_evaluates(tmp_path):
    """``train_dqn_batch_ale.py --actor-learner`` at its widths (NatureQ on
    84x84x4 frames of ``SyntheticALE``), four actors, a ring of 2,000
    slots, on the CPU: the run ends at its steps with one evaluation."""
    with time_limit(300):
        agent = atari_dqn_batch.run_actor_learner(str(tmp_path), steps=600, eval_interval=500, eval_n_episodes=1,
                                                  num_envs=4, device="cpu", make_env=synthetic_ale.make_ale_env,
                                                  **RECIPE_KW)
    # The poller stops with what it has drained: the actors' last steps may
    # still be queued.
    assert 200 < agent.cumulative_steps <= 604 and agent.optim_t > 0 and agent.update_counter.value >= 1
    assert agent.buffer.num_lanes == 4 and agent.buffer.capacity == 2_000 and not agent.buffer.wants_next_obs
    assert agent._inference.batch_rows and max(agent._inference.batch_rows) <= 4
    rows = open(tmp_path / "scores.txt").read().splitlines()
    assert len(rows) == 2 and (tmp_path / "600_finish").is_dir()
    assert all(np.isfinite(v) for _, v in agent.get_statistics())


@pytest.mark.parametrize("where", ["learner", "poller", "server"])
def test_a_failing_thread_fails_run_actor_learner(tmp_path, where):
    agent = atari_dqn_batch.make_dqn_batch_agent(num_envs=2, device="cpu", **RECIPE_KW)
    boom = RuntimeError(f"{where} failed")

    def fail(*args, **kwargs):
        raise boom

    target = {"learner": "_update_once", "poller": "_rows_to_transition", "server": "_actor_act_fn"}[where]
    setattr(agent, target, fail)
    with time_limit(300), pytest.raises(RuntimeError, match=f"{where} failed"):
        atari_dqn_batch.run_actor_learner(str(tmp_path), steps=10**6, eval_interval=None, num_envs=2, agent=agent,
                                          make_env=synthetic_ale.make_ale_env)
    assert not any(t.name in ("learner", "poller", "inference-server") and t.is_alive() for t in threading.enumerate())


def test_new_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        atari_dqn_batch.run_actor_learner(str(tmp_path), steps=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        atari_a3c.make_a3c_atarisim_runner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tagents.A3C(atari_a3c.A3CNet(6), Adam(1e-3), 0.99, 2)
