"""The port's Atari actor-learner pipeline run end to end on the CPU
(``pfrl_tpu_torch/parallel/atari_pipeline.py``): spawned actor processes
over shared memory, the io, server, committer and learner threads, a tiny
Q-net, 2 workers x 4 lanes. This module imports no JAX, so the actor
processes, which import it to unpickle :func:`make_fake_env`, never load
JAX either.

Every test that spawns processes runs under :func:`time_limit` (at most
120 s), and every wait in it has a deadline of its own.
"""

import contextlib
import copy
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.experiments.atari_per_dqn import Dense
from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.parallel.atari_pipeline import AtariActorLearnerPipeline
from pfrl_tpu_torch.q_functions.state_q_functions import DiscreteActionValueHead
from pfrl_tpu_torch.utils.batch_states import atari_phi
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_ACTIONS = 4


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


class TinyQ(nn.Module):
    """The JAX pipeline test's ``TinyQ``: flatten -> Dense(32) -> ReLU ->
    Dense(n_actions) -> ``DiscreteActionValueHead``; flax scopes
    ``Dense_0`` (hidden) and ``Dense_1`` (output)."""

    def __init__(self, n_actions: int = N_ACTIONS, in_features: int = 84 * 84 * 4, hidden: int = 32):
        super().__init__()
        self.hidden = Dense(in_features, hidden)
        self.out = Dense(hidden, n_actions)
        self.q = DiscreteActionValueHead()
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        self.hidden.reset_parameters(generator)
        self.out.reset_parameters(generator)

    def flax_names(self):
        return {"hidden": "Dense_0", "out": "Dense_1"}

    def forward(self, x, draws=None):
        h = torch.relu(self.hidden(x.reshape(x.shape[0], -1)))
        return self.q(self.out(h))


class FakePlaneEnv:
    """The JAX pipeline test's deterministic [84,84,1] uint8 plane env with
    short episodes."""

    def __init__(self, seed=0, ep_len=9):
        self._seed = seed
        self._ep_len = ep_len
        self._t = 0

    def reset(self, **kwargs):
        self._t = 0
        return self._frame()

    def _frame(self):
        return np.full((84, 84, 1), (self._seed * 31 + self._t) % 251, np.uint8)

    def step(self, action):
        self._t += 1
        return self._frame(), float(action % 2), self._t >= self._ep_len, {}

    def close(self):
        pass


def make_fake_env(seed=0):
    return FakePlaneEnv(seed)


def _exploding_env(seed=0):
    raise RuntimeError("boom")


def make_core(optimizer=None):
    return DQNCore(
        model=TinyQ(),
        optimizer=optimizer or Adam(1e-3),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.1, 10_000, N_ACTIONS),
        gamma=0.9,
        phi=atari_phi,
    )


def make_pipeline(**kw):
    cfg = dict(core=make_core(), env_factory=make_fake_env, n_workers=2, lanes_per_worker=4, capacity=4_096,
               minibatch_size=8, update_interval=4, target_update_interval=64, replay_start_size=128, burst=8,
               slot_ring=3, seed=0, device="cpu")
    cfg.update(kw)
    return AtariActorLearnerPipeline(**cfg)


def _wait(predicate, pipeline, seconds):
    deadline = time.time() + seconds
    while time.time() < deadline and not predicate():
        if pipeline.exception_event.is_set():
            break
        time.sleep(0.1)


# ---------------------------------------------------------------- end to end
def test_pipeline_end_to_end_learns_and_shuts_down():
    with time_limit(120):
        p = make_pipeline()
        p.start()
        try:
            _wait(lambda: p.optim_t >= 32, p, 100)
        finally:
            p.stop()
        assert not p.exception_event.is_set()
        assert p.acted_steps >= p.replay_start_size and p.optim_t >= 32
        stats = dict(p.get_statistics())
        assert np.isfinite(stats["average_loss"]) and stats["n_updates"] == p.optim_t
        # The learner is paced at acted // update_interval, never ahead.
        assert p.optim_t <= p.acted_steps // p.update_interval
        assert p.target_syncs >= 1 and p.train_state.n_updates == p.optim_t
        # Clean shutdown: every thread and every actor process has ended.
        assert not any(t.is_alive() for t in p._threads)
        assert all(w.exitcode is not None for w in p._workers)
        timings = p.timings()
        assert timings["act_round_trip"]["n"] >= p.acted_steps // p.K
        assert timings["burst"]["n"] == p.optim_t // p.burst and timings["worker_startup_s"] > 0
        # The acting copy holds the weights of the last burst.
        for a, b in zip(p._acting.model.parameters(), p.train_state.model.parameters()):
            assert torch.equal(a, b)


def test_pipeline_worker_crash_ends_the_run_without_deadlock():
    with time_limit(90):
        p = make_pipeline(env_factory=_exploding_env)
        p.start()
        try:
            deadline = time.time() + 60
            while time.time() < deadline and (any(w.is_alive() for w in p._workers)
                                              or not p.exception_event.is_set()):
                time.sleep(0.1)
            assert not any(w.is_alive() for w in p._workers)
            # The io thread meets the closed pipes and ends the run.
            assert p.exception_event.is_set() and p._stop.is_set()
        finally:
            t0 = time.time()
            p.stop()
        assert time.time() - t0 < 30
        assert p.acted_steps == 0 and p.optim_t == 0


# ------------------------------------------------------------------- acting
def test_greedy_actions_act_from_the_published_weights():
    p = make_pipeline()
    p._init_device_state(0)
    obs = np.random.RandomState(5).randint(0, 255, (3, 84, 84, 4)).astype(np.uint8)
    a1 = p.greedy_actions(obs)
    assert a1.shape == (3,) and a1.dtype == np.int32
    q = p.train_state.model(atari_phi(torch.from_numpy(obs))).q_values
    np.testing.assert_array_equal(a1, q.argmax(-1).numpy())
    # Weights changed in place are not seen until they are published.
    with torch.no_grad():
        p.train_state.model.out.bias.copy_(torch.arange(N_ACTIONS, dtype=torch.float32) * -1e3)
    np.testing.assert_array_equal(p.greedy_actions(obs), a1)
    p.publish()
    np.testing.assert_array_equal(p.greedy_actions(obs), np.zeros(3, np.int32))


def _fill(p, cursor, seed):
    """Random contents in every row, ``cursor`` rows committed."""
    rows = p.capacity
    rs = np.random.RandomState(seed)
    p.ring.planes[:] = torch.from_numpy(rs.randint(0, 255, (rows, 84 * 84)).astype(np.uint8))
    p.ring.action[:] = torch.from_numpy(rs.randint(0, N_ACTIONS, rows).astype(np.int32))
    p.ring.reward[:] = torch.from_numpy(rs.normal(size=rows).astype(np.float32))
    done = rs.uniform(size=rows) < 0.15
    p.ring.done[:] = torch.from_numpy(done)
    p.ring.terminated[:] = torch.from_numpy(done & (rs.uniform(size=rows) < 0.5))
    p.ring.commit_cursor = cursor


def _state_tensors(ts):
    return ([p.detach().clone() for p in ts.model.parameters()]
            + [p.detach().clone() for p in ts.target_model.parameters()]
            + [x.clone() for x in ts.opt_state.mu + ts.opt_state.nu])


def test_a_burst_is_the_same_when_acting_and_committing_are_hammered_during_it():
    """The snapshot semantics: a burst's ids come from one read of the
    cursor and all its gathers are issued at its start, and the servers act
    from the published copy. Acting and committing more rows than the ring
    holds while the burst's updates run changes neither what the burst
    computes nor the weights an act sees until the burst publishes them."""
    p = make_pipeline(capacity=160, target_update_interval=8, burst=6)
    p._init_device_state(0)
    _fill(p, p.capacity + 3 * p.L, seed=1)  # wrapped once
    initial = copy.deepcopy(p.train_state)
    stack = p.stack.clone()

    # The burst alone, on a copy of the state and the ring.
    alone = copy.deepcopy(initial)
    loss, q, syncs = p.learner_burst(alone, copy.deepcopy(p.ring), Draws(torch.Generator().manual_seed(3)), p.burst)
    assert syncs >= 1

    # The same burst as the learner runs it, while two threads act and commit.
    p.set_train_state(initial)
    before = [x.clone() for x in p._acting.model.parameters()]
    stop, seen, committed = threading.Event(), [], [0]
    rs = np.random.RandomState(9)

    # A commit before the burst reads the cursor is allowed (C51 promises
    # only what comes after that read), so the hammers start once it has.
    cursor_read = threading.Event()

    def gated_burst_batches(*args, batches=p.burst_batches):
        out = batches(*args)
        cursor_read.set()
        return out

    def hammer(worker):
        draws = Draws(torch.Generator().manual_seed(10 + worker))
        assert cursor_read.wait(timeout=60)
        while not stop.is_set():
            planes = torch.from_numpy(rs.randint(0, 255, (p.K, 84 * 84)).astype(np.uint8))
            prev_done = torch.from_numpy(rs.uniform(size=p.K) < 0.3)
            with p._state_lock:
                p.act_stage(p._acting, p.stack, p.ring, planes, prev_done, worker * p.K,
                            p.ring.commit_cursor + p.L + worker * p.K, 10**6, draws)
                seen.append([x.clone() for x in p._acting.model.parameters()])
                if worker == 0:
                    p.commit(p.ring, torch.ones(p.L), torch.zeros(p.L, dtype=torch.bool),
                             torch.ones(p.L, dtype=torch.bool))
                    committed[0] += p.L

    def slow_update(state, batch, draws, update=p.core.update):
        time.sleep(0.05)  # let the hammers in between the updates
        return update(state, batch, draws)

    p.core.update = slow_update
    p.burst_batches = gated_burst_batches
    threads = [threading.Thread(target=hammer, args=(w,)) for w in range(p.n_workers)]
    try:
        for t in threads:
            t.start()
        p._run_burst(Draws(torch.Generator().manual_seed(3)))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        del p.core.update, p.burst_batches
    assert committed[0] >= p.capacity, committed[0]  # every row was overwritten during the burst
    for got, want in zip(_state_tensors(p.train_state), _state_tensors(alone)):
        assert torch.equal(got, want)
    assert p._loss == float(loss) and p._avg_q == float(q) and p.target_syncs == syncs and p.optim_t == p.burst
    # Every act saw the weights from before the burst or, once published,
    # those from after it; never a part of the burst's updates.
    after = list(alone.model.parameters())
    assert not all(torch.equal(a, b) for a, b in zip(after, before))
    kinds = []
    for params in seen:
        if all(torch.equal(a, b) for a, b in zip(params, before)):
            kinds.append("before")
        else:
            assert all(torch.equal(a, b) for a, b in zip(params, after))
            kinds.append("after")
    assert kinds.count("before") >= 2 * p.burst and kinds == sorted(kinds, key=("before", "after").index)
    assert all(torch.equal(a, b) for a, b in zip(p._acting.model.parameters(), after))
    assert not torch.equal(p.stack, stack)  # the hammers did act


# ------------------------------------------------------------- the package
def test_actor_processes_import_no_torch():
    """Unpickling the shipped factories and running the worker's module load
    no torch (and so can never touch the card): ``make_warped``, and
    ``make_atari``'s chain under ``wrap_deepmind`` over the ALE stand-in;
    nor do the host wrappers ``Monitor``, ``video`` and ``VectorFrameStack``."""
    code = (
        "import functools, pickle, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "from pfrl_tpu_torch.envs.synthetic_ale import make_warped\n"
        "from pfrl_tpu_torch.parallel import env_worker\n"
        "env = pickle.loads(pickle.dumps(make_warped))(3)\n"
        "obs = env.reset(); obs, r, d, _ = env.step(1)\n"
        "assert obs.shape == (84, 84, 1) and callable(env_worker._env_worker)\n"
        "from pfrl_tpu_torch.wrappers import atari_wrappers\n"
        "factory = functools.partial(atari_wrappers.make_atari_deepmind, 'torch_ale_standin:ALEStandIn-v0', False, 3)\n"
        "env = pickle.loads(pickle.dumps(factory))()\n"
        "obs = env.reset(); obs, r, d, _ = env.step(1)\n"
        "assert obs.__array__().shape == (84, 84, 4)\n"
        "from pfrl_tpu_torch.wrappers import Monitor, Render, VectorFrameStack, video\n"
        "assert 'torch' not in sys.modules, 'torch was imported'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from pfrl_tpu_torch.experiments.atari_c51 import make_c51_atarisim_runner
    from pfrl_tpu_torch.experiments.atari_dqn_ale import make_dqn_ale_runner
    from pfrl_tpu_torch.experiments.atari_pipeline import make_dqn_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_dqn_pipeline, make_dqn_ale_runner, make_c51_atarisim_runner,
                 lambda: AtariActorLearnerPipeline(make_core(), make_fake_env)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_pipeline_recipe_holds_the_examples_settings():
    from pfrl_tpu_torch.experiments.atari_pipeline import make_dqn_pipeline
    from pfrl_tpu_torch.envs.synthetic_ale import make_warped
    from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
    from pfrl_tpu_torch.optimizers import RMSprop

    p = make_dqn_pipeline(device="cpu")
    assert (p.n_workers, p.K, p.L, p.capacity) == (3, 96, 288, 999_936)
    assert (p.minibatch_size, p.update_interval, p.target_update_interval, p.replay_start_size, p.burst) == (
        32, 4, 10_000, 50_000, 64)
    assert p.env_factory is make_warped and isinstance(p.core.model, NatureQ)
    core = p.core
    assert isinstance(core.optimizer, RMSprop) and core.batch_accumulator == "sum" and core.gamma == 0.99
    assert (core.optimizer.learning_rate, core.optimizer.decay, core.optimizer.eps) == (2.5e-4, 0.95, 1e-2)
    assert core.explorer.end_epsilon == 0.1 and core.explorer.decay_steps == 10**6
    # 999,936 planes of 84x84 uint8: 7.06 GB.
    assert p.capacity * 84 * 84 == 7_055_548_416
