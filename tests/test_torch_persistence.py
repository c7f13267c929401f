"""Persistence in the port, on the CPU: the collections, the persistent
buffers, shell and runner snapshots and resume, ``--load``/``--demo``/
``--save-to``, a JAX shell's save directory, the pipeline's save/load, and
the local zoo. Tolerances are to the bit.

(a) ``collections_``: the same appends, ``maxlen`` and torn writes through
    both packages; a queue written by either resumes in the other, and the
    two write the same bytes.
(b) ``PersistentReplayBuffer`` and ``PersistentEpisodicReplayBuffer``
    restore after ``snapshot_interval`` adds (``tests/test_persistence.py``'s
    check in JAX); ``distributed=True`` raises; ``save_state``/``load_state``
    bring a prioritized ring back bit for bit; loads of another shape or
    dtype, and of a missing file, raise.
(c) A shell snapshot (``t``, ``train_state``, ``replay_state``), as
    ``tests/test_snapshot.py`` checks the JAX one; a ``TrainRun``'s
    ``_finish`` and ``_except`` saves load back.
(d) A runner snapshot: N scan steps, save, M steps, against a fresh runner
    that loads the snapshot and runs the same M: the uniform, prioritized,
    episodic (ACER) and recurrent (DRQN) runners, every tensor and count
    equal, the draw source's state included.
(e) ``--load zoo/dqn/cartpole --demo`` through the port's ``demo_cli`` on
    the recipe's runner prints the line, and the returns, of the JAX
    package's ``run_demo_if_requested`` on the same start states; the
    ``train_dqn_ale.py --sim`` command line saves, loads and demos.
(f) A JAX ``DQN`` shell's ``save`` directory (``train_state.msgpack``)
    loads into the port's shell, before its first act and after it.
(g) The pipeline's ``load`` re-publishes the acting copy: its greedy
    actions become the saved pipeline's, where the stale copy's differ.
(h) ``utils.pretrained_models`` on the repository's ``zoo/``, and
    ``download_model``'s urllib branch with ``urlopen`` replaced.
"""

import contextlib
import dataclasses
import io
import os
import zipfile

import jax
import numpy as np
import optax
import pytest
import torch

from pfrl_tpu_torch.agent import CheckpointMismatchError, to_saved
from pfrl_tpu_torch.agents.snapshot import (
    load_runner_snapshot,
    load_snapshot,
    save_runner_snapshot,
    save_snapshot,
)
from pfrl_tpu_torch.replay import (
    PersistentEpisodicReplayBuffer,
    PersistentReplayBuffer,
    PrioritizedReplayBuffer,
    Transition,
    load_state,
    save_state,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(ROOT, "zoo")


def flat(tree, path="state") -> dict:
    """Every leaf of ``to_saved(tree)`` by its path."""
    tree = to_saved(tree)
    out = {}

    def walk(x, p):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{p}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{p}[{i}]")
        else:
            out[p] = x.clone() if isinstance(x, torch.Tensor) else x

    walk(tree, path)
    return out


def assert_same(a: dict, b: dict) -> int:
    """Equal leaves (tensors by dtype, shape and value); returns how many
    tensors were compared."""
    assert list(a) == list(b)
    n = 0
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
            n += 1
        else:
            assert a[k] == b[k], k
    return n


# --------------------------------------------------------- (a) collections
def _collections():
    from pfrl_tpu import collections_ as jax_collections

    from pfrl_tpu_torch import collections_ as port_collections

    return jax_collections, port_collections


def test_the_collections_alias_is_the_package():
    import pfrl_tpu_torch

    assert pfrl_tpu_torch.collections is pfrl_tpu_torch.collections_


@pytest.mark.parametrize("maxlen", [None, 5])
def test_random_access_queue_matches_jax(maxlen):
    jc, pc = _collections()
    qs = [jc.RandomAccessQueue(range(3), maxlen=maxlen), pc.RandomAccessQueue(range(3), maxlen=maxlen)]
    for q in qs:
        for i in range(8):
            q.append(i)
        q.extend([10, 11])
        q.popleft()
        q[1] = 99
        q[-1] = 77
    a, b = qs
    assert list(a) == list(b) and len(a) == len(b) and [a[i] for i in range(-len(a), len(a))] == list(b) * 2
    import random

    random.seed(0)
    sa = a.sample(3)
    random.seed(0)
    assert b.sample(3) == sa


def _fill(queue_cls, basedir, n, maxlen=None, chunk_items=None):
    q = queue_cls(basedir, maxlen=maxlen)
    if chunk_items:
        q.CHUNK_ITEMS = chunk_items
    for i in range(n):
        q.append({"i": i, "obs": np.full(3, i, np.float32)})
    q.flush()
    q.close()
    return q


def _items(q):
    return [(x["i"], x["obs"].tolist()) for x in (q[i] for i in range(len(q)))]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("maxlen", [None, 7])
def test_persistent_queue_resumes_across_packages(tmp_path, writer, maxlen):
    jc, pc = _collections()
    cls = {"jax": jc.PersistentRandomAccessQueue, "port": pc.PersistentRandomAccessQueue}
    for name in ("jax", "port"):
        _fill(cls[name], str(tmp_path / name), 13, maxlen=maxlen, chunk_items=5)
    for suffix in (".idx", ".data"):  # the same files, byte for byte
        for c in range(3):
            same = [open(tmp_path / name / f"chunk.{c}{suffix}", "rb").read() for name in ("jax", "port")]
            assert same[0] == same[1]
    other = "port" if writer == "jax" else "jax"
    a = cls[writer](str(tmp_path / writer), maxlen=maxlen)
    b = cls[other](str(tmp_path / writer), maxlen=maxlen)
    want = [(i, [float(i)] * 3) for i in range(13)][-(maxlen or 13):]
    assert _items(a) == _items(b) == want
    a.close()
    b.close()


def test_persistent_queue_stops_at_a_torn_write_as_jax_does(tmp_path):
    jc, pc = _collections()
    _fill(pc.PersistentRandomAccessQueue, str(tmp_path), 4)
    data = tmp_path / "chunk.0.data"
    blob = data.read_bytes()
    data.write_bytes(blob[:-5])  # the last record torn
    j = jc.PersistentRandomAccessQueue(str(tmp_path))
    p = pc.PersistentRandomAccessQueue(str(tmp_path))
    assert _items(p) == _items(j) == [(i, [float(i)] * 3) for i in range(3)]
    p.append({"i": 9, "obs": np.zeros(3, np.float32)})  # appends go to a new chunk
    assert len(p) == 4 and os.path.exists(tmp_path / "chunk.1.idx")
    j.close()
    p.close()


# -------------------------------------------------- (b) persistent buffers
def _tr(i, lanes=1, obs_dim=3):
    f = torch.float32
    return Transition(
        obs=torch.full((lanes, obs_dim), float(i), dtype=f), action=torch.full((lanes,), i % 2, dtype=torch.int32),
        reward=torch.full((lanes,), float(i), dtype=f), next_obs=torch.full((lanes, obs_dim), i + 1.0, dtype=f),
        terminated=torch.zeros(lanes, dtype=torch.bool), done=torch.full((lanes,), i % 3 == 2),
    )


def _example(tr):
    return dataclasses.replace(tr, **{k: getattr(tr, k)[0] for k in ("obs", "action", "reward", "next_obs",
                                                                       "terminated", "done")})


def test_persistent_buffer_restores_after_snapshot_interval_adds(tmp_path):
    d = str(tmp_path / "buf")
    buf = PersistentReplayBuffer(d, 16, snapshot_interval=2, num_lanes=1, device="cpu")
    state = buf.init(_example(_tr(0)))
    for i in range(6):
        state = buf.add(state, _tr(i))
    buf2 = PersistentReplayBuffer(d, 16, snapshot_interval=2, num_lanes=1, device="cpu")
    restored = buf2.restore(_example(_tr(0)))
    assert restored is not None and int(restored.cursor) == 6
    assert assert_same(flat(restored), flat(state)) >= 6
    state = buf.add(state, _tr(6))  # one add past the snapshot: not written yet
    assert int(buf2.restore(_example(_tr(0))).cursor) == 6
    buf.checkpoint(state)
    assert int(buf2.restore(_example(_tr(0))).cursor) == 7


def test_persistent_buffer_without_a_snapshot_restores_none(tmp_path):
    buf = PersistentReplayBuffer(str(tmp_path / "empty"), 16, num_lanes=1, device="cpu")
    assert buf.restore(_example(_tr(0))) is None


def test_persistent_episodic_buffer_restores(tmp_path):
    d = str(tmp_path / "ep")
    buf = PersistentEpisodicReplayBuffer(d, 8, 4, snapshot_interval=3, num_lanes=2, store_carries=False, device="cpu")
    state = buf.init(_example(_tr(0, 2)))
    for i in range(7):
        state = buf.add(state, _tr(i, 2))
    restored = PersistentEpisodicReplayBuffer(d, 8, 4, num_lanes=2, store_carries=False, device="cpu").restore(
        _example(_tr(0, 2)))
    want = PersistentEpisodicReplayBuffer(str(tmp_path / "x"), 8, 4, num_lanes=2, store_carries=False, device="cpu")
    ws = want.init(_example(_tr(0, 2)))
    for i in range(6):
        ws = want.add(ws, _tr(i, 2))
    assert int(restored.n_started) == int(ws.n_started) > 0
    assert assert_same(flat(restored), flat(ws)) >= 6


@pytest.mark.parametrize("cls", [PersistentReplayBuffer, PersistentEpisodicReplayBuffer])
def test_distributed_persistence_raises(tmp_path, cls):
    args = (16,) if cls is PersistentReplayBuffer else (8, 4)
    with pytest.raises(NotImplementedError, match="pfrlmn"):
        cls(str(tmp_path), *args, distributed=True, device="cpu")


def _per_state():
    buf = PrioritizedReplayBuffer(64, num_lanes=2, num_steps=3, device="cpu")
    state = buf.init(_example(_tr(0, 2)))
    for i in range(20):
        buf.add(state, _tr(i, 2))
    from pfrl_tpu_torch.utils.draws import Draws

    batch, _ = buf.sample(state, Draws(torch.Generator().manual_seed(0)), 8)
    buf.update_priorities(state, batch.indices, torch.linspace(0.1, 2.0, 8))
    return buf, state


def test_a_prioritized_ring_comes_back_bit_for_bit(tmp_path):
    buf, state = _per_state()
    path = str(tmp_path / "per.pt")
    save_state(state, path)
    assert not [f for f in os.listdir(tmp_path) if f != "per.pt"]  # the temporary file is gone
    template = buf.init(_example(_tr(0, 2)))
    restored = load_state(template, path)
    assert restored is template
    n = assert_same(flat(restored), flat(state))
    assert n >= 8 and int(restored.base.cursor) == 40 and float(restored.max_priority) > 1
    assert restored.beta.dtype == torch.float32 and restored.base.cursor.dtype == torch.int32


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_a_state_of_another_shape_or_dtype_raises(tmp_path, change):
    buf, state = _per_state()
    path = str(tmp_path / "per.pt")
    save_state(state, path)
    other = PrioritizedReplayBuffer(128 if change == "shape" else 64, num_lanes=2, num_steps=3, device="cpu")
    template = other.init(_example(_tr(0, 2)))
    if change == "dtype":
        template.beta = template.beta.double()
    with pytest.raises(CheckpointMismatchError):
        load_state(template, path)


def test_a_missing_snapshot_raises(tmp_path):
    buf, state = _per_state()
    with pytest.raises(FileNotFoundError):
        load_state(state, str(tmp_path / "none.pt"))


# ------------------------------------------------- (c) shell snapshots
def _port_dqn(seed=0):
    from pfrl_tpu_torch.agents import DQN
    from pfrl_tpu_torch.explorers import ConstantEpsilonGreedy
    from pfrl_tpu_torch.optimizers import Adam
    from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction
    from pfrl_tpu_torch.replay import ReplayBuffer

    return DQN(FCStateQFunctionWithDiscreteAction(4, 2, 1, 16), Adam(1e-2), ReplayBuffer(256, gamma=0.9, device="cpu"),
               0.9, ConstantEpsilonGreedy(0.2, 2), replay_start_size=16, minibatch_size=8,
               target_update_interval=50, seed=seed, device="cpu")


def _drive(agent, n, seed):
    rs = np.random.RandomState(seed)
    obs = rs.normal(size=4).astype(np.float32)
    for i in range(n):
        agent.act(obs)
        obs = rs.normal(size=4).astype(np.float32)
        agent.observe(obs, float(rs.uniform()), i % 9 == 8, False)


def test_shell_snapshot_roundtrip(tmp_path):
    agent = _port_dqn()
    _drive(agent, 60, 1)
    save_snapshot(agent, str(tmp_path / "snap"))
    agent2 = _port_dqn(seed=3)
    _drive(agent2, 20, 2)
    load_snapshot(agent2, str(tmp_path / "snap"))
    assert agent2.t == agent.t == 60 and agent.train_state.n_updates > 0
    assert int(agent2.replay_state.cursor) == int(agent.replay_state.cursor) == 60
    assert assert_same(flat(agent2.train_state), flat(agent.train_state)) >= 8
    assert_same(flat(agent2.replay_state), flat(agent.replay_state))


def test_load_snapshot_before_the_first_act_raises(tmp_path):
    agent = _port_dqn()
    _drive(agent, 20, 1)
    save_snapshot(agent, str(tmp_path))
    with pytest.raises(RuntimeError, match="act once"):
        load_snapshot(_port_dqn(), str(tmp_path))


@pytest.mark.parametrize("suffix", ["_finish", "_except"])
def test_train_loop_saves_load_back(tmp_path, suffix):
    import logging

    from pfrl_tpu_torch.experiments.train_loop import TrainRun

    agent = _port_dqn()
    _drive(agent, 40, 1)
    run = TrainRun(agent=agent, outdir=str(tmp_path), logger=logging.getLogger("test"), t=40)
    if suffix == "_finish":
        run.finish()
    else:
        with pytest.raises(ValueError), run.crash_save_on_error():
            raise ValueError("the run fails")
    fresh = _port_dqn(seed=5)
    fresh.load(str(tmp_path / f"40{suffix}"))  # before the first act: kept pending
    _drive(fresh, 1, 7)  # builds the state, the load lands; no update before the replay start
    assert fresh.train_state.n_updates == agent.train_state.n_updates > 0
    assert assert_same(flat(fresh.train_state), flat(agent.train_state)) >= 8


# ------------------------------------------------- (d) runner snapshots
def _runner(kind):
    from pfrl_tpu_torch.experiments import acer, cartpole_value, recurrent

    small = dict(num_envs=4, capacity=256, replay_start_size=32, update_interval=2, target_update_interval=48,
                 minibatch_size=8)
    if kind == "uniform":
        return cartpole_value.make_dqn_cartpole_runner(hidden=16, device="cpu", **small)[0]
    if kind == "prioritized":
        return cartpole_value.make_rainbow_cartpole_runner(hidden=16, device="cpu", **small)[0]
    episodic = dict(num_envs=4, max_episodes=64, replay_start_size=32, update_interval=4, minibatch_size=4)
    if kind == "episodic":
        return acer.make_acer_abc_runner(hidden=16, device="cpu", **episodic)[0]
    return recurrent.make_drqn_po_abc_runner(hidden=8, device="cpu", target_update_interval=48, **episodic)[0]


@pytest.mark.parametrize("kind", ["uniform", "prioritized", "episodic", "recurrent"])
def test_runner_snapshot_resumes_to_the_bit(tmp_path, kind):
    runner = _runner(kind)
    state = runner.init(0)
    runner.run_chunk(state, 12)
    assert state.train_state.n_updates > 0
    save_runner_snapshot(state, str(tmp_path))
    saved = flat(state)
    _, metrics_a = runner.run_chunk(state, 10)
    after_a = flat(state)

    runner_b = _runner(kind)
    template = runner_b.init(1)  # other weights, other draws: all overwritten
    restored = load_runner_snapshot(template, str(tmp_path))
    assert restored is template and restored.t == 48
    n = assert_same(flat(restored), saved)
    assert n >= 10
    _, metrics_b = runner_b.run_chunk(restored, 10)
    assert assert_same(flat(restored), after_a) == n
    for k in metrics_a:
        assert torch.equal(metrics_a[k], metrics_b[k]), k
    if kind == "recurrent":
        assert any("act_state" in k for k in after_a)


def test_a_draw_source_without_state_raises(tmp_path):
    class Logged:  # a parity test's draw source: numbers handed in, no generator to save
        def uniform(self, n):
            return torch.zeros(n)

    state = _runner("uniform").init(0, draws=Logged())
    with pytest.raises(TypeError, match="state_dict"):
        save_runner_snapshot(state, str(tmp_path))


# --------------------------------------------------------- (e) --demo
def test_load_zoo_dqn_cartpole_and_demo_prints_the_jax_line(capsys):
    from test_torch_zoo_value import _start_states, checkpoint

    from pfrl_tpu import envs as jenvs
    from pfrl_tpu.experiments import JaxEvalLoop
    from pfrl_tpu.experiments.demo_cli import run_demo_if_requested as jax_demo
    from pfrl_tpu_torch.experiments import cartpole_value as cv
    from pfrl_tpu_torch.experiments import demo_cli

    jcore, jstate, _, _ = checkpoint("dqn")
    args = type("Args", (), {"demo": True})()
    seed = 11
    assert jax_demo(args, JaxEvalLoop(jenvs.TimeLimit(jenvs.CartPole(), 500), jcore, 10, 501), jstate, seed=seed)
    want_line = capsys.readouterr().out.strip().splitlines()[-1]

    runner, eval_loop = cv.make_dqn_cartpole_runner(device="cpu", capacity=1_024)
    state = demo_cli.maybe_load_train_state(runner.init(0), ZOO + "/dqn/cartpole", runner.core)
    assert state.train_state.n_updates > 1_000
    returns = demo_cli.demo_returns(eval_loop, state.train_state, draws=_start_states(jax.random.PRNGKey(seed)))
    jreturns = np.asarray(JaxEvalLoop(jenvs.TimeLimit(jenvs.CartPole(), 500), jcore, 10, 501).evaluate(
        jstate, jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(returns, jreturns)
    assert demo_cli.run_demo_if_requested(args, eval_loop, state.train_state,
                                          draws=_start_states(jax.random.PRNGKey(seed)))
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line == want_line and got_line.startswith("n_episodes: 10 mean: ")
    assert returns.mean() >= 300.0


def test_resolve_train_state_path(tmp_path):
    from pfrl_tpu_torch.experiments.demo_cli import resolve_train_state_path

    assert resolve_train_state_path(ZOO + "/dqn/cartpole").endswith("best/train_state.msgpack")
    (tmp_path / "best").mkdir()
    (tmp_path / "best" / "train_state.msgpack").write_bytes(b"")
    (tmp_path / "train_state.pt").write_bytes(b"")
    assert resolve_train_state_path(str(tmp_path)) == str(tmp_path / "train_state.pt")
    with pytest.raises(FileNotFoundError):  # a missing file
        resolve_train_state_path(str(tmp_path / "best" / "none.pt"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):  # a directory with neither file
        resolve_train_state_path(str(tmp_path / "empty"))


def test_train_dqn_ale_sim_saves_loads_and_demos(tmp_path, capsys):
    from pfrl_tpu_torch.experiments import atari_dqn_ale

    small = ["--sim", "--prioritized", "--num-envs", "4", "--replay-capacity", "256", "--replay-start-size", "32",
             "--batch-size", "4", "--steps", "64", "--chunk", "8", "--update-interval", "4"]
    out = atari_dqn_ale.run_sim(small + ["--save-to", str(tmp_path)], device="cpu")
    assert out["state"].t == 64 and out["state"].train_state.n_updates == 9  # t = 32 .. 64, one per scan step
    loaded = atari_dqn_ale.run_sim(small + ["--load", str(tmp_path), "--demo"], device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert assert_same(flat(loaded["state"].train_state), flat(out["state"].train_state)) >= 8
    from pfrl_tpu_torch.experiments.demo_cli import demo_returns

    want = demo_returns(out["eval_loop"], out["state"].train_state, 0)
    np.testing.assert_array_equal(loaded["demo_returns"], want)
    assert line.startswith("n_episodes: 5 mean: ")
    with pytest.raises(CheckpointMismatchError):  # another network's state does not load
        atari_dqn_ale.run_sim(small + ["--arch", "nips", "--load", str(tmp_path), "--demo"], device="cpu")
    with pytest.raises(RuntimeError, match="BreakoutNoFrameskip-v4"):  # without --sim: run_ale, ALE not installed
        atari_dqn_ale.run_sim(small[1:], device="cpu")


def test_run_batch_loads_and_demos(tmp_path, monkeypatch, capsys):
    """``train_dqn_batch_ale.py --load --demo``: the agent loads the saved
    ``train_state.pt`` and evaluates 10 episodes (SyntheticALE episodes cut
    to a mean of 40 frames, two serial lanes, in place of the spawned
    workers)."""
    from pfrl_tpu_torch.envs import SerialVectorEnv
    from pfrl_tpu_torch.envs.synthetic_ale import SyntheticALE
    from pfrl_tpu_torch.experiments import atari_dqn_batch
    from pfrl_tpu_torch.wrappers import atari_wrappers

    def make(seed):
        env = atari_wrappers.MaxAndSkipEnv(SyntheticALE(seed, mean_len=40), skip=4)
        return atari_wrappers.wrap_deepmind(env, episode_life=False, clip_rewards=False, channel_order="hwc")

    def small_envs(num_envs, seed, **_):
        envs = SerialVectorEnv([make(seed + i) for i in range(num_envs)]), \
            SerialVectorEnv([make(seed + 100 + i) for i in range(num_envs)])
        for e in envs:
            e.closed = False
        return envs

    monkeypatch.setattr(atari_dqn_batch, "make_vector_envs", small_envs)
    sizes = dict(num_envs=2, capacity=64, replay_start_size=16, device="cpu")
    saved = atari_dqn_batch.make_dqn_batch_agent(**sizes)
    saved.batch_act(np.zeros((2, 84, 84, 4), np.uint8))  # builds the state
    with torch.no_grad():
        for p in saved.train_state.model.parameters():
            p.mul_(1.5)
    saved.save(str(tmp_path))
    agent, stats = atari_dqn_batch.run_batch(str(tmp_path / "out"), load=str(tmp_path), demo=True, **sizes)
    assert stats["episodes"] == 10
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("n_episodes: 10 mean: ")
    assert assert_same(flat(agent.train_state), flat(saved.train_state)) >= 8


# --------------------------------------------- (f) a JAX shell's directory
def _jax_dqn():
    from pfrl_tpu.agents import DQN
    from pfrl_tpu.explorers import ConstantEpsilonGreedy
    from pfrl_tpu.q_functions import FCStateQFunctionWithDiscreteAction
    from pfrl_tpu.replay import ReplayBuffer

    return DQN(FCStateQFunctionWithDiscreteAction(n_actions=2, n_hidden_channels=16, n_hidden_layers=1),
               optax.adam(1e-2), ReplayBuffer(256, gamma=0.9), 0.9, ConstantEpsilonGreedy(0.2, 2),
               replay_start_size=16, minibatch_size=8, target_update_interval=50)


@pytest.mark.parametrize("when", ["before the first act", "after it"])
def test_a_jax_shells_save_directory_loads_into_the_port(tmp_path, when):
    from pfrl_tpu_torch import convert
    from pfrl_tpu_torch.utils import flax_msgpack

    jagent = _jax_dqn()
    _drive(jagent, 40, 1)
    jagent.save(str(tmp_path))
    assert os.listdir(tmp_path) == ["train_state.msgpack"] and int(jagent.train_state.n_updates) > 0
    agent = _port_dqn()
    if when == "after it":
        _drive(agent, 1, 3)
    agent.load(str(tmp_path))
    if when == "before the first act":
        assert agent.train_state is None
        _drive(agent, 1, 3)  # builds the state; the pending load lands
    want = convert.state_from_flax(agent.core, flax_msgpack.load(str(tmp_path / "train_state.msgpack")), "cpu")
    assert agent.train_state.n_updates == int(jagent.train_state.n_updates)
    assert assert_same(flat(agent.train_state), flat(want)) >= 8
    kernel = np.asarray(jagent.train_state.params["params"]["MLP_0"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(agent.train_state.model.mlp.layers[0].weight.detach().numpy(), kernel.T)


def test_a_missing_shell_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        _port_dqn().load(str(tmp_path))


# ------------------------------------------------ (g) the pipeline's load
def _pipeline(seed):
    from pfrl_tpu_torch.experiments.atari_pipeline import make_dqn_pipeline

    p = make_dqn_pipeline(device="cpu", n_workers=1, lanes_per_worker=2, capacity=64, replay_start_size=16, seed=seed)
    p._init_device_state(seed)
    return p


def test_pipeline_load_republishes_the_acting_copy(tmp_path):
    frames = np.random.RandomState(0).randint(0, 256, (64, 84, 84, 4)).astype(np.uint8)
    saved = _pipeline(0)
    with torch.no_grad():  # a trained state: the head's weights moved, then published
        for p in saved.train_state.model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.05)
    saved.train_state.n_updates = 123
    saved.publish()
    saved.save(str(tmp_path))
    want = saved.greedy_actions(frames)

    fresh = _pipeline(1)
    stale = fresh.greedy_actions(frames)
    assert (stale != want).any()  # acting from the stale copy would fail the check below
    fresh.load(str(tmp_path))
    assert fresh.train_state.n_updates == 123
    np.testing.assert_array_equal(fresh.greedy_actions(frames), want)
    for a, b in zip(fresh._acting.model.parameters(), saved.train_state.model.parameters()):
        assert torch.equal(a, b)
    assert assert_same(flat(fresh.train_state), flat(saved.train_state)) >= 8


def test_a_pipeline_loaded_before_start_keeps_the_loaded_state(tmp_path):
    from pfrl_tpu_torch.experiments.atari_pipeline import make_dqn_pipeline

    saved = _pipeline(0)
    saved.train_state.n_updates = 7
    saved.save(str(tmp_path))
    p = make_dqn_pipeline(device="cpu", n_workers=1, lanes_per_worker=2, capacity=64, replay_start_size=16, seed=3)
    p.load(str(tmp_path))
    p._init_device_state(3)  # what ``start`` does first
    assert p.train_state.n_updates == 7 and p.ring is not None
    assert assert_same(flat(p.train_state), flat(saved.train_state)) >= 8


def test_pipeline_demo_cli_loads_and_evaluates(tmp_path, capsys):
    from pfrl_tpu_torch.experiments import atari_pipeline

    saved = _pipeline(0)
    saved.save(str(tmp_path))
    out = atari_pipeline.run(["--sim", "--load", str(tmp_path), "--demo"], device="cpu")
    assert out["demo_returns"].shape == (5,)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("n_episodes: 5 mean: ")
    assert assert_same(flat(out["train_state"]), flat(saved.train_state)) >= 8


# ----------------------------------------------------------- (h) the zoo
def test_local_zoo_lists_and_resolves_the_repositorys_models(monkeypatch):
    from pfrl_tpu.utils import pretrained_models as jpm

    from pfrl_tpu_torch.utils import pretrained_models as pm

    monkeypatch.setenv("PFRL_TPU_MODEL_ZOO", ZOO)
    assert pm.get_model_zoo_root() == ZOO
    assert pm.list_local_models() == jpm.list_local_models() and len(pm.list_local_models()) == 26
    path, exists = pm.download_model("dqn", "cartpole")
    assert exists and path == os.path.join(ZOO, "dqn", "cartpole", "best")
    monkeypatch.delenv("PFRL_TPU_MODEL_ZOO")
    monkeypatch.setenv("HOME", "/nonexistent-home")
    assert pm.get_model_zoo_root() == "/nonexistent-home/.pfrl_tpu/models"


def test_download_model_fetches_with_urlopen_replaced(tmp_path, monkeypatch):
    import urllib.request

    from pfrl_tpu_torch.utils import pretrained_models as pm

    archive = io.BytesIO()
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr("train_state.msgpack", open(os.path.join(ZOO, "dqn/cartpole/best/train_state.msgpack"), "rb").read())
    urls = []

    @contextlib.contextmanager
    def fake_urlopen(url, timeout):
        urls.append((url, timeout))
        yield io.BytesIO(archive.getvalue())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    monkeypatch.setenv("PFRL_TPU_MODEL_ZOO", str(tmp_path))
    path, exists = pm.download_model("dqn", "cartpole")
    assert exists and urls == [(f"{pm.MODEL_ZOO_URL_ROOT}/dqn/cartpole/best.zip", 30)]
    assert os.listdir(path) == ["train_state.msgpack"]

    def failing_urlopen(url, timeout):
        raise OSError("no route")

    monkeypatch.setattr(urllib.request, "urlopen", failing_urlopen)
    assert pm.download_model("c51", "cartpole") == (os.path.join(str(tmp_path), "c51", "cartpole", "best"), False)


def test_ask_yes_no(monkeypatch):
    from pfrl_tpu_torch.utils.ask_yes_no import ask_yes_no

    answers = iter(["maybe", "Y"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    assert ask_yes_no("fetch?")

    def eof(prompt):
        raise EOFError

    monkeypatch.setattr("builtins.input", eof)
    assert not ask_yes_no("fetch?")
