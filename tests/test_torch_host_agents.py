"""The port's host shells against the JAX package's: ``DQN`` and
``DoubleDQN`` (over the uniform ring and over PER, whose sampling runs the
prefix-sample kernel's plain version here), the ``REINFORCE`` core and
shell, the port's save/load, and the buffers' ``configure_lanes`` and
``wants_next_obs``.

Each shell runs through the same driver of its package
(``train_agent_with_evaluation`` or ``train_agent_batch_with_evaluation``)
over the same host envs: ``HostJaxEnv`` and ``HostTorchEnv`` over the
deterministic ABC and the 500-step CartPole. The JAX shell starts from its
own initial state, converted into the port's shell
(``convert.dqn_shell_from_flax``, ``convert.reinforce_state_from_flax``).
Draws are matched by value (:class:`Tape` and :func:`install_tape`, ROADMAP
C29): the port draws seeded numpy numbers and logs them, and the JAX run,
under ``jax.disable_jit``, pops the same numbers in program order, the
envs' resets, the acts and the updates alike; the log is empty at the end.

Tolerances: actions, evaluation returns, update and sync counts exactly;
the statistics ``average_q`` and ``average_loss`` within 1e-5 relative;
the DQN shells' parameters, target parameters and first moments within
3e-6 and second moments within 1e-5 of their largest magnitude, or 4x what
ulp nudges of the starting weights move them (:func:`assert_within_nudges`);
REINFORCE's parameters within 1e-6 of each tensor's largest magnitude after
one update and 1e-5 after two or three, its loss within 1e-5 relative from
the same state and 5e-5 absolute over the shell's run (with the baseline
it is a near-cancelling sum).
CartPole's dynamics grow XLA's and torch's ulp differences of the state
exponentially once the pole balances (7e-3 after 300 steps), so the
CartPole runs cut their episodes at 50 steps.
"""

import functools
import os

import flax.linen as nn
import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu import explorers as jexplorers
from pfrl_tpu.agents import DQN as JaxDQN
from pfrl_tpu.agents import REINFORCE as JaxREINFORCE
from pfrl_tpu.agents import DoubleDQN as JaxDoubleDQN
from pfrl_tpu.agents.reinforce import ReinforceCore as JaxReinforceCore
from pfrl_tpu.envs import ABC as JaxABC
from pfrl_tpu.envs import CartPole as JaxCartPole
from pfrl_tpu.envs import HostJaxEnv, SerialVectorEnv as JaxSerialVectorEnv
from pfrl_tpu.envs import TimeLimit as JaxTimeLimit
from pfrl_tpu.experiments import train_agent_batch_with_evaluation as jax_train_batch
from pfrl_tpu.experiments import train_agent_with_evaluation as jax_train
from pfrl_tpu.policies import SoftmaxCategoricalHead as JaxSoftmaxHead
from pfrl_tpu.q_functions import FCStateQFunctionWithDiscreteAction as JaxFCQ
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import ReplayBuffer as JaxReplayBuffer
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import explorers as texplorers
from pfrl_tpu_torch.agents import DQN, REINFORCE, DoubleDQN, ReinforceCore
from pfrl_tpu_torch.envs import ABC, CartPole, HostTorchEnv, SerialVectorEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments import train_agent_batch_with_evaluation, train_agent_with_evaluation
from pfrl_tpu_torch.experiments.reinforce_gym import ReinforcePolicy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer

torch.set_num_threads(1)

HIDDEN = 16
DQN_KW = dict(replay_start_size=32, minibatch_size=16, update_interval=4, target_update_interval=50)


class JaxPolicy(nn.Module):
    """``train_reinforce_gym.py``'s ``Policy`` at a test width."""

    n_actions: int = 2
    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Dense(self.hidden)(x))
        return JaxSoftmaxHead()(nn.Dense(self.n_actions)(h))


# ---------------------------------------------------------------- the pairs
ENVS = {  # name -> (JAX env, port env, obs size, actions, steps)
    "abc": (lambda: JaxABC(size=2, deterministic=True), lambda: ABC(size=2, deterministic=True, device="cpu"), 4, 2),
    "cartpole": (lambda: JaxTimeLimit(JaxCartPole(), 500), lambda: TimeLimit(CartPole(device="cpu"), 500), 4, 2),
}


def _buffers(kind):
    if kind == "per":
        return JaxPER(1000, betasteps=1000, gamma=0.9), PrioritizedReplayBuffer(1000, betasteps=1000, gamma=0.9,
                                                                                device="cpu")
    return JaxReplayBuffer(1000, gamma=0.9), ReplayBuffer(1000, gamma=0.9, device="cpu")


def jax_dqn(double, buffer_kind, env_name, lr=1e-2):
    """A JAX shell with its initial state built from a real key."""
    _, _, obs_size, n = ENVS[env_name]
    jcls = JaxDoubleDQN if double else JaxDQN
    jagent = jcls(JaxFCQ(n_actions=n, n_hidden_channels=HIDDEN, n_hidden_layers=1), optax.adam(lr),
                  _buffers(buffer_kind)[0], 0.9, jexplorers.ConstantEpsilonGreedy(0.2, n), **DQN_KW)
    jagent._ensure_init(np.zeros((1, obs_size), np.float32))
    return jagent


def port_dqn(double, buffer_kind, env_name, jstate, tape, scale=1.0, lr=1e-2):
    """The port's shell converted from the JAX shell's state ``jstate``
    (its weights times ``scale``), drawing from ``tape``."""
    _, _, obs_size, n = ENVS[env_name]
    tcls = DoubleDQN if double else DQN
    tagent = tcls(FCStateQFunctionWithDiscreteAction(obs_size, n, 1, HIDDEN), Adam(lr), _buffers(buffer_kind)[1],
                  0.9, texplorers.ConstantEpsilonGreedy(0.2, n), **DQN_KW, device="cpu", draws=tape)
    convert.dqn_shell_from_flax(tagent, jstate)
    return scale_weights(tagent, scale)


NUDGES = (1.0 + 2.0**-23, 1.0 - 2.0**-23)


def scale_weights(agent, scale):
    """``agent`` with its online and target weights times ``scale``."""
    ts = agent.train_state
    with torch.no_grad():
        for p in list(ts.model.parameters()) + list(ts.target_model.parameters()):
            p.mul_(scale)
    return agent


def record(agent, log, core_attr="core"):
    """Logs every action and counts the target syncs of ``agent``."""
    act = agent.batch_act

    def batch_act(batch_obs):
        out = act(batch_obs)
        log["actions"].append(np.asarray(out).copy())
        return out

    agent.batch_act = batch_act
    core = getattr(agent, core_attr)
    if hasattr(core, "sync_target"):
        sync = core.sync_target

        def sync_target(state):
            log["syncs"] += 1
            return sync(state)

        core.sync_target = sync_target
    return agent


def new_log():
    return {"actions": [], "syncs": 0}


def scores(outdir):
    lines = open(os.path.join(outdir, "scores.txt")).read().splitlines()
    header = lines[0].split("\t")
    rows = [dict(zip(header, line.split("\t"))) for line in lines[1:]]
    return header, rows


def assert_same_scores(tdir, jdir, atol=0.0):
    """The rows of both ``scores.txt``: every column but ``elapsed`` equal,
    the agent's averages within 1e-5 relative (or ``atol``)."""
    theader, trows = scores(tdir)
    jheader, jrows = scores(jdir)
    assert theader == jheader and len(trows) == len(jrows) >= 1
    for trow, jrow in zip(trows, jrows):
        for col in theader:
            if col == "elapsed":
                continue
            if col.startswith("average_"):
                np.testing.assert_allclose(float(trow[col]), float(jrow[col]), rtol=1e-5, atol=atol, err_msg=col)
            else:
                assert trow[col] == jrow[col], (col, trow[col], jrow[col])


def _dqn_tensors(agent):
    ts = agent.train_state
    tensors = {f"online {n}": p for n, p in ts.model.named_parameters()}
    tensors.update({f"target {n}": p for n, p in ts.target_model.named_parameters()})
    names = [n for n, _ in ts.model.named_parameters()]
    tensors.update({f"mu {n}": m for n, m in zip(names, ts.opt_state.mu)})
    tensors.update({f"nu {n}": m for n, m in zip(names, ts.opt_state.nu)})
    return {k: v.detach().numpy() for k, v in tensors.items()}


def _jax_dqn_tensors(tagent, jagent):
    js, model = jagent.train_state, tagent.train_state.model
    adam = js.opt_state[0]
    out = {}
    for prefix, tree in (("online", js.params), ("target", js.target_params), ("mu", adam.mu), ("nu", adam.nu)):
        out.update({f"{prefix} {n}": a for n, a in convert.torch_arrays(model, np_tree(tree)).items()})
    return out


def assert_within_nudges(got: dict, want: dict, nudged: list, what: str):
    """Parameters, target parameters and Adam's first moments within 3e-6
    (C22's bound after three updates: each update rounds anew, and over
    these runs' 22 to 43 updates the packages drift apart by 1.5e-6 at
    most), second moments within 1e-5 of their largest magnitude; or each
    within 4x the larger of what 1 + 2**-23 and 1 - 2**-23 nudges of the
    port's starting weights move it, where that is more (C48's rule)."""
    for name, x in got.items():
        nudge = max(float(np.abs(x - n[name]).max()) for n in nudged)
        floor = 1e-5 * float(np.abs(want[name]).max()) if name.startswith("nu ") else 3e-6
        bound = max(floor, 4 * nudge)
        diff = float(np.abs(x - want[name]).max())
        assert diff <= bound, f"{what} {name}: {diff} > {bound} (nudges move it {nudge})"


def assert_dqn_states_close(tagent, jagent, nudged_agents, what=""):
    ts, js = tagent.train_state, jagent.train_state
    assert ts.n_updates == int(js.n_updates) == tagent.optim_t == jagent.optim_t
    assert ts.opt_state.count == int(js.opt_state[0].count)
    assert_within_nudges(_dqn_tensors(tagent), _jax_dqn_tensors(tagent, jagent),
                         [_dqn_tensors(a) for a in nudged_agents], what)


def assert_module_close(module, flax_tree, rtol):
    want = convert.torch_arrays(module, np_tree(flax_tree))
    for name, p in module.named_parameters():
        atol = rtol * float(np.abs(want[name]).max()) + 1e-12
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=atol, err_msg=name)


def assert_stats_close(tstats, jstats, atol=0.0):
    assert [k for k, _ in tstats] == [k for k, _ in jstats]
    for (k, tv), (_, jv) in zip(tstats, jstats):
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5, atol=atol, err_msg=k)


# ----------------------------------------------------------- the DQN shells
SERIAL_RUNS = [  # (double, buffer, env, steps)
    (False, "uniform", "abc", 120),
    (True, "per", "cartpole", 120),
]


def _same_actions(tlog, jlog):
    assert len(tlog["actions"]) == len(jlog["actions"])
    for got, want in zip(tlog["actions"], jlog["actions"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("double,buffer_kind,env_name,steps", SERIAL_RUNS)
def test_dqn_shell_matches_jax_through_the_serial_driver(tmp_path, double, buffer_kind, env_name, steps):
    jagent = jax_dqn(double, buffer_kind, env_name)
    jstate = np_tree(jagent.train_state)
    jenv_cls, tenv_cls = ENVS[env_name][:2]
    kw = dict(steps=steps, eval_n_steps=None, eval_n_episodes=3, eval_interval=steps // 2, train_max_episode_len=50)

    def port_run(scale, outdir):
        tape, log = Tape(7), new_log()
        tagent = port_dqn(double, buffer_kind, env_name, jstate, tape, scale)
        train_agent_with_evaluation(record(tagent, log), HostTorchEnv(tenv_cls(), draws=tape), outdir=outdir,
                                    eval_env=HostTorchEnv(tenv_cls(), draws=tape), **kw)
        return tagent, tape, log

    tagent, tape, tlog = port_run(1.0, str(tmp_path / "port"))
    nudged = [port_run(s, str(tmp_path / f"nudged{i}")) for i, s in enumerate(NUDGES)]
    assert [k for k, _ in tape.log].count("randint_below" if buffer_kind == "uniform" else "uniform") > 0
    jlog = new_log()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jax_train(record(jagent, jlog), HostJaxEnv(jenv_cls(), seed=1), outdir=str(tmp_path / "jax"),
                  eval_env=HostJaxEnv(jenv_cls(), seed=2), **kw)
        assert not tape.log
    _same_actions(tlog, jlog)
    for _, _, log in nudged:
        _same_actions(log, jlog)
    assert len(tlog["actions"]) > steps
    assert tlog["syncs"] == jlog["syncs"] >= 2
    assert tagent.t == jagent.t == steps and tagent.optim_t == (steps - 32) // 4 + 1
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics())
    assert_same_scores(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_dqn_states_close(tagent, jagent, [a for a, _, _ in nudged], env_name)


def test_double_dqn_shell_matches_jax_through_the_batch_driver(tmp_path):
    """Four CartPole lanes in a ``SerialVectorEnv``: the lanes configured
    from the first observe, four transitions per observe, the ring's stride
    of four."""
    jagent = jax_dqn(True, "uniform", "cartpole")
    jstate = np_tree(jagent.train_state)
    kw = dict(steps=200, eval_n_steps=None, eval_n_episodes=4, eval_interval=100, max_episode_len=50)

    def port_run(scale, outdir):
        tape, log = Tape(11), new_log()
        tagent = port_dqn(True, "uniform", "cartpole", jstate, tape, scale)
        lanes = [[HostTorchEnv(TimeLimit(CartPole(device="cpu"), 500), draws=tape) for _ in range(4)]
                 for _ in range(2)]
        train_agent_batch_with_evaluation(record(tagent, log), SerialVectorEnv(lanes[0]), outdir=outdir,
                                          eval_env=SerialVectorEnv(lanes[1]), **kw)
        return tagent, tape, log

    tagent, tape, tlog = port_run(1.0, str(tmp_path / "port"))
    nudged = [port_run(s, str(tmp_path / f"nudged{i}")) for i, s in enumerate(NUDGES)]
    assert tagent.buffer.num_lanes == 4 and tagent.buffer.capacity == 1000
    jlog = new_log()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        lanes = [[HostJaxEnv(JaxTimeLimit(JaxCartPole(), 500)) for _ in range(4)] for _ in range(2)]
        jax_train_batch(record(jagent, jlog), JaxSerialVectorEnv(lanes[0]), outdir=str(tmp_path / "jax"),
                        eval_env=JaxSerialVectorEnv(lanes[1]), **kw)
        assert not tape.log
    _same_actions(tlog, jlog)
    for _, _, log in nudged:
        _same_actions(log, jlog)
    assert tlog["syncs"] == jlog["syncs"] == 4
    assert tagent.t == jagent.t == 200 and tagent.optim_t == (200 - 32) // 4 + 1
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics())
    assert_same_scores(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_dqn_states_close(tagent, jagent, [a for a, _, _ in nudged], "batch")


def _observe_batches(agent, n_lanes, steps, seed):
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        obs = rs.normal(size=(n_lanes, 4)).astype(np.float32)
        agent.batch_act(obs)
        done = rs.uniform(size=n_lanes) < 0.2
        reset = ~done & (rs.uniform(size=n_lanes) < 0.1)
        agent.batch_observe(rs.normal(size=(n_lanes, 4)).astype(np.float32), rs.normal(size=n_lanes), done, reset)


@pytest.mark.parametrize("n_times_update,update_interval,target_update_interval", [(1, 3, 7), (2, 5, 10)])
def test_dqn_shell_gating_counts_match_jax(n_times_update, update_interval, target_update_interval):
    """The shell's arithmetic (``dqn.py:336-367``): ``done | reset`` is the
    ring's done and ``done`` alone its terminated, the lanes come from the
    first observe, a sync on each crossing of a multiple, and
    ``t // ui - prev_t // ui`` triggers of ``n_times_update`` updates."""
    kw = dict(replay_start_size=20, minibatch_size=4, update_interval=update_interval,
              target_update_interval=target_update_interval, n_times_update=n_times_update)
    jagent = JaxDQN(JaxFCQ(n_actions=2, n_hidden_channels=8, n_hidden_layers=1), optax.adam(1e-3),
                    JaxReplayBuffer(500, gamma=0.9), 0.9, jexplorers.ConstantEpsilonGreedy(0.5, 2), **kw)
    jagent._ensure_init(np.zeros((1, 4), np.float32))
    jstate = np_tree(jagent.train_state)

    def port_run(scale):
        tape, log = Tape(3), new_log()
        tagent = DQN(FCStateQFunctionWithDiscreteAction(4, 2, 1, 8), Adam(1e-3),
                     ReplayBuffer(500, gamma=0.9, device="cpu"), 0.9, texplorers.ConstantEpsilonGreedy(0.5, 2), **kw,
                     device="cpu", draws=tape)
        scale_weights(convert.dqn_shell_from_flax(tagent, jstate), scale)
        _observe_batches(record(tagent, log), 3, 30, seed=5)
        return tagent, tape, log

    tagent, tape, tlog = port_run(1.0)
    nudged = [port_run(s)[0] for s in NUDGES]
    jlog = new_log()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        _observe_batches(record(jagent, jlog), 3, 30, seed=5)
        assert not tape.log
    _same_actions(tlog, jlog)
    assert tagent.t == jagent.t == 90 and tagent.buffer.num_lanes == jagent.buffer.num_lanes == 3
    assert tagent.optim_t == jagent.optim_t == (90 // update_interval - 18 // update_interval) * n_times_update
    assert tlog["syncs"] == jlog["syncs"] == 90 // target_update_interval
    tst, jst = tagent.replay_state, jagent.replay_state
    assert int(tst.cursor) == int(jst.cursor) == 90
    for leaf in ("terminated", "done", "reward", "action"):
        np.testing.assert_array_equal(tst.storage[leaf][:90].numpy(), np.asarray(getattr(jst.storage, leaf)[:90]),
                                      leaf)
    assert_dqn_states_close(tagent, jagent, nudged, "gating")


def test_collate_obs_matches_jax():
    """Arrays and ``LazyFrames`` through ``np.asarray``; structured
    observations stacked leaf by leaf (``dqn.py:60-77``)."""
    from pfrl_tpu.agents.dqn import _collate_obs as jax_collate

    from pfrl_tpu_torch.agents.dqn import _collate_obs
    from pfrl_tpu_torch.wrappers.atari_wrappers import LazyFrames

    rs = np.random.RandomState(0)
    frames = [LazyFrames([rs.randint(0, 256, (2, 2, 1)).astype(np.uint8) for _ in range(4)], stack_axis=2)
              for _ in range(3)]
    structured = [(rs.normal(size=(2, 3)), np.int64(i)) for i in range(4)]
    for batch in (rs.normal(size=(5, 4)), frames, structured, [{"a": rs.normal(size=2), "b": np.ones(1)}] * 3):
        got, want = _collate_obs(batch), jax_collate(batch)
        jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)), got, want)
    assert _collate_obs(frames).shape == (3, 2, 2, 4) and _collate_obs(structured)[0].shape == (4, 2, 3)


# ------------------------------------------------------------ save and load
def _trained_port_dqn(tmp_path):
    tagent = DQN(FCStateQFunctionWithDiscreteAction(4, 2, 1, HIDDEN), Adam(1e-2),
                 PrioritizedReplayBuffer(1000, betasteps=1000, gamma=0.9, device="cpu"), 0.9,
                 texplorers.ConstantEpsilonGreedy(0.2, 2), **DQN_KW, device="cpu", seed=1)
    train_agent_with_evaluation(tagent, HostTorchEnv(ABC(size=2, deterministic=True, device="cpu"), seed=1),
                                steps=150, eval_n_steps=None, eval_n_episodes=2, eval_interval=1000,
                                outdir=str(tmp_path / "run"))
    assert tagent.optim_t > 20
    return tagent


def _fresh_port_dqn(seed):
    return DQN(FCStateQFunctionWithDiscreteAction(4, 2, 1, HIDDEN), Adam(1e-2),
               PrioritizedReplayBuffer(1000, betasteps=1000, gamma=0.9, device="cpu"), 0.9,
               texplorers.ConstantEpsilonGreedy(0.2, 2), **DQN_KW, device="cpu", seed=seed)


def _state_tensors(ts):
    return ([p.detach().clone() for p in ts.model.parameters()]
            + [p.detach().clone() for p in ts.target_model.parameters()]
            + [x.clone() for x in ts.opt_state.mu + ts.opt_state.nu])


@pytest.mark.parametrize("load_before_first_act", [True, False])
def test_port_save_load_round_trip(tmp_path, load_before_first_act):
    """``save`` writes ``train_state.pt``; ``load`` restores it into a fresh
    shell, before its first act (kept pending, applied when the shell
    builds its state) or after it (in place), Adam's count and
    ``n_updates`` included; the greedy actions then agree."""
    saved = _trained_port_dqn(tmp_path)
    saved.save(str(tmp_path / "agent"))
    assert sorted(os.listdir(tmp_path / "agent")) == ["train_state.pt"]
    fresh = _fresh_port_dqn(seed=9)
    obs = np.random.RandomState(0).normal(size=(5, 4)).astype(np.float32)
    if not load_before_first_act:
        fresh.batch_act(obs)
        before = _state_tensors(fresh.train_state)
        assert not all(torch.equal(a, b) for a, b in zip(before, _state_tensors(saved.train_state)))
    fresh.load(str(tmp_path / "agent"))
    with fresh.eval_mode(), saved.eval_mode():
        np.testing.assert_array_equal(fresh.batch_act(obs), saved.batch_act(obs))
    for a, b in zip(_state_tensors(fresh.train_state), _state_tensors(saved.train_state)):
        assert torch.equal(a, b)
    assert fresh.train_state.n_updates == saved.train_state.n_updates
    assert fresh.train_state.opt_state.count == saved.train_state.opt_state.count
    assert not getattr(fresh, "_pending_restores", {})


def test_port_loads_a_jax_shell_checkpoint_only_through_the_converter(tmp_path):
    """A JAX shell's ``save`` (msgpack) restored with flax, then converted,
    and the same directory given to the port shell's ``load`` (the port's
    own msgpack reader, then the same converter): both port shells act as
    the JAX shell does."""
    from flax import serialization

    jagent = JaxDQN(JaxFCQ(n_actions=2, n_hidden_channels=HIDDEN, n_hidden_layers=1), optax.adam(1e-2),
                    JaxReplayBuffer(1000, gamma=0.9), 0.9, jexplorers.ConstantEpsilonGreedy(0.2, 2), **DQN_KW)
    jagent._ensure_init(np.zeros((1, 4), np.float32))
    jagent.save(str(tmp_path / "jax"))
    template = jax.device_get(jagent.train_state)
    restored = serialization.from_bytes(template, (tmp_path / "jax" / "train_state.msgpack").read_bytes())
    tagent = convert.dqn_shell_from_flax(_fresh_port_dqn(seed=3), np_tree(restored))
    loaded = _fresh_port_dqn(seed=3)
    loaded.load(str(tmp_path / "jax"))  # no train_state.pt: the msgpack is read and converted
    with pytest.raises(FileNotFoundError):
        _fresh_port_dqn(seed=3).load(str(tmp_path / "none"))
    obs = np.random.RandomState(1).normal(size=(6, 4)).astype(np.float32)
    with tagent.eval_mode(), jagent.eval_mode(), loaded.eval_mode():
        np.testing.assert_array_equal(tagent.batch_act(obs), jagent.batch_act(obs))
        np.testing.assert_array_equal(loaded.batch_act(obs), jagent.batch_act(obs))


# --------------------------------------------------------- REINFORCE's core
def _episodes(seed, E=3, L=9, n=2):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(3, L + 1, E)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    return (rs.normal(size=(E, L, 4)).astype(np.float32) * mask[..., None],
            (rs.randint(0, n, (E, L)) * mask).astype(np.int64),
            (rs.normal(size=(E, L)).astype(np.float32) * mask), mask)


def reinforce_cores(baseline, beta):
    jcore = JaxReinforceCore(JaxPolicy(), optax.adam(1e-2), gamma=0.9, beta=beta, baseline=baseline)
    tcore = ReinforceCore(ReinforcePolicy(4, 2, HIDDEN), Adam(1e-2), gamma=0.9, beta=beta, baseline=baseline)
    js = jcore.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.float32))
    return jcore, tcore, js, convert.reinforce_state_from_flax(tcore, np_tree(js), device="cpu")


@pytest.mark.parametrize("baseline,beta", [(False, 0.0), (True, 1e-2)])
def test_reinforce_core_updates_match_jax(baseline, beta):
    """Returns-to-go over padded ``[E, L]`` episodes, the mask, the
    baseline and the entropy bonus: one and three updates."""
    jcore, tcore, js, ts = reinforce_cores(baseline, beta)
    for step in range(3):
        obs, actions, rewards, mask = _episodes(step)
        js, jaux = jcore.update(js, jax.random.PRNGKey(step), obs, actions.astype(np.int32), rewards, mask)
        ts, taux = tcore.update(ts, *(torch.from_numpy(x) for x in (obs, actions, rewards, mask)))
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5, atol=1e-7)
        assert ts.n_updates == int(js.n_updates) == step + 1
        assert_module_close(ts.model, js.params, 1e-6 if step == 0 else 1e-5)


def test_reinforce_returns_to_go_restart_at_each_episode_and_stop_at_the_mask():
    tcore = ReinforceCore(ReinforcePolicy(4, 2, HIDDEN), Adam(1e-2), gamma=0.5)
    rewards = torch.tensor([[1.0, 2.0, 4.0, 0.0], [1.0, 1.0, 0.0, 0.0]])
    mask = torch.tensor([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 0.0]])
    want = torch.tensor([[1.0 + 0.5 * (2.0 + 0.5 * 4.0), 2.0 + 0.5 * 4.0, 4.0, 0.0], [1.5, 1.0, 0.0, 0.0]])
    assert torch.equal(tcore.returns_to_go(rewards, mask), want)


# -------------------------------------------------------- REINFORCE's shell
def test_reinforce_shell_matches_jax_over_two_update_batches(tmp_path):
    """The serial driver on the 500-step CartPole: acts sample through
    ``categorical`` (one uniform per logit), episodes staged on the host,
    two updates of two episodes each, then greedy evaluation."""
    tape = Tape(5)
    jagent = JaxREINFORCE(JaxPolicy(), optax.adam(1e-2), gamma=0.99, beta=1e-3, batchsize=2,
                          max_episode_len=50, baseline=True)
    with jagent.eval_mode():
        jagent.batch_act(np.zeros((1, 4), np.float32))  # builds its state from a real key
    tagent = REINFORCE(ReinforcePolicy(4, 2, HIDDEN), Adam(1e-2), gamma=0.99, beta=1e-3, batchsize=2,
                       max_episode_len=50, baseline=True, device="cpu", draws=tape)
    tagent.train_state = convert.reinforce_state_from_flax(tagent.core, np_tree(jagent.train_state), device="cpu")
    tlog, jlog = new_log(), new_log()
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(steps=REINFORCE_STEPS, eval_n_steps=None, eval_n_episodes=2, eval_interval=REINFORCE_STEPS,
              train_max_episode_len=50)
    train_agent_with_evaluation(record(tagent, tlog), make_cartpole(tape), outdir=tdir,
                                eval_env=make_cartpole(tape), **kw)
    assert [k for k, _ in tape.log].count("uniform") > REINFORCE_STEPS  # a reset's 4, an act's 2
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jax_train(record(jagent, jlog), HostJaxEnv(JaxTimeLimit(JaxCartPole(), 500)), outdir=jdir,
                  eval_env=HostJaxEnv(JaxTimeLimit(JaxCartPole(), 500)), **kw)
        assert not tape.log
    assert len(tlog["actions"]) == len(jlog["actions"]) > REINFORCE_STEPS
    for got, want in zip(tlog["actions"], jlog["actions"]):
        np.testing.assert_array_equal(got, want)
    assert tagent.train_state.n_updates == int(jagent.train_state.n_updates) == 2
    # With the baseline the loss is a near-cancelling sum over the batch's
    # steps (terms of a few units, a result of 1e-2): float32 sums in
    # another order move it by about 1e-5.
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics(), atol=5e-5)
    assert_same_scores(tdir, jdir, atol=5e-5)
    assert_module_close(tagent.train_state.model, jagent.train_state.params, 1e-5)


REINFORCE_STEPS = 120  # four to five ended episodes of the seeded run: two updates


def make_cartpole(tape):
    return HostTorchEnv(TimeLimit(CartPole(device="cpu"), 500), draws=tape)


def test_reinforce_save_load_round_trip_before_the_first_act(tmp_path):
    tagent = REINFORCE(ReinforcePolicy(4, 2, HIDDEN), Adam(1e-2), batchsize=2, max_episode_len=500, device="cpu")
    train_agent_with_evaluation(tagent, make_cartpole(Tape(1)), steps=120, eval_n_steps=None, eval_n_episodes=1,
                                eval_interval=10**6, outdir=str(tmp_path / "run"))
    assert tagent.train_state.n_updates >= 1
    tagent.save(str(tmp_path / "agent"))
    fresh = REINFORCE(ReinforcePolicy(4, 2, HIDDEN), Adam(1e-2), batchsize=2, max_episode_len=500, device="cpu",
                      seed=4)
    fresh.load(str(tmp_path / "agent"))
    obs = np.random.RandomState(2).normal(size=(7, 4)).astype(np.float32)
    with fresh.eval_mode(), tagent.eval_mode():
        np.testing.assert_array_equal(fresh.batch_act(obs), tagent.batch_act(obs))
    assert fresh.train_state.n_updates == tagent.train_state.n_updates
    assert fresh.train_state.opt_state.count == tagent.train_state.opt_state.count


# ------------------------------------------------------------ the buffers
@pytest.mark.parametrize("kind", ["uniform", "per"])
@pytest.mark.parametrize("store_next_obs", [True, False])
def test_configure_lanes_and_wants_next_obs_match_jax(kind, store_next_obs):
    if kind == "per":
        jbuf = JaxPER(1003, betasteps=500, gamma=0.9, num_steps=3, store_next_obs=store_next_obs, alpha=0.5)
        tbuf = PrioritizedReplayBuffer(1003, betasteps=500, gamma=0.9, num_steps=3, store_next_obs=store_next_obs,
                                       alpha=0.5, device="cpu")
    else:
        jbuf = JaxReplayBuffer(1003, gamma=0.9, num_steps=3, store_next_obs=store_next_obs,
                               fused_dequant_scale=1 / 255)
        tbuf = ReplayBuffer(1003, gamma=0.9, num_steps=3, store_next_obs=store_next_obs, fused_dequant_scale=1 / 255,
                            device="cpu")
    assert tbuf.wants_next_obs == jbuf.wants_next_obs == store_next_obs
    jnew, tnew = jbuf.configure_lanes(4), tbuf.configure_lanes(4)
    assert type(tnew) is type(tbuf) and tnew is not tbuf and tnew.device == tbuf.device
    for attr in ("num_lanes", "capacity", "num_steps", "gamma", "store_next_obs", "fused_dequant_scale"):
        assert getattr(tnew, attr) == getattr(jnew, attr), attr
    assert tnew.wants_next_obs == jnew.wants_next_obs
    if kind == "per":
        for attr in ("alpha", "beta0", "beta_add", "eps", "normalize_by_max", "error_min", "error_max",
                     "tree_capacity"):
            assert getattr(tnew, attr) == pytest.approx(getattr(jnew, attr)), attr


def test_shells_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        REINFORCE(ReinforcePolicy(), Adam(1e-3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplayBuffer(100)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HostTorchEnv(CartPole())
