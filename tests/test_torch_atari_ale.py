"""``train_dqn_ale.py``'s host path (``experiments/atari_dqn_ale.run_ale``)
against the example's own ``run_ale``, over the ALE stand-in
(``torch_ale_standin.py``) through each package's ``make_atari``.

(a) The agent holds the example's settings at its defaults (the Nature
    network, Adam's rate and eps, the 10^6-slot PER ring configured for one
    lane: C = 2^20, the exploration schedule, the gating), and the
    example's network converts into it and acts alike.
(b) A run of 200 steps through each package's ``run_ale`` and its
    ``train_agent_with_evaluation``: ``--prioritized --arch nips`` (the
    NIPS'13 network, the narrow one of ``--arch``), the ring cut to 512
    slots, the replay start to 48, the target sync to 64 and the time limit
    to 400 raw frames (so that lives, game overs and ``needs_reset`` all
    happen): 39 updates. The JAX shell starts from its own initial state,
    converted into the port's, and pops the port's logged draws
    (``install_tape``, ``jax.disable_jit``). Held exactly: every action,
    every sampled slot of the sum tree (the port samples through the
    prefix-sample kernel's plain version here), the ring's frames, actions
    and rewards, the syncs and the update count; the statistics within
    1e-5 relative; the parameters and Adam's moments within C22's 3e-6 (1e-5
    of the largest second moment), or 4x what ulp nudges of the starting
    weights move them.
(c) ``run_sim`` without ``--sim`` runs ``run_ale``, as the example's
    ``main`` dispatches; the example's default id raises by name here,
    where ALE is not installed.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_host_agents import NUDGES, assert_dqn_states_close, assert_stats_close, new_log, record, scale_weights
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape
from torch_ale_standin import ENV_ID

import pfrl_tpu.agents as jagents
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.experiments import atari_dqn_ale
from pfrl_tpu_torch.experiments.atari_dqn_ale import ConvQ
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 200
SMALL = ["--env", ENV_ID, "--prioritized", "--arch", "nips", "--replay-capacity", "512", "--replay-start-size", "48",
         "--steps", str(STEPS), "--target-update-interval", "64", "--eval-interval", str(10**6),
         "--max-frames", "400"]


def load_example():
    path = os.path.join(REPO, "examples/atari/train_dqn_ale.py")
    spec = importlib.util.spec_from_file_location("train_dqn_ale_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EXAMPLE = load_example()
JaxDQN = jagents.DQN


class Kept(Exception):
    """Raised by the replaced JAX shell once it is built."""


def jax_shell(monkeypatch, argv, on_init):
    """The example's ``main`` with ``argv`` up to the shell it builds, which
    ``on_init(agent)`` sees right after ``DQN.__init__``."""
    class Shell(JaxDQN):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            on_init(self)

    monkeypatch.setattr(jagents, "DQN", Shell)
    monkeypatch.setattr(sys, "argv", ["train_dqn_ale.py", *argv])
    EXAMPLE.main()


def initial_jax_shell(monkeypatch, argv):
    """The JAX shell ``run_ale`` builds from ``argv``, its state initialized
    from its own seed, before any step."""
    kept = []

    def keep(agent):
        agent._ensure_init(np.zeros((1, 84, 84, 4), np.uint8))
        kept.append(agent)
        raise Kept

    with pytest.raises(Kept):
        jax_shell(monkeypatch, argv, keep)
    return kept[0]


def test_agent_holds_the_examples_settings(monkeypatch, tmp_path):
    jagent = initial_jax_shell(monkeypatch, ["--env", ENV_ID, "--prioritized", "--outdir", str(tmp_path)])
    tagent = atari_dqn_ale.make_ale_agent(4, prioritized=True, device="cpu")
    assert isinstance(tagent.core.model, ConvQ) and tagent.core.phi.__name__ == "atari_phi"
    jbuf, tbuf = jagent.buffer, tagent.buffer
    assert isinstance(tbuf, PrioritizedReplayBuffer) and type(tbuf).__name__ == type(jbuf).__name__
    for attr in ("capacity", "num_lanes", "num_steps", "gamma", "store_next_obs", "fused_dequant_scale", "alpha",
                 "tree_capacity", "beta_add", "wants_next_obs"):
        assert getattr(tbuf, attr) == pytest.approx(getattr(jbuf, attr)), attr
    assert (tbuf.capacity, tbuf.num_lanes, tbuf.tree_capacity) == (10**6, 1, 2**20)
    for attr in ("replay_start_size", "minibatch_size", "update_interval", "target_update_interval",
                 "n_times_update", "gamma"):
        assert getattr(tagent, attr) == getattr(jagent, attr), attr
    tex, jex = tagent.core.explorer, jagent.core.explorer
    assert (tex.start_epsilon, tex.end_epsilon, tex.decay_steps, tex.n_actions) == \
        (jex.start_epsilon, jex.end_epsilon, jex.decay_steps, jex.n_actions) == (1.0, 0.01, 10**6, 4)
    assert isinstance(tagent.core.optimizer, Adam)
    assert (tagent.core.optimizer.learning_rate, tagent.core.optimizer.eps) == (2.5e-4, 1.5e-4)
    assert type(tagent.core).__name__ == type(jagent.core).__name__ == "DQNCore"
    assert (tagent.core.gamma, tagent.core.batch_accumulator, tagent.core.clip_delta) == \
        (jagent.core.gamma, jagent.core.batch_accumulator, jagent.core.clip_delta)
    assert type(atari_dqn_ale.make_ale_agent(4, double=True, capacity=256, device="cpu").core).__name__ == \
        "DoubleDQNCore"
    convert.dqn_shell_from_flax(tagent, np_tree(jagent.train_state))
    obs = np.random.RandomState(0).randint(0, 256, (3, 84, 84, 4)).astype(np.uint8)
    with tagent.eval_mode(), jagent.eval_mode():
        np.testing.assert_array_equal(tagent.batch_act(obs), np.asarray(jagent.batch_act(obs)))


def _log_slots(buffer, log):
    find = buffer._find_slots

    def find_slots(tree, targets):
        out = find(tree, targets)
        log.append(np.asarray(out).copy())
        return out

    buffer._find_slots = find_slots


def _ring(storage):
    return {k: np.asarray(storage[k]) for k in ("obs", "action", "reward")}


def compiled(fn):
    """``fn``, which draws nothing, compiled by XLA even inside
    ``jax.disable_jit()``: the JAX run stays eager where it draws (its acts'
    and updates' keys pop the tape in program order) and is compiled for
    the network's forwards, Adam's step, the ring's adds, gathers and slot
    search and the priority feedback, which take most of an eager run's
    time."""
    jitted = jax.jit(fn)

    def call(*args):
        with jax.disable_jit(False):
            return jitted(*args)

    return call


def test_run_ale_matches_the_examples_run(monkeypatch, tmp_path):
    jstart = initial_jax_shell(monkeypatch, SMALL + ["--outdir", str(tmp_path / "init")])
    jstate = np_tree(jstart.train_state)

    def port_run(scale, outdir):
        tape, log, slots, built = Tape(17), new_log(), [], []

        class Shell(atari_dqn_ale.DQN):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                scale_weights(convert.dqn_shell_from_flax(self, jstate), scale)
                record(self, log)
                _log_slots(self.buffer, slots)
                built.append(self)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(atari_dqn_ale, "DQN", Shell)
            out = atari_dqn_ale.run_ale(SMALL + ["--outdir", outdir], device="cpu", draws=tape)
        assert out["agent"] is built[0]
        return out["agent"], tape, log, slots

    tagent, tape, tlog, tslots = port_run(1.0, str(tmp_path / "port"))
    nudged = [port_run(s, str(tmp_path / f"nudged{i}"))[0] for i, s in enumerate(NUDGES)]
    jlog, jslots, jbuilt = new_log(), [], []

    def start(agent):
        agent.train_state = jstart.train_state
        agent.buffer.add = compiled(agent.buffer.add)
        agent.buffer.update_priorities = compiled(agent.buffer.update_priorities)
        agent.buffer.gather = compiled(agent.buffer.gather)
        agent.buffer._find_slots = compiled(agent.buffer._find_slots)
        agent.core.action_value = compiled(agent.core.action_value)
        agent.core.optimizer = optax.GradientTransformation(agent.core.optimizer.init,
                                                            compiled(agent.core.optimizer.update))
        record(agent, jlog)
        _log_slots(agent.buffer, jslots)
        jbuilt.append(agent)

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jax_shell(mp, SMALL + ["--outdir", str(tmp_path / "jax")], start)
        assert not tape.log
    jagent = jbuilt[0]
    assert len(tlog["actions"]) == len(jlog["actions"]) == STEPS
    for got, want in zip(tlog["actions"], jlog["actions"]):
        np.testing.assert_array_equal(got, want)
    assert len(tslots) == len(jslots) == (STEPS - 48) // 4 + 1 == 39
    for got, want in zip(tslots, jslots):
        np.testing.assert_array_equal(got, want)
    assert tagent.buffer.tree_capacity == 512
    tring, jring = _ring(tagent.replay_state.base.storage), _ring(vars(jagent.replay_state.base.storage))
    for key, want in jring.items():  # the port pads a ring row of 28,224 frame bytes to 28,288
        got = tring[key].reshape(len(want), -1)[:, :want[0].size].reshape(want.shape)
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert tlog["syncs"] == jlog["syncs"] == 3
    assert tagent.t == jagent.t == STEPS and tagent.optim_t == jagent.optim_t == 39
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics())
    assert_dqn_states_close(tagent, jagent, nudged, "run_ale")


def test_run_sim_without_sim_runs_the_ale_path(tmp_path):
    with pytest.raises(RuntimeError, match="BreakoutNoFrameskip-v4"):
        atari_dqn_ale.run_sim(["--outdir", str(tmp_path)], device="cpu")
    out = atari_dqn_ale.run_sim(SMALL[:SMALL.index("--steps")] + ["--steps", "8", "--outdir", str(tmp_path)],
                                device="cpu")
    assert out["agent"].t == 8 and out["agent"].optim_t == 0 and out["env"].action_space.n == 4
