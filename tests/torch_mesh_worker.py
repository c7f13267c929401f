"""One rank of a small mesh run of the port's runners, for
``test_torch_multidevice.py`` (not a test module: it imports no JAX and is
started as a script, one process per rank).

    python tests/torch_mesh_worker.py SCENARIO SETUP OUT [RANK WORLD PORT]

``SCENARIO`` is ``uniform`` (DQN-CartPole over the uniform ring), ``per``
(the same core over 3-step PER) or ``ppo`` (PPO on MujocoSim), or one of
:data:`CORES`: ``drqn`` (DRQN on DelayedCue over the episodic buffer with
stored carries), ``drqn-per`` (the same over the prioritized episodic
buffer, its per-window errors fed back), ``riqn`` (recurrent IQN on it), ``acer`` and
``acer-continuous`` (on ABC, over the episodic buffer with the behaviour
distribution in extras), ``iqn`` and ``rainbow`` (CartPole; Rainbow's
noisy net over 3-step PER), ``sac`` (MujocoSim), ``trpo`` (Pendulum),
``rppo`` and ``rtrpo`` (DelayedCue); or ``snapshot`` (the ``drqn`` runner
from its own seeded weights and a seeded generator: 26 scan steps
uninterrupted, and 13, a runner snapshot, a fresh runner loading it, 13
more); or ``denominator`` (one DRQN update on four windows whose two
shares hold 8 and 2 valid steps). ``SETUP`` a ``torch.save`` file with the starting train state (and
MujocoSim's matrices); ``OUT`` where this rank's result is saved. Without ``RANK``
the run is single-process, with no mesh; with ``WORLD`` 0 it is a mesh of
one rank over Gloo. Every rank draws from the same seeded numpy stream
(:class:`NumpyDraws`, the parity tests' ``LoggedDraws`` with ``randint``
and ``permutation``), so the draws equal the single-process run's.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pfrl_tpu_torch import envs as tenvs  # noqa: E402
from pfrl_tpu_torch.agents.snapshot import load_runner_snapshot, save_runner_snapshot  # noqa: E402
from pfrl_tpu_torch.experiments import acer as acer_recipes  # noqa: E402
from pfrl_tpu_torch.experiments import cartpole_value as cv  # noqa: E402
from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac  # noqa: E402
from pfrl_tpu_torch.experiments import onpolicy as onp  # noqa: E402
from pfrl_tpu_torch.experiments import recurrent as rec  # noqa: E402
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner  # noqa: E402
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner  # noqa: E402
from pfrl_tpu_torch.parallel.data_parallel import data_parallel_core, data_parallel_update, summed_metrics  # noqa: E402
from pfrl_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from pfrl_tpu_torch.parallel.multihost import initialize_multihost, is_primary, local_lane_slice, shutdown  # noqa: E402
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer  # noqa: E402
from pfrl_tpu_torch.replay.prioritized_episodic import PrioritizedEpisodicReplayBuffer  # noqa: E402
from pfrl_tpu_torch.replay.episodic import EpisodeBatch  # noqa: E402
from pfrl_tpu_torch.replay.transition import Transition  # noqa: E402
from pfrl_tpu_torch.utils.draws import Draws  # noqa: E402

LANES, HIDDEN, BATCH, CAPACITY, START, SYNC_EVERY, DECAY, LIMIT, STEPS = 4, 16, 8, 40, 12, 24, 40, 10, 11
SMALL = dict(num_envs=LANES, capacity=CAPACITY, replay_start_size=START, update_interval=2,
             target_update_interval=SYNC_EVERY, minibatch_size=BATCH)
PER = dict(alpha=0.5, beta0=0.4, betasteps=100, num_steps=3, gamma=0.99, num_lanes=LANES)
PPO_ROLLOUT, PPO_MINIBATCH, PPO_EPISODE, ITERATIONS = 16, 16, 12, 3
# The cores of the mesh's later branches. Episodic: 4 lanes of 3 rows each,
# so each rank keeps 6 rows; batch 4 split 2 + 2.
CUE = dict(num_envs=LANES, max_episodes=12, max_episode_len=12, subseq_len=4, replay_start_size=52, update_interval=4,
           target_update_interval=32, minibatch_size=4)
ACER = dict(num_envs=LANES, max_episodes=12, replay_start_size=16, update_interval=4, minibatch_size=4)
FEATURES, TAUS, RIQN_TAUS = 8, 8, 4
SAC = dict(num_envs=LANES, capacity=96, replay_start_size=32, minibatch_size=16, hidden=32)
ON_ROLLOUT = 12
CORES = {"drqn": 26, "drqn-per": 26, "riqn": 25, "acer": 14, "acer-continuous": 14, "iqn": STEPS, "rainbow": STEPS, "sac": 30,
         "trpo": ITERATIONS, "rppo": ITERATIONS, "rtrpo": ITERATIONS}
ONPOLICY = ("ppo", "trpo", "rppo", "rtrpo")
SNAPSHOT_STEPS = 13


class NumpyDraws:
    """Seeded numpy draws, logged as ``(kind, values)``."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.log = []

    def _record(self, kind, values):
        self.log.append((kind, values))
        return torch.from_numpy(values.copy())

    def uniform(self, n):
        return self._record("uniform", (self.rs.randint(0, 1 << 24, n) / float(1 << 24)).astype(np.float32))

    def normal(self, n):
        return self._record("normal", self.rs.standard_normal(n).astype(np.float32))

    def randint(self, high, n):
        return self._record("randint", self.rs.randint(0, high, n).astype(np.int32))

    def randint_below(self, high, n):
        return self._record("randint_below", self.rs.randint(0, int(high), n).astype(np.int32))

    def permutation(self, n):
        return self._record("permutation", self.rs.permutation(n)).to(torch.int64)

    def take(self, *kinds):
        out = []
        for kind in kinds:
            got, values = self.log.pop(0)
            assert got == kind, (got, kind)
            out.append(values)
        return out


def build(scenario, setup, mesh=None):
    if scenario in CORES or scenario == "snapshot":
        return build_core(scenario, setup, mesh)
    if scenario in ("uniform", "per"):
        env = tenvs.TimeLimit(tenvs.CartPole(device="cpu"), LIMIT)
        recipe, _ = cv.make_dqn_cartpole_runner(env=env, device="cpu", hidden=HIDDEN, decay_steps=DECAY, **SMALL)
        buffer = PrioritizedReplayBuffer(CAPACITY, device="cpu", **PER) if scenario == "per" else recipe.buffer
        return OffPolicyRunner(env, recipe.core, buffer, recipe.config, device="cpu", mesh=mesh)
    env = tenvs.MujocoSim(A=setup["A"], B=setup["B"], episode_len=PPO_EPISODE, device="cpu")
    recipe = onp.make_ppo_runner(num_envs=LANES, rollout_len=PPO_ROLLOUT, epochs=2, minibatch_size=PPO_MINIBATCH,
                                 hidden=HIDDEN, env=env)
    return OnPolicyRunner(env, recipe.core, LANES, PPO_ROLLOUT, device="cpu", mesh=mesh)


def build_core(scenario, setup, mesh=None):
    """The runner of one of :data:`CORES` (``snapshot``: ``drqn``'s)."""
    cartpole = dict(env=tenvs.TimeLimit(tenvs.CartPole(device="cpu"), LIMIT), device="cpu", hidden=HIDDEN, **SMALL)
    if scenario in ("drqn", "drqn-per", "snapshot"):
        recipe = rec.make_drqn_delayed_cue_runner(hidden=HIDDEN, device="cpu", **CUE)
    elif scenario == "riqn":
        recipe = rec.make_riqn_delayed_cue_runner(hidden=HIDDEN, n_taus=RIQN_TAUS, device="cpu",
                                                  **dict(CUE, replay_start_size=84))
    elif scenario in ("acer", "acer-continuous"):
        make = acer_recipes.make_acer_abc_runner if scenario == "acer" else acer_recipes.make_acer_continuous_abc_runner
        recipe = make(hidden=HIDDEN, device="cpu", **ACER)
    elif scenario == "iqn":
        recipe = cv.make_iqn_cartpole_runner(feature_size=FEATURES, n_taus=TAUS, decay_steps=DECAY, **cartpole)
    elif scenario == "rainbow":
        recipe = cv.make_rainbow_cartpole_runner(betasteps=100, **cartpole)
    elif scenario == "sac":
        env = tenvs.MujocoSim(A=setup["A"], B=setup["B"], episode_len=PPO_EPISODE, device="cpu")
        recipe = (mac.make_sac_runner(env=env, **SAC), None)
    elif scenario == "trpo":
        env = tenvs.TimeLimit(tenvs.Pendulum(device="cpu"), LIMIT)
        recipe = (onp.make_trpo_pendulum_runner(num_envs=LANES, rollout_len=PPO_ROLLOUT, vf_epochs=2,
                                                vf_batch_size=16, hidden=HIDDEN, env=env), None)
    elif scenario == "rppo":
        recipe = rec.make_rppo_delayed_cue_runner(hidden=HIDDEN, num_envs=LANES, rollout=ON_ROLLOUT, epochs=2,
                                                  minibatch_size=4, device="cpu")
    else:
        recipe = rec.make_rtrpo_delayed_cue_runner(hidden=HIDDEN, num_envs=LANES, rollout=ON_ROLLOUT, vf_epochs=2,
                                                   vf_batch_size=4, device="cpu")
    runner = recipe[0]
    if scenario in ONPOLICY:
        return OnPolicyRunner(runner.env.env, runner.core, LANES, runner.rollout_len, device="cpu", mesh=mesh)
    config, buffer = runner.config, runner.buffer
    if scenario == "drqn-per":  # the prioritized episodic buffer at its defaults
        buffer = PrioritizedEpisodicReplayBuffer(CUE["max_episodes"], CUE["max_episode_len"], num_lanes=LANES,
                                                 subseq_len=CUE["subseq_len"], device="cpu")
    if scenario.startswith("acer"):
        config.target_update_interval = 32
    if scenario == "sac":
        config.target_update_interval = 48
    return OffPolicyRunner(runner.env.env, runner.core, buffer, config, device="cpu", mesh=mesh)


def tensors(tree, prefix=""):
    """Every tensor of a state (modules' parameters and buffers, dataclass
    fields, dicts, lists), by a dotted name, cloned."""
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().clone()
    elif isinstance(tree, torch.nn.Module):
        out.update({f"{prefix}.{k}": v.detach().clone() for k, v in tree.state_dict().items()})
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out.update(tensors(getattr(tree, f.name), f"{prefix}.{f.name}"))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tensors(v, f"{prefix}.{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(tensors(v, f"{prefix}.{i}"))
    return out


def _collect(runner, state, metrics):
    """A run's state: ``learned`` (the train state's tensors, on every rank
    alike), ``metrics``, ``replicated`` (the returns ring and a buffer's
    replicated tables), ``local`` (this rank's lanes: observations, the
    carry, the buffer's storage rows) and counters."""
    replay = getattr(state, "replay_state", None)
    local = {"obs": state.obs.clone(), **tensors(state.act_state, "act_state")}
    replicated = {"recent_returns": state.recent_returns.clone(), "recent_count": state.recent_count.clone(),
                  "episode_return": state.episode_return.clone()}
    if replay is not None:
        for name, value in tensors(replay, "replay").items():
            name = name.replace(".local.", ".")  # a sharded ring's rows: its own ring
            (local if ".storage." in name else replicated)[name] = value
        ring = getattr(replay, "base", replay)
        if hasattr(ring, "local"):  # the whole ring's cursor, not this rank's ring's
            replicated["replay.base.cursor" if ring is not replay else "replay.cursor"] = ring.cursor.clone()
    n_updates = getattr(state.train_state, "n_updates", None)
    return {"t": state.t, "learned": tensors(state.train_state, "train"), "metrics": dict(metrics),
            "replicated": replicated, "local": local, "n_updates": int(n_updates)}


def _snapshot_run(setup, mesh):
    """``snapshot``: the runner uninterrupted, and the same run interrupted
    by a snapshot and resumed into a fresh runner."""
    def fresh():
        runner = build_core("snapshot", setup, mesh)
        return runner, runner.init(0, draws=Draws(torch.Generator().manual_seed(0)))

    runner, state = fresh()
    state, metrics = runner.run_chunk(state, 2 * SNAPSHOT_STEPS)
    whole = _collect(runner, state, metrics)
    runner, state = fresh()
    state, _ = runner.run_chunk(state, SNAPSHOT_STEPS)
    save_runner_snapshot(state, setup["snapshot_dir"], mesh)
    runner = build_core("snapshot", setup, mesh)
    template = runner.init(1, draws=Draws(torch.Generator().manual_seed(1)))
    state = load_runner_snapshot(template, setup["snapshot_dir"], mesh)
    state, metrics = runner.run_chunk(state, SNAPSHOT_STEPS)
    return {"whole": whole, "resumed": _collect(runner, state, metrics), "draws": []}


def denominator_batch() -> EpisodeBatch:
    """Four DelayedCue windows of 4 steps: the first two (rank 0's share of
    two ranks) all valid, the other two (rank 1's) valid for one step."""
    rs = np.random.RandomState(5)
    B, T = 4, 4

    def f(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32))

    lengths = torch.tensor([4, 4, 1, 1], dtype=torch.int32)
    mask = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.float32)
    transitions = Transition(obs=f(B, T, 13), action=torch.from_numpy(rs.randint(0, 2, (B, T)).astype(np.int32)),
                             reward=f(B, T), next_obs=f(B, T, 13), terminated=torch.zeros(B, T, dtype=torch.bool),
                             done=torch.zeros(B, T, dtype=torch.bool), extras={})
    zeros = torch.zeros(B, dtype=torch.int32)
    return EpisodeBatch(transitions=transitions, mask=mask, lengths=lengths, rows=zeros, offsets=zeros)


def run_denominator(mesh=None):
    """``denominator``: one DRQN update on :func:`denominator_batch` from
    seeded weights, through the data-parallel update under ``mesh``."""
    torch.set_num_threads(1)
    core = build_core("drqn", None).core
    state = core.init(torch.Generator().manual_seed(0), torch.zeros(LANES, 13))
    batch = denominator_batch()
    if mesh is None:
        _, aux = core.update_episodic(state, batch)
    else:
        core = data_parallel_core(core, mesh)
        _, aux = data_parallel_update(mesh, core.update_episodic, summed_metrics(core))(state, batch)
    return {"loss": aux["loss"], "errors": aux["errors"], "learned": tensors(state, "train"), "draws": []}


def run_core(scenario, setup, mesh=None):
    """A run of one of :data:`CORES` from ``setup``'s train state."""
    torch.set_num_threads(1)
    if scenario == "snapshot":
        return _snapshot_run(setup, mesh)
    if scenario == "denominator":
        return run_denominator(mesh)
    runner = build_core(scenario, setup, mesh)
    draws = NumpyDraws(0)
    state = runner.init(0, draws=draws)
    state.train_state = setup["train_state"]
    if scenario in ONPOLICY:
        state, metrics = runner.run_iterations(state, CORES[scenario])
    else:
        state, metrics = runner.run_chunk(state, CORES[scenario])
    out = _collect(runner, state, metrics)
    out.update(draws=[k for k, _ in draws.log], log=draws.log)
    if scenario == "drqn":  # 8 evaluation episodes, 4 on each of two ranks
        loop = EvalLoop(runner.env.env, runner.core, 8, 12, device="cpu", mesh=mesh)
        out["eval"] = torch.from_numpy(loop.evaluate(state.train_state, NumpyDraws(1)))
    return out


def _ring(replay):
    ring = getattr(replay, "base", replay)
    return getattr(ring, "local", ring)


def run(scenario, setup, mesh=None):
    """The run's final state, as plain tensors."""
    if scenario in CORES or scenario in ("snapshot", "denominator"):
        return run_core(scenario, setup, mesh)
    torch.set_num_threads(1)
    runner = build(scenario, setup, mesh)
    draws = NumpyDraws(0)
    state = runner.init(0, draws=draws)
    state.train_state = setup["train_state"]
    if scenario == "ppo":
        state, metrics = runner.run_iterations(state, ITERATIONS)
    else:
        state, metrics = runner.run_chunk(state, STEPS)
    train = state.train_state
    out = {
        "t": state.t, "metrics": metrics, "obs": state.obs,
        "recent_returns": state.recent_returns, "recent_count": state.recent_count,
        "episode_return": state.episode_return, "n_updates": train.n_updates,
        "params": {f"model.{k}": v.detach().clone() for k, v in train.model.named_parameters()},
        "draws": [k for k, _ in draws.log], "log": draws.log,
    }
    opt = train.opt_state
    for name in ("mu", "nu"):
        out["params"].update({f"{name}.{i}": m.clone() for i, m in enumerate(getattr(opt, name, None) or [])})
    if scenario != "ppo":
        out["params"].update({f"target.{k}": v.detach().clone() for k, v in train.target_model.named_parameters()})
        ring = _ring(state.replay_state)
        out["ring"] = {k: ring.storage[k].clone() for k in ("obs", "action", "reward", "done", "terminated")}
        out["cursor"] = int(state.replay_state.cursor)
    if scenario == "per":
        out["trees"] = {k: getattr(state.replay_state, k).clone() for k in ("tree", "min_tree", "max_priority",
                                                                           "beta")}
    return out


def main(argv):
    scenario, setup_path, out_path = argv[:3]
    setup = torch.load(setup_path, weights_only=False)
    mesh = None
    if len(argv) > 3:
        rank, world, port = (int(a) for a in argv[3:6])
        initialize_multihost(f"localhost:{port}", max(world, 1), rank, device="cpu", timeout_s=120)
        mesh = make_mesh(("dp",))
    try:
        out = run(scenario, setup, mesh)
        out.update(lanes=local_lane_slice(LANES), primary=is_primary(), mesh=mesh)
        torch.save(out, out_path)
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
