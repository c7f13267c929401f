"""One rank of a small mesh run of the port's runners, for
``test_torch_multidevice.py`` (not a test module: it imports no JAX and is
started as a script, one process per rank).

    python tests/torch_mesh_worker.py SCENARIO SETUP OUT [RANK WORLD PORT]

``SCENARIO`` is ``uniform`` (DQN-CartPole over the uniform ring), ``per``
(the same core over 3-step PER) or ``ppo`` (PPO on MujocoSim); ``SETUP``
a ``torch.save`` file with the starting train state (and MujocoSim's
matrices); ``OUT`` where this rank's result is saved. Without ``RANK``
the run is single-process, with no mesh; with ``WORLD`` 0 it is a mesh of
one rank over Gloo. Every rank draws from the same seeded numpy stream
(:class:`NumpyDraws`, the parity tests' ``LoggedDraws`` with ``randint``
and ``permutation``), so the draws equal the single-process run's.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pfrl_tpu_torch import envs as tenvs  # noqa: E402
from pfrl_tpu_torch.experiments import cartpole_value as cv  # noqa: E402
from pfrl_tpu_torch.experiments import onpolicy as onp  # noqa: E402
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner  # noqa: E402
from pfrl_tpu_torch.experiments.runner import OffPolicyRunner  # noqa: E402
from pfrl_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from pfrl_tpu_torch.parallel.multihost import initialize_multihost, is_primary, local_lane_slice, shutdown  # noqa: E402
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer  # noqa: E402

LANES, HIDDEN, BATCH, CAPACITY, START, SYNC_EVERY, DECAY, LIMIT, STEPS = 4, 16, 8, 40, 12, 24, 40, 10, 11
SMALL = dict(num_envs=LANES, capacity=CAPACITY, replay_start_size=START, update_interval=2,
             target_update_interval=SYNC_EVERY, minibatch_size=BATCH)
PER = dict(alpha=0.5, beta0=0.4, betasteps=100, num_steps=3, gamma=0.99, num_lanes=LANES)
PPO_ROLLOUT, PPO_MINIBATCH, PPO_EPISODE, ITERATIONS = 16, 16, 12, 3


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
    if scenario in ("uniform", "per"):
        env = tenvs.TimeLimit(tenvs.CartPole(device="cpu"), LIMIT)
        recipe, _ = cv.make_dqn_cartpole_runner(env=env, device="cpu", hidden=HIDDEN, decay_steps=DECAY, **SMALL)
        buffer = PrioritizedReplayBuffer(CAPACITY, device="cpu", **PER) if scenario == "per" else recipe.buffer
        return OffPolicyRunner(env, recipe.core, buffer, recipe.config, device="cpu", mesh=mesh)
    env = tenvs.MujocoSim(A=setup["A"], B=setup["B"], episode_len=PPO_EPISODE, device="cpu")
    recipe = onp.make_ppo_runner(num_envs=LANES, rollout_len=PPO_ROLLOUT, epochs=2, minibatch_size=PPO_MINIBATCH,
                                 hidden=HIDDEN, env=env)
    return OnPolicyRunner(env, recipe.core, LANES, PPO_ROLLOUT, device="cpu", mesh=mesh)


def _ring(replay):
    ring = getattr(replay, "base", replay)
    return getattr(ring, "local", ring)


def run(scenario, setup, mesh=None):
    """The run's final state, as plain tensors."""
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
