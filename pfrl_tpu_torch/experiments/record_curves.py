"""Learning curves of the device recipes, trained to their successful scores
(counterpart of ``tools/record_curves.py``).

``python -m pfrl_tpu_torch.experiments.record_curves [names ...] [--outdir
DIR] [--seed N]`` trains each named recipe of :data:`RUNS` (default: all 21)
on the CUDA device and writes, under ``--outdir``
(default ``results/curves_torch``):

- ``<name>/scores.txt``: one row per evaluation, the JAX tool's TSV
  (``steps episodes elapsed mean median stdev max min``, :class:`ScoreWriter`);
- ``zoo/<alg>/<env>/best/train_state.msgpack``: the best evaluation's train
  state in the JAX package's layout (:func:`save_zoo`), which
  ``pfrl_tpu.replay.persistent.load_state`` reads and
  :mod:`pfrl_tpu_torch.experiments.zoo` converts back.

Each recipe is the JAX recipe's settings over the port's builder
(``cartpole_value``, ``mujoco_actor_critic``, ``onpolicy``, ``recurrent``,
``acer``; TD3-Pendulum from the TD3 core directly, as no builder has its
learning rate): lanes, steps, evaluation cadence and episodes,
``successful_score``, ``min_rows``, seed, ring and cadence, optimizers and
explorer schedules. :func:`curve_loop` moves an off-policy runner by
``eval_every // num_envs`` scan steps and an on-policy runner by the
recipe's iterations, evaluates with ``EvalLoop`` on draws seeded by ``t``
after each chunk, and stops at the first evaluation whose mean reaches
``successful_score`` once ``min_rows`` rows exist, or at ``steps``.
``reinforce_cartpole`` trains through the host driver
(``train_agent_with_evaluation``), which writes its own ``scores.txt``.

A run resumes: after every evaluation the whole runner state goes to
``<name>/.resume/`` (the runner snapshot, with the draw source's state)
beside the best evaluation's train state and mean (each file written
whole, then renamed into place), so a run that is cut, for example by
``timeout``, starts again from its last evaluation when the same command is
run again, appends to the same ``scores.txt`` and never replaces a better
best. The
resume files are removed when the run ends. ``--seed`` replaces the
recipe's seed (REINFORCE: the agent's; its envs keep seeds 1 and 2).
Nothing is written outside ``--outdir``.
"""

import argparse
import copy
import dataclasses
import functools
import json
import os
import shutil
import statistics
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from pfrl_tpu_torch import convert
from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.agents.snapshot import load_runner_snapshot, save_runner_snapshot
from pfrl_tpu_torch.agents.td3 import TD3Core
from pfrl_tpu_torch.experiments import acer, cartpole_value, mujoco_actor_critic as mac, onpolicy, recurrent
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.explorers.additive_gaussian import AdditiveGaussian
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.state_action_q_functions import FCSAQFunction
from pfrl_tpu_torch.replay.persistent import load_state, save_state
from pfrl_tpu_torch.utils.draws import Draws

COLUMNS = ("steps", "episodes", "elapsed", "mean", "median", "stdev", "max", "min")
DEFAULT_OUTDIR = os.path.join("results", "curves_torch")


class ScoreWriter:
    """``<outdir>/scores.txt``: the header, unless ``resume`` finds the file,
    then one row per :meth:`record` (``elapsed`` from construction)."""

    def __init__(self, outdir: str, resume: bool = False):
        os.makedirs(outdir, exist_ok=True)
        self.path = os.path.join(outdir, "scores.txt")
        if not (resume and os.path.exists(self.path)):
            with open(self.path, "w") as f:
                f.write("\t".join(COLUMNS) + "\n")
        self.t0 = time.time()

    def record(self, steps: int, episodes: int, returns) -> float:
        """Appends the row of ``returns``; returns their mean."""
        rs = [float(r) for r in returns]
        stdev = statistics.stdev(rs) if len(rs) > 1 else 0.0
        row = (steps, episodes, time.time() - self.t0, statistics.mean(rs), statistics.median(rs), stdev, max(rs),
               min(rs))
        with open(self.path, "a") as f:
            f.write("\t".join(str(v) for v in row) + "\n")
        return statistics.mean(rs)


def save_zoo(core, train_state, alg: str, env_name: str, root: str) -> str:
    """``train_state`` of ``core`` as ``<root>/zoo/<alg>/<env_name>/best/
    train_state.msgpack`` in the JAX package's layout; returns its directory."""
    d = os.path.join(root, "zoo", alg, env_name, "best")
    convert.save_flax_checkpoint(core, train_state, os.path.join(d, "train_state.msgpack"))
    return d


def _snapshot(state):
    """The runner state to save: an on-policy state without its rollout,
    which every iteration writes whole before its update reads it."""
    return dataclasses.replace(state, rollout=None) if hasattr(state, "rollout") else state


def curve_loop(
    name: str,
    runner,
    evaluator: EvalLoop,
    *,
    steps: int,
    eval_every: int,
    outdir: str,
    zoo_entry: Optional[Tuple[str, str]] = None,
    successful_score: Optional[float] = None,
    iters_per_eval: Optional[int] = None,
    seed: int = 0,
    min_rows: int = 1,
    draws: Optional[Callable[[int], Any]] = None,
    pause: Optional[Callable[[int], bool]] = None,
) -> dict:
    """Train -> evaluate -> record until ``steps`` or the successful score
    (see the module's note). An off-policy runner runs ``eval_every //
    num_envs`` scan steps a chunk, an on-policy one ``iters_per_eval``
    iterations. ``draws(seed)`` makes the draw source of ``runner.init`` and
    of the evaluation after each chunk (seeded ``t``); by default a
    generator on the runner's device. ``pause(n)``, asked after the ``n``-th
    evaluation of this call, returns early as a run cut there would end:
    the resume files kept, no zoo entry written.

    Returns ``{"best", "last", "rows", "t", "episodes", "solved", "paused",
    "seconds"}`` (``rows`` counts the whole ``scores.txt``, a resumed run's
    earlier rows too; ``seconds`` this call's)."""
    t_start = time.time()
    make = draws or (lambda s: Draws(torch.Generator(device=runner.device).manual_seed(s)))
    run_dir = os.path.join(outdir, name)
    resume_dir = os.path.join(run_dir, ".resume")
    best_path = os.path.join(resume_dir, "best_train_state.pt")
    best_meta_path = os.path.join(resume_dir, "best.json")
    state = runner.init(seed, draws=make(seed))
    resuming = os.path.exists(os.path.join(resume_dir, "runner_state.pt"))
    if resuming:
        state = load_runner_snapshot(_snapshot(state), resume_dir)
        print(f"{name}: resuming at step {state.t}", flush=True)
    writer = ScoreWriter(run_dir, resume=resuming)
    if iters_per_eval is not None:
        step = lambda s: runner.run_iterations(s, iters_per_eval)[0]  # noqa: E731
    else:
        step = lambda s: runner.run_chunk(s, eval_every // runner.config.num_envs)[0]  # noqa: E731
    best, best_state = float("-inf"), state.train_state
    if resuming and os.path.exists(best_meta_path):
        # A run resumed must not let a worse evaluation after the cut
        # replace the best from before it.
        with open(best_meta_path) as f:
            best = float(json.load(f)["best"])
        best_state = load_state(copy.deepcopy(state.train_state), best_path)
        print(f"{name}: restored best eval mean {best:.1f}", flush=True)
    mean, evals, solved = float("nan"), 0, False
    while state.t < steps:
        state = step(state)
        t = state.t
        returns = evaluator.evaluate(state.train_state, make(t))
        mean = writer.record(t, int(state.recent_count), returns)
        evals += 1
        print(f"{name} step {t} mean R {mean:.1f}", flush=True)
        save_runner_snapshot(_snapshot(state), resume_dir)
        if mean > best:
            best, best_state = mean, copy.deepcopy(state.train_state)  # the runner updates in place
            save_state(best_state, best_path)
            with open(best_meta_path, "w") as f:
                json.dump({"best": best}, f)
        with open(writer.path) as f:
            n_rows = sum(1 for _ in f) - 1
        if successful_score is not None and mean >= successful_score and n_rows >= min_rows:
            print(f"{name}: successful_score {successful_score} reached", flush=True)
            solved = True
            break
        if pause is not None and state.t < steps and pause(evals):
            return _result(best, mean, writer.path, state, solved, True, t_start)
    if zoo_entry is not None:
        save_zoo(runner.core, best_state, *zoo_entry, root=outdir)
    shutil.rmtree(resume_dir, ignore_errors=True)
    return _result(best, mean, writer.path, state, solved, False, t_start)


def _result(best, last, path, state, solved, paused, t_start) -> dict:
    with open(path) as f:
        rows = sum(1 for _ in f) - 1
    return {"best": best, "last": last, "rows": rows, "t": state.t, "episodes": int(state.recent_count),
            "solved": solved, "paused": paused, "seconds": time.time() - t_start}


# ----------------------------------------------------------------- recipes
@dataclasses.dataclass
class Curve:
    """A device recipe: the runner and its evaluation, and the arguments of
    :func:`curve_loop`."""

    runner: Any
    evaluator: EvalLoop
    steps: int
    eval_every: int
    zoo_entry: Tuple[str, str]
    successful_score: Optional[float] = None
    min_rows: int = 1
    seed: int = 0
    iters_per_eval: Optional[int] = None  # on-policy runners


@dataclasses.dataclass
class HostCurve:
    """``reinforce_cartpole``: the agent, built from ``seed`` on first use,
    and the arguments of ``train_agent_with_evaluation``."""

    make_agent: Callable[[int], Any]
    env: Any
    eval_env: Any
    steps: int
    eval_n_episodes: int
    eval_interval: int
    successful_score: float
    train_max_episode_len: int
    zoo_entry: Tuple[str, str]
    seed: int = 0

    @functools.cached_property
    def agent(self):
        return self.make_agent(self.seed)


def _dqn_cartpole(device):
    runner, ev = cartpole_value.make_dqn_cartpole_runner(decay_steps=200_000 // 4, device=device)
    return Curve(runner, ev, 200_000, 10_000, ("dqn", "cartpole"), 500.0, seed=1)


def _dqn_cartpole_bf16(device):
    runner, ev = cartpole_value.make_dqn_cartpole_bf16_runner(decay_steps=200_000 // 4, device=device)
    return Curve(runner, ev, 200_000, 10_000, ("dqn_bf16", "cartpole"), 500.0, min_rows=5,
                 seed=cartpole_value.DQN_BF16_SEED)


def _c51_cartpole(device):
    runner, ev = cartpole_value.make_c51_cartpole_runner(decay_steps=200_000 // 4, device=device)
    return Curve(runner, ev, 200_000, 10_000, ("c51", "cartpole"), 500.0)


def _pendulum_eval(runner, device) -> EvalLoop:
    return EvalLoop(mac.pendulum_env(device), runner.core, 10, 201, device=device)


def _sac_pendulum(device, compute_dtype=None, zoo=("sac", "pendulum")):
    runner = mac.make_sac_pendulum_runner(device=device, compute_dtype=compute_dtype)
    return Curve(runner, _pendulum_eval(runner, device), 100_000, 5_000, zoo)


def _sac_pendulum_bf16(device):
    return _sac_pendulum(device, torch.bfloat16, ("sac_bf16", "pendulum"))


def _ddpg_pendulum(device):
    runner = mac.make_ddpg_runner(device=device)
    return Curve(runner, _pendulum_eval(runner, device), 100_000, 5_000, ("ddpg", "pendulum"))


def _ppo_pendulum(device):
    runner = onpolicy.make_ppo_pendulum_runner(device=device)
    ev = EvalLoop(onpolicy.time_limited_pendulum(device), runner.core, 10, 201, device=device)
    return Curve(runner, ev, 500_000, 10_000, ("ppo", "pendulum"), iters_per_eval=max(1, 10_000 // (16 * 128)))


def _drqn_po_abc(device):
    runner, ev = recurrent.make_drqn_po_abc_runner(device=device)
    return Curve(runner, ev, 60_000, 2_000, ("drqn", "po_abc"), 1.0, min_rows=5)


def _iqn_cartpole(device):
    runner, ev = cartpole_value.make_iqn_cartpole_runner(decay_steps=200_000 // 4, device=device)
    return Curve(runner, ev, 200_000, 10_000, ("iqn", "cartpole"), 500.0, min_rows=5)


def _td3_pendulum(device):
    env = mac.pendulum_env(device)
    qf = lambda: FCSAQFunction(3, 1, 64, 2)  # noqa: E731
    core = TD3Core(
        policy=mac.deterministic_policy(3, 1, 64), q_func1=qf(), q_func2=qf(), policy_optimizer=Adam(1e-3),
        q_func1_optimizer=Adam(1e-3), q_func2_optimizer=Adam(1e-3),
        explorer=AdditiveGaussian(0.1, low=-1.0, high=1.0), gamma=0.99, policy_update_delay=2,
        burnin_action_func=mac.uniform_burnin(1), burnin_steps=1_000,
    )
    runner = mac._runner(env, core, num_envs=16, capacity=100_000, replay_start_size=1_000, update_interval=4,
                         minibatch_size=128)
    return Curve(runner, _pendulum_eval(runner, device), 100_000, 5_000, ("td3", "pendulum"), -150.0, min_rows=5)


def _trpo_pendulum(device):
    runner = onpolicy.make_trpo_pendulum_runner(device=device)
    ev = EvalLoop(onpolicy.time_limited_pendulum(device), runner.core, 10, 201, device=device)
    return Curve(runner, ev, 500_000, 10_000, ("trpo", "pendulum"), -150.0, min_rows=5,
                 iters_per_eval=max(1, 10_000 // (16 * 128)))


def _acer_abc(device):
    runner, ev = acer.make_acer_abc_runner(device=device)
    return Curve(runner, ev, 60_000, 4_000, ("acer", "abc"), 1.0, min_rows=5)


def _drqn_delayed_cue(device):
    runner, ev = recurrent.make_drqn_delayed_cue_runner(device=device)
    return Curve(runner, ev, 60_000, 3_000, ("drqn", "delayed_cue"), 1.0, min_rows=6, seed=3)


def _rppo_delayed_cue(device):
    runner, ev = recurrent.make_rppo_delayed_cue_runner(device=device)
    return Curve(runner, ev, 120_000, 16 * 24, ("rppo", "delayed_cue"), 1.0, min_rows=6, seed=1, iters_per_eval=1)


def _riqn_delayed_cue(device):
    runner, ev = recurrent.make_riqn_delayed_cue_runner(device=device)
    return Curve(runner, ev, 80_000, 640, ("riqn", "delayed_cue"), 1.0, min_rows=6, seed=3)


def _rtrpo_delayed_cue(device):
    runner, ev = recurrent.make_rtrpo_delayed_cue_runner(device=device)
    return Curve(runner, ev, 160_000, 16 * 24 * 4, ("rtrpo", "delayed_cue"), 1.0, min_rows=6, seed=1,
                 iters_per_eval=4)


def _rainbow_cartpole(device):
    runner, ev = cartpole_value.make_rainbow_cartpole_runner(betasteps=300_000, device=device)
    return Curve(runner, ev, 300_000, 10_000, ("rainbow", "cartpole"), 475.0, min_rows=5)


def _acer_continuous_abc(device):
    runner, ev = acer.make_acer_continuous_abc_runner(device=device)
    return Curve(runner, ev, 120_000, 6_000, ("acer_continuous", "abc"), 1.0, min_rows=5)


def _al_cartpole(device):
    runner, ev = cartpole_value.make_al_cartpole_runner(decay_steps=200_000 // 4, device=device)
    return Curve(runner, ev, 200_000, 10_000, ("al", "cartpole"), 475.0, min_rows=5, seed=2)


def _a2c_cartpole(device):
    runner = onpolicy.make_a2c_cartpole_runner(device=device)
    ev = EvalLoop(onpolicy.time_limited_cartpole(device), runner.core, 10, 501, device=device)
    return Curve(runner, ev, 2_000_000, 20_000, ("a2c", "cartpole"), 500.0, min_rows=5,
                 iters_per_eval=max(1, 20_000 // (32 * 8)))


def _reinforce_cartpole(device):
    """The agent on ``device``; its envs, the port's CartPole behind the
    host protocol, on the CPU (seeds 1 and 2, as the JAX recipe's)."""
    from pfrl_tpu_torch.experiments import reinforce_gym

    make_agent = lambda seed: reinforce_gym.make_reinforce_agent(beta=0.0, seed=seed, device=device)  # noqa: E731
    return HostCurve(make_agent, reinforce_gym.make_cartpole_env(seed=1, device="cpu"),
                     reinforce_gym.make_cartpole_env(seed=2, device="cpu"), steps=150_000, eval_n_episodes=10,
                     eval_interval=10_000, successful_score=500.0, train_max_episode_len=500,
                     zoo_entry=("reinforce", "cartpole"))


# The JAX tool's ``RUNS``, in its order: name -> recipe of ``device``.
RUNS: Dict[str, Callable] = {
    "dqn_cartpole": _dqn_cartpole,
    "dqn_cartpole_bf16": _dqn_cartpole_bf16,
    "c51_cartpole": _c51_cartpole,
    "sac_pendulum": _sac_pendulum,
    "sac_pendulum_bf16": _sac_pendulum_bf16,
    "ddpg_pendulum": _ddpg_pendulum,
    "ppo_pendulum": _ppo_pendulum,
    "drqn_po_abc": _drqn_po_abc,
    "iqn_cartpole": _iqn_cartpole,
    "td3_pendulum": _td3_pendulum,
    "trpo_pendulum": _trpo_pendulum,
    "acer_abc": _acer_abc,
    "drqn_delayed_cue": _drqn_delayed_cue,
    "rppo_delayed_cue": _rppo_delayed_cue,
    "riqn_delayed_cue": _riqn_delayed_cue,
    "rtrpo_delayed_cue": _rtrpo_delayed_cue,
    "rainbow_cartpole": _rainbow_cartpole,
    "acer_continuous_abc": _acer_continuous_abc,
    "al_cartpole": _al_cartpole,
    "a2c_cartpole": _a2c_cartpole,
    "reinforce_cartpole": _reinforce_cartpole,
}


def _run_host(name: str, curve: HostCurve, outdir: str) -> dict:
    """``reinforce_cartpole`` through the host driver; its zoo entry is the
    final agent's train state, as the JAX recipe saves it."""
    from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation

    t0 = time.time()
    run_dir = os.path.join(outdir, name)
    agent, history = train_agent_with_evaluation(
        curve.agent, curve.env, steps=curve.steps, eval_n_steps=None, eval_n_episodes=curve.eval_n_episodes,
        eval_interval=curve.eval_interval, outdir=run_dir, successful_score=curve.successful_score,
        train_max_episode_len=curve.train_max_episode_len, eval_env=curve.eval_env,
    )
    save_zoo(agent.core, agent.train_state, *curve.zoo_entry, root=outdir)
    means = [h["eval_score"] for h in history]
    return {"best": max(means, default=float("nan")), "last": means[-1] if means else float("nan"),
            "rows": len(means), "t": agent.t, "episodes": None,
            "solved": bool(means) and means[-1] >= curve.successful_score, "paused": False, "seconds": time.time() - t0}


def run(name: str, outdir: str = DEFAULT_OUTDIR, device=None, seed: Optional[int] = None,
        pause: Optional[Callable[[int], bool]] = None) -> dict:
    """Trains the recipe ``name`` on ``device`` (default: the CUDA device)
    with its seed or ``seed``; returns :func:`curve_loop`'s result with the
    recipe's ``"name"``, ``"seed"``, ``"steps"`` cap and ``"zoo_entry"``."""
    device = resolve_device(device)
    curve = RUNS[name](device)
    curve.seed = curve.seed if seed is None else seed
    if isinstance(curve, HostCurve):
        result = _run_host(name, curve, outdir)
    else:
        result = curve_loop(
            name, curve.runner, curve.evaluator, steps=curve.steps, eval_every=curve.eval_every, outdir=outdir,
            zoo_entry=curve.zoo_entry, successful_score=curve.successful_score, iters_per_eval=curve.iters_per_eval,
            seed=curve.seed, min_rows=curve.min_rows, pause=pause,
        )
    return {"name": name, "seed": curve.seed, "steps": curve.steps, "zoo_entry": list(curve.zoo_entry), **result}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train the learning-curve recipes to their successful scores.")
    parser.add_argument("names", nargs="*", metavar="name", help="recipes to train (default: all): " + ", ".join(RUNS))
    parser.add_argument("--outdir", default=DEFAULT_OUTDIR,
                        help="where <name>/scores.txt and zoo/<alg>/<env>/best/ go (default %(default)s)")
    parser.add_argument("--seed", type=int, default=None, help="replaces each recipe's seed")
    return parser


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict[str, dict]:
    """Each named recipe in turn; prints one JSON line of its result."""
    parser = build_parser()
    args = parser.parse_args(argv)
    unknown = [n for n in args.names if n not in RUNS]
    if unknown:
        parser.error(f"unknown recipes {unknown}; choose from {list(RUNS)}")
    device = resolve_device(device)
    results = {}
    for name in args.names or list(RUNS):
        results[name] = run(name, args.outdir, device, args.seed)
        print("curve " + json.dumps(results[name]), flush=True)
    return results


if __name__ == "__main__":
    main()
