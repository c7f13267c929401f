"""``examples/optuna/optuna_dqn_cartpole.py``: a hyperparameter search over
DQN on the time-limited CartPole.

:func:`objective` is the example's (``:33-81``): it draws the learning rate
(1e-4 to 1e-2, log), the hidden width (32, 64 or 128), the hidden layers (1
to 3), the transitions per update (8, 16, 32 or 64), the final epsilon
(0.01 to 0.2) and gamma (0.9 to 0.999) from ``trial``, builds ``DQNCore``
over ``FCStateQFunctionWithDiscreteAction`` with Adam, epsilon 1 -> the
final one over ``--steps // 2`` transitions, 32 lanes of
``TimeLimit(CartPole(), 500)``, a 10^5-slot ring, batch-64 updates from
1,024 on and hard syncs every 2,048, then runs 5 chunks of ``--steps // 5
// 32`` scan steps, after each reporting the mean return of ``EvalLoop``
10 x 500 (seeded with the report's index) at ``t`` and asking whether to
prune. ``trial`` is any object with ``suggest_float``,
``suggest_categorical``, ``suggest_int``, ``report``, ``should_prune`` and
``number``; the runner is seeded with ``trial.number``.

:func:`run` is the example's ``main``: without ``optuna`` the example's
``SystemExit``; ``--demo``/``--load`` evaluate a saved train state of the
default architecture (hidden 64 x 2) through ``demo_cli``; else an optuna
study with median pruning over ``--n-trials`` trials.
"""

import argparse
from typing import Optional, Sequence

import torch

from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.experiments.onpolicy import time_limited_cartpole
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.epsilon_greedy import ConstantEpsilonGreedy, LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.state_q_functions import FCStateQFunctionWithDiscreteAction
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.draws import Draws

NUM_ENVS, N_REPORTS = 32, 5
EVAL_EPISODES, EVAL_STEPS = 10, 500
MISSING_OPTUNA = "this example requires `pip install optuna`"


def _runner(core, gamma: float, update_interval: int, capacity: int, device) -> OffPolicyRunner:
    env = time_limited_cartpole(device)
    buffer = ReplayBuffer(capacity, gamma=gamma, num_lanes=NUM_ENVS, device=env.device)
    config = RunnerConfig(num_envs=NUM_ENVS, replay_start_size=1024, update_interval=update_interval,
                          target_update_interval=2048, minibatch_size=64)
    return OffPolicyRunner(env, core, buffer, config, device=env.device)


def objective(trial, args, device=None, draws=None) -> float:
    """The example's objective for ``trial`` on ``device`` (default: the
    CUDA device); ``draws`` replaces the runner's and the evaluations' draw
    sources (default: generators seeded with ``trial.number`` and the
    report's index). Returns the last report's score."""
    lr = trial.suggest_float("lr", 1e-4, 1e-2, log=True)
    hidden = trial.suggest_categorical("n_hidden_channels", [32, 64, 128])
    layers = trial.suggest_int("n_hidden_layers", 1, 3)
    update_per = trial.suggest_categorical("update_per", [8, 16, 32, 64])
    final_eps = trial.suggest_float("final_epsilon", 0.01, 0.2)
    gamma = trial.suggest_float("gamma", 0.9, 0.999)

    core = DQNCore(
        model=FCStateQFunctionWithDiscreteAction(4, 2, n_hidden_layers=layers, n_hidden_channels=hidden),
        optimizer=Adam(lr),
        explorer=LinearDecayEpsilonGreedy(1.0, final_eps, args.steps // 2, 2),
        gamma=gamma,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
    )
    runner = _runner(core, gamma, update_per, 10**5, device)
    evaluator = EvalLoop(time_limited_cartpole(runner.device), core, EVAL_EPISODES, EVAL_STEPS, device=runner.device)
    state = runner.init(trial.number, draws=draws)
    for i in range(N_REPORTS):
        state, _ = runner.run_chunk(state, args.steps // N_REPORTS // NUM_ENVS)
        eval_draws = draws or Draws(torch.Generator(device=runner.device).manual_seed(i))
        score = float(evaluator.evaluate(state.train_state, eval_draws).mean())
        trial.report(score, state.t)
        if trial.should_prune():
            import optuna

            raise optuna.TrialPruned()
    return score


def build_parser() -> argparse.ArgumentParser:
    """The example's flags (``:89-95``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--n-trials", type=int, default=30)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--steps", type=int, default=60_000)
    add_demo_args(parser)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None):
    """The example's ``main`` with ``argv``'s flags on ``device`` (default:
    the CUDA device). Returns the study, or ``None`` after ``--demo``."""
    from pfrl_tpu_torch.experiments.demo_cli import maybe_load_train_state, run_demo_if_requested

    try:
        import optuna
    except ImportError:
        raise SystemExit(MISSING_OPTUNA)

    args = build_parser().parse_args(argv)
    if args.demo or args.load:
        core = DQNCore(
            model=FCStateQFunctionWithDiscreteAction(4, 2, n_hidden_layers=2, n_hidden_channels=64),
            optimizer=Adam(1e-3),
            explorer=ConstantEpsilonGreedy(0.0, 2),
            gamma=0.99,
            compute_dtype=torch.bfloat16 if args.bf16 else None,
        )
        runner = _runner(core, 0.99, 32, 10**4, device)
        state = maybe_load_train_state(runner.init(0), args.load, core)
        evaluator = EvalLoop(time_limited_cartpole(runner.device), core, EVAL_EPISODES, EVAL_STEPS,
                             device=runner.device)
        if run_demo_if_requested(args, evaluator, state.train_state):
            return None
    study = optuna.create_study(direction="maximize", pruner=optuna.pruners.MedianPruner(n_warmup_steps=2))
    study.optimize(lambda t: objective(t, args, device), n_trials=args.n_trials)
    print("best value:", study.best_value)
    print("best params:", study.best_params)
    return study


if __name__ == "__main__":
    run()
