"""``--load`` / ``--demo`` / ``--save-to`` for the runner examples
(counterpart of ``pfrl_tpu/experiments/demo_cli.py``; reference parity:
examples/atari/reproduction/dqn/train_dqn.py:83-88,200-214).

    add_demo_args(parser)
    ...
    state = runner.init(seed)
    state = maybe_load_train_state(state, args.load, runner.core)
    if run_demo_if_requested(args, eval_loop, state.train_state, seed):
        return
    ... training ...
    save_train_state_if_requested(state.train_state, args.save_to, runner.core)

``--save-to`` writes ``train_state.pt``
(:func:`~pfrl_tpu_torch.replay.persistent.save_state`) and, where the recipe
passes its core, ``train_state.msgpack`` beside it: the JAX package's
layout (:func:`pfrl_tpu_torch.convert.save_flax_checkpoint`), which a JAX
run's ``--load`` reads. ``--load`` takes either, or a JAX
``train_state.msgpack`` (a ``zoo/`` entry, a JAX run's ``--save-to``)
through the port's own msgpack reader and the converter of the runner's
core, with no JAX installed; ``train_state.pt`` is preferred where both are
present. Either way the runner's freshly initialised train state is the
template: a leaf of another shape or dtype raises, and nothing is left half
loaded in its place.
"""

import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "add_demo_args",
    "resolve_train_state_path",
    "load_train_state",
    "maybe_load_train_state",
    "demo_returns",
    "run_demo_if_requested",
    "print_demo_line",
    "save_train_state_if_requested",
    "run_device_example",
    "run_command",
]

_STATE_FILE = "train_state.pt"
_FLAX_STATE_FILE = "train_state.msgpack"


def add_demo_args(parser, save: bool = True):
    parser.add_argument(
        "--load",
        metavar="PATH",
        default=None,
        help="load a saved train state (a train_state.pt or a JAX train_state.msgpack, a directory "
        "holding one, or a zoo entry with a best/ directory) before training or demoing",
    )
    parser.add_argument(
        "--demo",
        action="store_true",
        help="evaluate the (loaded) agent and exit without training",
    )
    if save:
        parser.add_argument(
            "--save-to",
            metavar="PATH",
            default=None,
            help="directory to save the final train_state.pt (and the JAX package's train_state.msgpack) into",
        )
    return parser


def resolve_train_state_path(path: str) -> str:
    """A file as it is; in a directory, or else in its ``best/``, a
    ``train_state.pt`` or else a ``train_state.msgpack``."""
    if os.path.isdir(path):
        for sub in (path, os.path.join(path, "best")):
            for name in (_STATE_FILE, _FLAX_STATE_FILE):
                cand = os.path.join(sub, name)
                if os.path.exists(cand):
                    return cand
        raise FileNotFoundError(f"no {_STATE_FILE} or {_FLAX_STATE_FILE} under {path}")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def load_train_state(template, path: str, core=None, device=None):
    """The train state at ``path`` (resolved by
    :func:`resolve_train_state_path`) loaded into ``template``, a live
    train state, in place. A ``.msgpack`` converts through ``core``'s
    converter (:func:`pfrl_tpu_torch.convert.state_from_flax`) on
    ``device``. Returns the loaded state."""
    from pfrl_tpu_torch.agent import restore_saved, to_saved
    from pfrl_tpu_torch.replay.persistent import load_state

    path = resolve_train_state_path(path)
    if not path.endswith(".msgpack"):
        return load_state(template, path)
    if core is None:
        raise ValueError(f"{path} is a JAX checkpoint: pass the core to convert it")
    from pfrl_tpu_torch import convert

    return restore_saved(template, to_saved(convert.load_flax_checkpoint(core, path, device=device)), path)


def maybe_load_train_state(runner_state, load_path: Optional[str], core=None):
    """Loads the train state at ``load_path`` into ``runner_state.train_state``
    in place (:func:`load_train_state` on the runner's device; nothing when
    ``load_path`` is empty). Returns ``runner_state``."""
    if load_path:
        runner_state.train_state = load_train_state(
            runner_state.train_state, load_path, core, device=runner_state.obs.device)
    return runner_state


def demo_returns(evaluator, train_state, seed: int = 0, draws=None) -> np.ndarray:
    """``evaluator.evaluate`` on ``draws``, by default a generator seeded
    with ``seed`` on the evaluator's device: the returns ``--demo`` prints."""
    if draws is None:
        from pfrl_tpu_torch.utils.draws import Draws

        draws = Draws(torch.Generator(device=evaluator.device).manual_seed(seed))
    return np.asarray(evaluator.evaluate(train_state, draws))


def run_demo_if_requested(args, evaluator, train_state, seed: int = 0, draws=None) -> bool:
    """With ``--demo``: evaluates (:func:`demo_returns`), prints the
    reference's line and returns True (the caller exits); else returns
    False."""
    if not getattr(args, "demo", False):
        return False
    print_demo_line(demo_returns(evaluator, train_state, seed, draws))
    return True


def print_demo_line(returns) -> None:
    """The JAX package's ``--demo`` line for ``returns``."""
    returns = np.asarray(returns)
    print(
        f"n_episodes: {len(returns)} mean: {returns.mean():.1f} "
        f"median: {float(np.median(returns)):.1f} stdev: {returns.std():.1f}"
    )


def save_train_state_if_requested(train_state, save_dir: Optional[str], core=None) -> Optional[str]:
    """Writes ``train_state.pt`` into ``save_dir`` and, given the core,
    ``train_state.msgpack`` in the JAX package's layout beside it; nothing
    when ``save_dir`` is empty. Returns the ``.pt`` path."""
    if not save_dir:
        return None
    from pfrl_tpu_torch.replay.persistent import save_state

    path = os.path.join(save_dir, _STATE_FILE)
    save_state(train_state, path)
    print(f"saved train_state to {path}")
    if core is not None:
        from pfrl_tpu_torch import convert

        flax_path = convert.save_flax_checkpoint(core, train_state, os.path.join(save_dir, _FLAX_STATE_FILE))
        print(f"saved the JAX package's train_state to {flax_path}")
    return path


def run_device_example(args, runner, eval_loop, advance: Callable) -> dict:
    """The device examples' ``main`` once their recipe is built: the runner
    initialised from ``--seed``, ``--load`` (through the runner's core, so a
    JAX checkpoint converts), then ``--demo`` (the evaluation's line) or
    ``state = advance(state)`` until ``--steps`` transitions, each turn
    printing env-steps/s, and ``--save-to``. Returns ``{"runner",
    "eval_loop", "state", "turns"}`` and ``"demo_returns"`` or
    ``"saved_to"``."""
    state = maybe_load_train_state(runner.init(args.seed), args.load, runner.core)
    out = {"runner": runner, "eval_loop": eval_loop, "state": state, "turns": 0}
    if args.demo:
        out["demo_returns"] = demo_returns(eval_loop, state.train_state, args.seed)
        print_demo_line(out["demo_returns"])
        return out
    t0 = time.time()
    while state.t < args.steps:
        state = advance(state)
        out["turns"] += 1
        print(f"step {state.t:>10d} | {state.t / (time.time() - t0):>8.0f} env-steps/s | "
              f"recent R {runner.recent_return_mean(state):.1f}", flush=True)
    out["state"] = state
    out["saved_to"] = save_train_state_if_requested(state.train_state, getattr(args, "save_to", None), runner.core)
    return out


def run_command(commands: Dict[str, Callable], argv: Optional[Sequence[str]] = None):
    """A module that holds several examples' ``main``: ``argv``'s first
    word names the example, the rest are its flags."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in commands:
        raise SystemExit(f"usage: {{{','.join(commands)}}} [the example's flags]")
    return commands[argv[0]](argv[1:])
