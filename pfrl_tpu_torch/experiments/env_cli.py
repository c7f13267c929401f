"""Env-backend selection for the real-env example scripts (counterpart of
``pfrl_tpu/experiments/env_cli.py``).

Each real-env script has two backends:

* **default**: a real gymnasium env through
  :func:`~pfrl_tpu_torch.envs.gymnasium_env.make_gymnasium_env`, wrapped in
  ``CastObservationToFloat32`` and, for continuous control,
  ``NormalizeActionSpace`` (the reference's wrapper order,
  ``train_soft_actor_critic.py:66-79``). An unavailable backend or env id is
  a hard error naming it, never a silent substitute.
* ``--torch-env``: explicit opt-in to an in-repo env of the port behind
  ``HostTorchEnv``, the counterpart of the JAX scripts' ``--jax-env``.
"""

from typing import Callable, Optional

__all__ = ["add_env_backend_args", "make_backend_env"]


def add_env_backend_args(parser):
    parser.add_argument(
        "--torch-env",
        action="store_true",
        help="train on the in-repo simulator of the port instead of the real "
        "gymnasium env (--env is ignored); without this flag an unavailable "
        "--env is a hard error, never a silent fallback",
    )
    return parser


def make_backend_env(
    args,
    seed: int,
    torch_env_factory: Callable[[int], object],
    normalize_action: bool = True,
    env_id: Optional[str] = None,
):
    """The env of a real-env example script: ``torch_env_factory(seed)``
    under ``--torch-env``, else ``make_gymnasium_env(args.env)`` (or
    ``env_id``) wrapped as the module docstring says."""
    if getattr(args, "torch_env", False):
        return torch_env_factory(seed)
    from pfrl_tpu_torch.envs.gymnasium_env import make_gymnasium_env
    from pfrl_tpu_torch.wrappers.misc import CastObservationToFloat32, NormalizeActionSpace

    env = CastObservationToFloat32(make_gymnasium_env(env_id or args.env, seed=seed))
    if normalize_action:
        env = NormalizeActionSpace(env)
    return env
