"""Alias of :mod:`pfrl_tpu_torch.models` under the reference's name (pfrl/nn)."""

from pfrl_tpu_torch.models import *  # noqa: F401,F403
