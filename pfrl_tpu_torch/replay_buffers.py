"""Alias of :mod:`pfrl_tpu_torch.replay` under the reference's name
(pfrl/replay_buffers)."""

from pfrl_tpu_torch.replay import *  # noqa: F401,F403
