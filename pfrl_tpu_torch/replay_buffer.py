"""The reference's ``pfrl.replay_buffer`` name (counterpart of
``pfrl_tpu/replay_buffer.py``): the concrete buffers of
:mod:`pfrl_tpu_torch.replay`. Their ``gather`` is the reference's
``batch_experiences`` (the n-step fold at sample time), and the
``ReplayUpdater`` gating lives in the agent shells and the runners."""

from pfrl_tpu_torch.replay import *  # noqa: F401,F403
