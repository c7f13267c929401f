"""``examples/atari/train_dqn_pipeline_ale.py --sim``: Nature DQN through the
actor-learner pipeline (:mod:`pfrl_tpu_torch.parallel.atari_pipeline`) at
the example's own settings.

:func:`make_dqn_pipeline` returns the (not yet started) pipeline: 3
spawned actor processes x 96 lanes of ``SyntheticALE`` through
MaxAndSkip -> ClipReward -> WarpFrame on the C++ frame ops
(``envs/synthetic_ale.make_warped``: 84x84x1 uint8 planes, 6 actions);
``NatureQ`` (``LargeAtariCNN`` -> Dense(6)); ``DQNCore`` with a summed
Huber loss and optax-semantics RMSprop(2.5e-4, decay 0.95, eps 1e-2);
``LinearDecayEpsilonGreedy`` 1.0 -> 0.1 over 10^6 transitions; a plane
ring of 10^6 rows, 999,936 after rounding down to whole rows of 288 lanes
(7.06 GB of planes on the card); bursts of 64 batch-32 updates paced at
one per 4 transitions from 50,000 on, target syncs every 10^4 (in
transitions of updates x 4). Sizes are arguments, so that tests run it
small; the example's values are the defaults.
"""

from typing import Callable, Optional

import torch

from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.envs.synthetic_ale import make_warped
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import RMSprop
from pfrl_tpu_torch.parallel.atari_pipeline import AtariActorLearnerPipeline
from pfrl_tpu_torch.utils.batch_states import atari_phi


def make_pipeline_core(n_actions: int = 6, compute_dtype: Optional[torch.dtype] = None) -> DQNCore:
    return DQNCore(
        model=NatureQ(n_actions),
        optimizer=RMSprop(2.5e-4, decay=0.95, eps=1e-2),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.1, 10**6, n_actions),
        gamma=0.99,
        batch_accumulator="sum",
        phi=atari_phi,
        compute_dtype=compute_dtype,
    )


def make_dqn_pipeline(
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    env_factory: Callable = make_warped,
    n_workers: int = 3,
    lanes_per_worker: int = 96,
    capacity: int = 10**6,
    minibatch_size: int = 32,
    update_interval: int = 4,
    target_update_interval: int = 10**4,
    replay_start_size: int = 5 * 10**4,
    burst: int = 64,
    seed: int = 0,
) -> AtariActorLearnerPipeline:
    """``train_dqn_pipeline_ale.py --sim [--bf16]`` on ``device`` (default:
    the CUDA device)."""
    return AtariActorLearnerPipeline(
        core=make_pipeline_core(compute_dtype=compute_dtype),
        env_factory=env_factory,
        n_workers=n_workers,
        lanes_per_worker=lanes_per_worker,
        capacity=capacity,
        minibatch_size=minibatch_size,
        update_interval=update_interval,
        target_update_interval=target_update_interval,
        replay_start_size=replay_start_size,
        burst=burst,
        seed=seed,
        device=device,
    )
