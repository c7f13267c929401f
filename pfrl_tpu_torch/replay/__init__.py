from pfrl_tpu_torch.replay.episodic import EpisodeBatch, EpisodicReplayBuffer, EpisodicReplayState  # noqa: F401
from pfrl_tpu_torch.replay.prioritized import (  # noqa: F401
    PrioritizedReplayBuffer,
    PrioritizedReplayState,
)
from pfrl_tpu_torch.replay.transition import Transition, TransitionBatch  # noqa: F401
from pfrl_tpu_torch.replay.uniform import ReplayBuffer, ReplayState  # noqa: F401
from pfrl_tpu_torch.replay.prioritized_episodic import (  # noqa: F401
    PrioritizedEpisodicReplayBuffer,
    PrioritizedEpisodicReplayState,
)
from pfrl_tpu_torch.replay.persistent import (  # noqa: F401
    PersistentEpisodicReplayBuffer,
    PersistentReplayBuffer,
    load_state,
    save_state,
)
