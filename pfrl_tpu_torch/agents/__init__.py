from pfrl_tpu_torch.agents.categorical_dqn import (  # noqa: F401
    CategoricalDoubleDQNCore,
    CategoricalDQNCore,
)
from pfrl_tpu_torch.agents.double_dqn import DoubleDQNCore  # noqa: F401
from pfrl_tpu_torch.agents.dqn import DQNCore, DQNState  # noqa: F401
