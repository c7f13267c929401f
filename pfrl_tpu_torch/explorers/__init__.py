from pfrl_tpu_torch.explorers.epsilon_greedy import (  # noqa: F401
    LinearDecayEpsilonGreedy,
    epsilon_greedy,
)
from pfrl_tpu_torch.explorers.greedy import Greedy  # noqa: F401
