from pfrl_tpu_torch.explorers.additive_gaussian import AdditiveGaussian  # noqa: F401
from pfrl_tpu_torch.explorers.additive_ou import AdditiveOU  # noqa: F401
from pfrl_tpu_torch.explorers.boltzmann import Boltzmann  # noqa: F401
from pfrl_tpu_torch.explorers.epsilon_greedy import (  # noqa: F401
    ConstantEpsilonGreedy,
    ExponentialDecayEpsilonGreedy,
    LinearDecayEpsilonGreedy,
    epsilon_greedy,
)
from pfrl_tpu_torch.explorers.greedy import Greedy  # noqa: F401
