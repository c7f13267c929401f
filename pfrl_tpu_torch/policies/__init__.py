"""Policy heads (counterpart of ``pfrl_tpu/policies``): network output ->
distribution."""

from pfrl_tpu_torch.policies.deterministic_policy import DeterministicHead  # noqa: F401
from pfrl_tpu_torch.policies.gaussian_policy import (  # noqa: F401
    GaussianHeadWithDiagonalCovariance,
    GaussianHeadWithFixedCovariance,
    GaussianHeadWithStateIndependentCovariance,
    SquashedGaussianHead,
)
from pfrl_tpu_torch.policies.softmax_policy import SoftmaxCategoricalHead  # noqa: F401
