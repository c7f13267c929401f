"""Action distributions (counterpart of ``pfrl_tpu/distributions``): plain
classes over tensors. Batch shape is implicit; ``log_prob`` sums over the
trailing event dimension. Where the JAX classes take a PRNG key, these take
a draw source (:mod:`pfrl_tpu_torch.utils.draws`).
"""

from pfrl_tpu_torch.distributions.base import Distribution  # noqa: F401
from pfrl_tpu_torch.distributions.categorical import Categorical  # noqa: F401
from pfrl_tpu_torch.distributions.delta import Delta  # noqa: F401
from pfrl_tpu_torch.distributions.normal import Normal  # noqa: F401
from pfrl_tpu_torch.distributions.squashed_normal import SquashedNormal  # noqa: F401
from pfrl_tpu_torch.distributions.transforms import kl_divergence  # noqa: F401
