"""Cross-distribution helpers (counterpart of ``pfrl_tpu/distributions/transforms.py``)."""

from pfrl_tpu_torch.distributions.categorical import Categorical
from pfrl_tpu_torch.distributions.normal import Normal


def kl_divergence(p, q):
    """KL(p || q) for two distributions of one family (Categorical, Normal)."""
    for family in (Categorical, Normal):
        if isinstance(p, family) and isinstance(q, family):
            return p.kl(q)
    raise NotImplementedError(
        f"kl_divergence not defined for {type(p).__name__} vs {type(q).__name__}"
    )
