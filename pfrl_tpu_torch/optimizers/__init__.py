from pfrl_tpu_torch.optimizers.adam import Adam, AdamState  # noqa: F401
from pfrl_tpu_torch.optimizers.rmsprop import RMSprop  # noqa: F401
from pfrl_tpu_torch.optimizers.rmsprop_eps_inside_sqrt import (  # noqa: F401
    RMSpropEpsInsideSqrt,
    RMSpropEpsInsideSqrtState,
)
from pfrl_tpu_torch.optimizers.clip_by_global_norm import ClipByGlobalNorm  # noqa: F401
