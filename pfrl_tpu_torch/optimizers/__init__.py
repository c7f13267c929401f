from pfrl_tpu_torch.optimizers.adam import Adam, AdamState  # noqa: F401
from pfrl_tpu_torch.optimizers.rmsprop import RMSprop  # noqa: F401
