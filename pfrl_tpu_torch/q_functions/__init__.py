from pfrl_tpu_torch.q_functions.state_q_functions import (  # noqa: F401
    DiscreteActionValueHead,
)
