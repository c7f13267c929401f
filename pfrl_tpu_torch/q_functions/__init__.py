from pfrl_tpu_torch.q_functions.dueling_dqn import (  # noqa: F401
    DistributionalDuelingDQN,
    DuelingDQN,
)
from pfrl_tpu_torch.q_functions.quantile_q_functions import (  # noqa: F401
    ImplicitQuantileQFunction,
    RecurrentImplicitQuantileQFunction,
)
from pfrl_tpu_torch.q_functions.state_action_q_functions import (  # noqa: F401
    FCBNLateActionSAQFunction,
    FCBNSAQFunction,
    FCLateActionSAQFunction,
    FCLSTMSAQFunction,
    FCSAQFunction,
    SingleModelStateActionQFunction,
)
from pfrl_tpu_torch.q_functions.state_q_functions import (  # noqa: F401
    DiscreteActionValueHead,
    DistributionalFCStateQFunctionWithDiscreteAction,
    DistributionalSingleModelStateQFunctionWithDiscreteAction,
    FCQuadraticStateQFunction,
    FCStateQFunctionWithDiscreteAction,
    SingleModelStateQFunctionWithDiscreteAction,
)
