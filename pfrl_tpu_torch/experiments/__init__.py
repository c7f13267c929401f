from pfrl_tpu_torch.experiments.runner import (  # noqa: F401
    EvalLoop,
    OffPolicyRunner,
    RunnerConfig,
    RunnerState,
)
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner, OnPolicyRunnerState  # noqa: F401
