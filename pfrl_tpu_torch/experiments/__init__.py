from pfrl_tpu_torch.experiments.runner import (  # noqa: F401
    OffPolicyRunner,
    RunnerConfig,
    RunnerState,
)
