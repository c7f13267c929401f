from pfrl_tpu_torch.experiments.runner import (  # noqa: F401
    EvalLoop,
    OffPolicyRunner,
    RunnerConfig,
    RunnerState,
)
