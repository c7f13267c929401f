from pfrl_tpu_torch.experiments.evaluation_hooks import EvaluationHook, OptunaPrunerHook  # noqa: F401
from pfrl_tpu_torch.experiments.evaluator import (  # noqa: F401
    Evaluator,
    batch_run_evaluation_episodes,
    eval_performance,
    run_evaluation_episodes,
)
from pfrl_tpu_torch.experiments.hooks import LinearInterpolationHook, StepHook  # noqa: F401
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner, OnPolicyRunnerState  # noqa: F401
from pfrl_tpu_torch.experiments.prepare_output_dir import prepare_output_dir  # noqa: F401
from pfrl_tpu_torch.experiments.runner import (  # noqa: F401
    EvalLoop,
    OffPolicyRunner,
    RunnerConfig,
    RunnerState,
)
from pfrl_tpu_torch.experiments.train_agent import train_agent, train_agent_with_evaluation  # noqa: F401
from pfrl_tpu_torch.experiments.train_agent_batch import (  # noqa: F401
    train_agent_batch,
    train_agent_batch_with_evaluation,
)
