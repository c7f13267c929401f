from pfrl_tpu_torch.utils.batch_states import atari_phi  # noqa: F401
from pfrl_tpu_torch.utils.clip_l2_grad_norm import clip_l2_grad_norm  # noqa: F401
from pfrl_tpu_torch.utils.contexts import evaluating, set_temporarily  # noqa: F401
from pfrl_tpu_torch.utils.copy_param import copy_param, soft_copy_param, synchronize_parameters  # noqa: F401
from pfrl_tpu_torch.utils.draws import Draws  # noqa: F401
from pfrl_tpu_torch.utils.mode_of_distribution import mode_of_distribution  # noqa: F401
from pfrl_tpu_torch.utils.profiling import StepTimer, trace  # noqa: F401
from pfrl_tpu_torch.utils.random import sample_n_k  # noqa: F401
from pfrl_tpu_torch.utils.random_seed import set_random_seed  # noqa: F401
from pfrl_tpu_torch.utils.reward_filter import AverageRewardFilter, NormalizedRewardFilter  # noqa: F401
