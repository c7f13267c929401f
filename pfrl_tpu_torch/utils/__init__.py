from pfrl_tpu_torch.utils.batch_states import atari_phi  # noqa: F401
from pfrl_tpu_torch.utils.copy_param import copy_param, soft_copy_param  # noqa: F401
from pfrl_tpu_torch.utils.draws import Draws  # noqa: F401
