from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN, SmallAtariCNN  # noqa: F401
from pfrl_tpu_torch.models.mlp import MLP  # noqa: F401
from pfrl_tpu_torch.models.noisy_linear import FactorizedNoisyLinear, to_factorized_noisy  # noqa: F401
