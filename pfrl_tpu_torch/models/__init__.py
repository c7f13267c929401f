from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN, SmallAtariCNN  # noqa: F401
from pfrl_tpu_torch.models.batch_norm import BatchNorm  # noqa: F401
from pfrl_tpu_torch.models.branched import Branched  # noqa: F401
from pfrl_tpu_torch.models.empirical_normalization import (  # noqa: F401
    EmpiricalNormalization,
    NormalizerState,
)
from pfrl_tpu_torch.models.lmbda import Lambda  # noqa: F401
from pfrl_tpu_torch.models.misc import BoundByTanh, ConcatObsAndAction  # noqa: F401
from pfrl_tpu_torch.models.mlp import MLP, MLPBN  # noqa: F401
from pfrl_tpu_torch.models.noisy_linear import FactorizedNoisyLinear, to_factorized_noisy  # noqa: F401
from pfrl_tpu_torch.models.recurrent import (  # noqa: F401
    GRUCellModule,
    LSTMCellModule,
    RecurrentBranched,
    RecurrentSequential,
)
