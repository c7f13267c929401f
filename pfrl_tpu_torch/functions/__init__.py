from pfrl_tpu_torch.functions.bound_by_tanh import bound_by_tanh  # noqa: F401
from pfrl_tpu_torch.functions.lower_triangular_matrix import lower_triangular_matrix  # noqa: F401
