from pfrl_tpu_torch.functions.bound_by_tanh import bound_by_tanh  # noqa: F401
