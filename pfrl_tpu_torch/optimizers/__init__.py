from pfrl_tpu_torch.optimizers.rmsprop import RMSprop  # noqa: F401
