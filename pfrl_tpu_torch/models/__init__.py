from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN  # noqa: F401
