from pfrl_tpu_torch.envs.atari_sim import AtariSim, AtariSimState  # noqa: F401
from pfrl_tpu_torch.envs.vector_env import VecStep, VectorTorchEnv  # noqa: F401
