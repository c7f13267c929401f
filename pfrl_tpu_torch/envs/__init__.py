from pfrl_tpu_torch.envs.abc import ABC, ABCState  # noqa: F401
from pfrl_tpu_torch.envs.cartpole import CartPole, CartPoleState  # noqa: F401
from pfrl_tpu_torch.envs.atari_sim import AtariSim, AtariSimState  # noqa: F401
from pfrl_tpu_torch.envs.delayed_cue import DelayedCue, DelayedCueState  # noqa: F401
from pfrl_tpu_torch.envs.mujoco_sim import MujocoSim, MujocoSimState  # noqa: F401
from pfrl_tpu_torch.envs.pendulum import Pendulum, PendulumState  # noqa: F401
from pfrl_tpu_torch.envs.vector_env import VecStep, VectorTorchEnv  # noqa: F401
from pfrl_tpu_torch.envs.wrappers import (  # noqa: F401
    CastObservationToFloat32,
    NormalizeActionSpace,
    ScaleReward,
    TimeLimit,
    TimeLimitState,
)
