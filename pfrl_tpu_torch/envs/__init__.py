"""Device environments (batched over lanes, on tensors), the host
``SyntheticALE``, the host vector envs and adapters. The names resolve on
first use, so that importing :mod:`.synthetic_ale`,
:mod:`.multiprocess_vector_env` or :mod:`.gymnasium_env` (in actor and
worker processes, by unpickling a factory) loads no torch."""

import importlib

_EXPORTS = {
    "abc": ("ABC", "ABCState"),
    "cartpole": ("CartPole", "CartPoleState"),
    "atari_sim": ("AtariSim", "AtariSimState"),
    "delayed_cue": ("DelayedCue", "DelayedCueState"),
    "mountain_car": ("MountainCarContinuous", "MCState"),
    "mujoco_sim": ("MujocoSim", "MujocoSimState"),
    "pendulum": ("Pendulum", "PendulumState"),
    "vector_env": ("VecStep", "VectorTorchEnv"),
    "wrappers": ("CastObservationToFloat32", "NormalizeActionSpace", "ScaleReward", "TimeLimit", "TimeLimitState"),
    "synthetic_ale": ("SyntheticALE",),
    "synthetic_grasping": ("SyntheticGraspingEnv", "make_grasping_env"),
    "host_adapter": ("HostTorchEnv",),
    "serial_vector_env": ("SerialVectorEnv",),
    "multiprocess_vector_env": ("MultiprocessVectorEnv",),
    "gymnasium_env": ("GymnasiumEnv", "make_gymnasium_env"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
