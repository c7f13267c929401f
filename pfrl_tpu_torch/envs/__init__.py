"""Device environments (batched over lanes, on tensors) and the host
``SyntheticALE``. The names resolve on first use, so that importing
:mod:`.synthetic_ale` (in the Atari pipeline's actor processes, by
unpickling a factory) loads no torch."""

import importlib

_EXPORTS = {
    "abc": ("ABC", "ABCState"),
    "cartpole": ("CartPole", "CartPoleState"),
    "atari_sim": ("AtariSim", "AtariSimState"),
    "delayed_cue": ("DelayedCue", "DelayedCueState"),
    "mujoco_sim": ("MujocoSim", "MujocoSimState"),
    "pendulum": ("Pendulum", "PendulumState"),
    "vector_env": ("VecStep", "VectorTorchEnv"),
    "wrappers": ("CastObservationToFloat32", "NormalizeActionSpace", "ScaleReward", "TimeLimit", "TimeLimitState"),
    "synthetic_ale": ("SyntheticALE",),
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
