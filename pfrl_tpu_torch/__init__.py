"""PyTorch/CUDA port of pfrl_tpu for NVIDIA Hopper.

The JAX package ``pfrl_tpu`` is the reference: module paths and class names
here mirror it, and ``tests/test_torch_*.py`` hold each module against its
counterpart. This package imports ``torch`` and nothing of JAX or
``pfrl_tpu``.

Ported so far: the DQN family's device path (Nature DQN over the uniform
and the prioritized ring, Double DQN, Rainbow; on CartPole DQN, C51, AL,
Rainbow-CartPole and IQN, with the PAL, DPP and Double IQN cores) and
off-policy actor-critic for continuous control (SAC, TD3, DDPG), each
through ``experiments.OffPolicyRunner`` and ``experiments.EvalLoop``; see
``experiments/atari_per_dqn.py``, ``atari_rainbow.py``,
``cartpole_value.py`` and ``mujoco_actor_critic.py``; on-policy training
(PPO, A2C, TRPO) through ``experiments.OnPolicyRunner``, see
``experiments/onpolicy.py``. Every first-order core takes
``compute_dtype`` (bf16 compute over float32 masters, see
:mod:`.utils.precision`); TRPO refuses it, as in JAX. Not ported yet:
REINFORCE, the recurrent and episodic paths, the agents' host shells and
the host-env training loops, device meshes.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise (see :mod:`._device`). Kernels
are built from ``csrc/`` at first use (see :mod:`.ops.cuda_build`).
"""

from pfrl_tpu_torch._device import resolve_device  # noqa: F401
