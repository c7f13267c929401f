"""PyTorch/CUDA port of pfrl_tpu for NVIDIA Hopper.

The JAX package ``pfrl_tpu`` is the reference: module paths and class names
here mirror it, and ``tests/test_torch_*.py`` hold each module against its
counterpart. This package imports ``torch`` and nothing of JAX or
``pfrl_tpu``.

Ported so far, each through ``experiments.OffPolicyRunner`` or
``experiments.OnPolicyRunner`` and ``experiments.EvalLoop``:

- the DQN family on AtariSim: Nature DQN over the uniform and the
  prioritized ring (``atari_per_dqn.py``, ``bench.py``'s workload), Double
  DQN, Rainbow (``atari_rainbow.py``), and ``train_dqn_ale.py --sim`` at its
  own settings with the ``nature``, ``nips`` and ``dueling`` networks and
  C51 on the Nature CNN (``atari_dqn_ale.py``, ``atari_c51.py``); on
  CartPole DQN, C51, AL, Rainbow-CartPole and IQN, with the PAL, DPP and
  Double IQN cores (``cartpole_value.py``);
- off-policy actor-critic for continuous control, SAC, TD3 and DDPG
  (``mujoco_actor_critic.py``), and on-policy PPO, A2C and TRPO
  (``onpolicy.py``);
- the recurrent and episodic paths: the episodic and prioritized episodic
  buffers, DRQN, recurrent IQN, recurrent PPO and TRPO (``recurrent.py``),
  and ACER, discrete and continuous (``acer.py``);
- the host side of the Atari path: the C++ frame ops (:mod:`.runtime`),
  the Atari wrappers (:mod:`.wrappers.atari_wrappers`), ``SyntheticALE``
  (:mod:`.envs.synthetic_ale`) and the actor-learner pipeline over spawned
  actor processes (:mod:`.parallel.atari_pipeline`,
  ``experiments/atari_pipeline.py``).

- the host-env object path: the agent protocol (:mod:`.agent`), the
  ``DQN`` and ``DoubleDQN`` shells and ``REINFORCE`` (:mod:`.agents`), the
  host vector envs (``SerialVectorEnv``, ``MultiprocessVectorEnv`` over
  spawned workers), ``GymnasiumEnv`` and ``HostTorchEnv``, the small
  wrappers (:mod:`.wrappers`), and the drivers ``train_agent*`` with
  ``Evaluator`` (:mod:`.experiments`); ``train_dqn_batch_ale.py``'s batch
  mode at its own settings (``atari_dqn_batch.py``) and
  ``train_reinforce_gym.py`` (``reinforce_gym.py``).

Every first-order core takes ``compute_dtype`` (bf16 compute over float32
masters, see :mod:`.utils.precision`); TRPO refuses it, as in JAX. Not
ported yet: the shells of the other cores, the actor-learner half of the
DQN shell, ``make_atari`` (a real ALE), persistence and device meshes.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise (see :mod:`._device`). Kernels
are built from ``csrc/`` at first use (see :mod:`.ops.cuda_build`).
"""


def __getattr__(name):
    # Resolved on first use, so that the Atari pipeline's actor processes,
    # which import the package's host modules, never load torch.
    if name == "resolve_device":
        from pfrl_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
