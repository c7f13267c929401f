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
  ``train_reinforce_gym.py`` (``reinforce_gym.py``); the shells of every
  other core (DDPG, TD3, SAC, PPO, A2C and A3C, TRPO, the value family);
- the actor-learner mode of the ``DQN`` shell
  (``DQN.setup_actor_learner_training``: actor threads through one
  :class:`.parallel.inference_server.BatchedInferenceServer`, a poller and a
  learner thread), ``experiments.train_agent_async`` with
  ``AsyncEvaluator``, and ``train_dqn_batch_ale.py --actor-learner``
  (``atari_dqn_batch.run_actor_learner``) and ``train_a3c.py --sim``
  (``atari_a3c.py``) at their own settings;
- the remaining example recipes: ``train_iqn.py --sim`` (``atari_iqn.py``),
  ``train_ppo.py --jax-env pendulum`` and ``train_ppo_pendulum.py``
  (``ppo_pendulum.py``), the atlas SAC (``sac_atlas.py``) and the
  quickstart (``quickstart.py``);
- multi-device training over ``torch.distributed`` (:mod:`.parallel.mesh`,
  :mod:`.parallel.data_parallel`, :mod:`.parallel.multihost`,
  :mod:`.parallel.lane_sharding`): both runners take a mesh, and
  ``train_dqn_batch_ale.py --multihost`` is ``atari_dqn_batch.run_multihost``;
- the real-ALE host paths: ``atari_wrappers.make_atari`` (gymnasium's ALE
  game under ``ContinuingTimeLimit``, no-ops and frame skip) and the six
  example entry points over it (``atari_dqn_ale.run_ale``,
  ``atari_dqn_batch.run_batch`` and ``run_actor_learner``,
  ``atari_pipeline.run`` without ``--sim``, ``atari_onpolicy_ale``,
  ``atari_dqn_reproduction``), the host wrappers ``Monitor``, ``Render``,
  ``VectorFrameStack`` and the MJPEG video writer (:mod:`.wrappers`), the
  small utilities of :mod:`.utils` (reward filters, env modifiers,
  ``evaluating``, ``set_random_seed``, ``sample_n_k``, ``clip_l2_grad_norm``,
  ``mode_of_distribution``) and :mod:`.testing`.

Every first-order core takes ``compute_dtype`` (bf16 compute over float32
masters, see :mod:`.utils.precision`); TRPO refuses it, as in JAX.

Persistence: ``save_state``/``load_state`` and the persistent buffers
(:mod:`.replay.persistent`), runner and shell snapshots
(:mod:`.agents.snapshot`), ``--load``/``--demo``/``--save-to``
(:mod:`.experiments.demo_cli`), the local model zoo
(:mod:`.utils.pretrained_models`, :mod:`.experiments.zoo`) and the host
collections (:mod:`.collections_`, also ``collections``). A JAX checkpoint
(flax msgpack) loads through the port's own reader
(:mod:`.utils.flax_msgpack`) and :mod:`.convert`, with no JAX installed.

The sibling modules: ``MLPBN``, ``EmpiricalNormalization``,
``Branched``, ``Lambda``, the BN and LSTM (state, action) Q-functions,
``synchronize_parameters`` (whose copies refuse modules of another
structure), ``RMSpropEpsInsideSqrt``, a checkpoint the JAX package reads
(``convert.save_flax_checkpoint``) and ``utils/profiling.py``.

Every script of ``examples/`` has a command line here: ``python -m
pfrl_tpu_torch.experiments.<module> <the example's flags>`` (``README.md``
maps the 27 scripts to their modules; ``atari_onpolicy_ale`` and
``mujoco_host`` take the example's name first, ``a2c`` or ``ppo``,
``sac``, ``td3``, ``ddpg``, ``ppo`` or ``trpo``), each a ``run(argv=None,
device=None)`` with the example's flags and defaults. So has
``tools/record_curves.py``: ``python -m
pfrl_tpu_torch.experiments.record_curves [names ...]`` trains its 21
recipes to their successful scores, resumably. Nothing is left to port.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise (see :mod:`._device`). Kernels
are built from ``csrc/`` at first use (see :mod:`.ops.cuda_build`).
"""

from pfrl_tpu_torch import collections_  # noqa: F401,E402  (no torch: safe in the actor processes)
from pfrl_tpu_torch import collections_ as collections  # noqa: F401,E402  (pfrl name)


def __getattr__(name):
    # Resolved on first use, so that the Atari pipeline's actor processes,
    # which import the package's host modules, never load torch.
    if name == "resolve_device":
        from pfrl_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
