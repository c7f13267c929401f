"""Host-device pipelines and multi-device training (counterpart of
``pfrl_tpu/parallel``): the Atari actor-learner pipeline,
:mod:`.atari_pipeline`, whose actor processes run :mod:`.env_worker`
(which imports no torch, so this package imports nothing itself), the
batched inference server of the ``DQN`` shell's actor-learner mode,
:mod:`.inference_server`, and the data mesh over ``torch.distributed``
ranks: :mod:`.mesh` (``make_mesh``, ``shard_batch``, ``replicate``),
:mod:`.data_parallel` (``pmean_grads``, ``data_parallel_update``),
:mod:`.multihost` (``initialize_multihost``, ``global_mesh``,
``is_primary``, ``local_lane_slice``) and the runners' lane sharding,
:mod:`.lane_sharding`."""
