"""Host-device pipelines (counterpart of ``pfrl_tpu/parallel``): the Atari
actor-learner pipeline, :mod:`.atari_pipeline`, whose actor processes run
:mod:`.env_worker` (which imports no torch), and the batched inference
server of the ``DQN`` shell's actor-learner mode,
:mod:`.inference_server`."""
