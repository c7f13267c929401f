"""Host-device pipelines (counterpart of ``pfrl_tpu/parallel``). So far the
Atari actor-learner pipeline, :mod:`.atari_pipeline`; its actor processes
run :mod:`.env_worker`, which imports no torch."""
