from pfrl_tpu_torch.agents.dqn import DQNCore, DQNState  # noqa: F401
