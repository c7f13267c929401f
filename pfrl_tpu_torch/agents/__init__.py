from pfrl_tpu_torch.agents.a2c import A2C, A2CCore  # noqa: F401
from pfrl_tpu_torch.agents.acer import ACERContinuousCore, ACERCore, ACERSDNModel, ACERState  # noqa: F401
from pfrl_tpu_torch.agents.al import AL, ALCore  # noqa: F401
from pfrl_tpu_torch.agents.categorical_dqn import (  # noqa: F401
    CategoricalDoubleDQN,
    CategoricalDoubleDQNCore,
    CategoricalDQN,
    CategoricalDQNCore,
)
from pfrl_tpu_torch.agents.ddpg import DDPG, ActorCriticShellAgent, ActorCriticState, DDPGCore  # noqa: F401
from pfrl_tpu_torch.agents.double_dqn import DoubleDQN, DoubleDQNCore  # noqa: F401
from pfrl_tpu_torch.agents.dpp import DPP, DPPCore  # noqa: F401
from pfrl_tpu_torch.agents.dqn import DQN, DQNCore, DQNState  # noqa: F401
from pfrl_tpu_torch.agents.iqn import IQN, DoubleIQN, DoubleIQNCore, IQNCore  # noqa: F401
from pfrl_tpu_torch.agents.pal import PAL, DoublePAL, DoublePALCore, PALCore  # noqa: F401
from pfrl_tpu_torch.agents.ppo import PPO, OnPolicyShellAgent, PPOCore, PPOState, Rollout  # noqa: F401
from pfrl_tpu_torch.agents.reinforce import REINFORCE, ReinforceCore, ReinforceState  # noqa: F401
from pfrl_tpu_torch.agents.soft_actor_critic import SACCore, SACState, SoftActorCritic  # noqa: F401
from pfrl_tpu_torch.agents.td3 import TD3, TD3Core, TD3State  # noqa: F401
from pfrl_tpu_torch.agents.trpo import TRPO, TRPOCore, TRPOState  # noqa: F401
