from pfrl_tpu_torch.agents.a2c import A2CCore  # noqa: F401
from pfrl_tpu_torch.agents.acer import ACERContinuousCore, ACERCore, ACERSDNModel, ACERState  # noqa: F401
from pfrl_tpu_torch.agents.al import ALCore  # noqa: F401
from pfrl_tpu_torch.agents.categorical_dqn import (  # noqa: F401
    CategoricalDoubleDQNCore,
    CategoricalDQNCore,
)
from pfrl_tpu_torch.agents.ddpg import ActorCriticState, DDPGCore  # noqa: F401
from pfrl_tpu_torch.agents.double_dqn import DoubleDQN, DoubleDQNCore  # noqa: F401
from pfrl_tpu_torch.agents.dpp import DPPCore  # noqa: F401
from pfrl_tpu_torch.agents.dqn import DQN, DQNCore, DQNState  # noqa: F401
from pfrl_tpu_torch.agents.iqn import DoubleIQNCore, IQNCore  # noqa: F401
from pfrl_tpu_torch.agents.pal import DoublePALCore, PALCore  # noqa: F401
from pfrl_tpu_torch.agents.ppo import PPOCore, PPOState, Rollout  # noqa: F401
from pfrl_tpu_torch.agents.reinforce import REINFORCE, ReinforceCore, ReinforceState  # noqa: F401
from pfrl_tpu_torch.agents.soft_actor_critic import SACCore, SACState  # noqa: F401
from pfrl_tpu_torch.agents.td3 import TD3Core, TD3State  # noqa: F401
from pfrl_tpu_torch.agents.trpo import TRPOCore, TRPOState  # noqa: F401
