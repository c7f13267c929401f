"""Action values returned by Q-networks (counterpart of
``pfrl_tpu/action_value.py``; only the discrete variant so far)."""

import dataclasses

import torch


@dataclasses.dataclass
class DiscreteActionValue:
    """Plain Q-values over discrete actions ``[B, A]``."""

    q_values: torch.Tensor

    @property
    def n_actions(self) -> int:
        return self.q_values.shape[-1]

    def greedy_actions(self) -> torch.Tensor:
        """int32 argmax; ties go to the first index, as with ``jnp.argmax``."""
        return torch.argmax(self.q_values, dim=-1).to(torch.int32)

    def max(self) -> torch.Tensor:
        return torch.amax(self.q_values, dim=-1)

    def evaluate_actions(self, actions: torch.Tensor) -> torch.Tensor:
        idx = actions.to(torch.int64).unsqueeze(-1)
        return torch.gather(self.q_values, -1, idx).squeeze(-1)
