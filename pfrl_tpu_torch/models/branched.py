"""Parallel branches (counterpart of ``pfrl_tpu/models/branched.py``)."""

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.models.mlp import scoped_names


class Branched(nn.Module):
    """Apply each branch to the same input; return the tuple of outputs.

    flax names a module held in a sequence attribute by the attribute and
    its index, so branch ``i`` is the scope ``branches_i``. A branch with no
    parameters (a :class:`~pfrl_tpu_torch.models.lmbda.Lambda`) needs no
    ``flax_names``.
    """

    def __init__(self, branches: Sequence[nn.Module]):
        super().__init__()
        self.branches = nn.ModuleList(branches)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for branch in self.branches:
            if hasattr(branch, "reset_parameters"):
                branch.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        names = {}
        for i, branch in enumerate(self.branches):
            if hasattr(branch, "flax_names"):
                names.update(scoped_names(f"branches.{i}", f"branches_{i}", branch))
        return names

    def forward(self, *args, **kwargs) -> Tuple:
        return tuple(branch(*args, **kwargs) for branch in self.branches)
