"""Gradient clipping by the global norm, chained before an optimizer:
``optax.chain(optax.clip_by_global_norm(max_norm), optimizer)``.

optax keeps the gradients where their global norm (the square root of the
sum over tensors of each one's sum of squares) is below ``max_norm`` and
otherwise takes ``(g / norm) * max_norm``; the choice is made on the device
by ``torch.where``, with no host read. This is not the JAX package's
``utils/clip_l2_grad_norm.py`` (``g * min(1, max_norm / (norm + 1e-6))``),
which the cores do not use. The clip keeps no state: the chain's state is
the inner optimizer's, and optax's ``(EmptyState(), inner_state)`` converts
to it (``convert.py``).
"""

from typing import Sequence

import torch


class ClipByGlobalNorm:
    def __init__(self, max_norm: float, inner):
        self.max_norm = max_norm
        self.inner = inner

    def init(self, params: Sequence[torch.Tensor]):
        return self.inner.init(params)

    @torch.no_grad()
    def clip(self, grads: Sequence[torch.Tensor]):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_norm
        return [torch.where(keep, g, (g / norm) * self.max_norm) for g in grads]

    def update(self, params, grads, state) -> None:
        """Clips ``grads``, then the inner optimizer updates ``params`` and
        ``state`` in place."""
        self.inner.update(params, self.clip(grads), state)
