"""RMSprop with optax's semantics, not ``torch.optim.RMSprop``'s.

Counterpart of ``optax.rmsprop(learning_rate, decay, eps)`` at its defaults
(``eps_in_sqrt=True``, ``initial_scale=0``, no momentum, not centered):

    nu     <- (1 - decay) * g**2 + decay * nu        (nu starts at zero)
    param  <- param + (-learning_rate) * (rsqrt(nu + eps) * g)

``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps`` instead; with the
Nature-DQN eps of 1e-2 the two diverge from the first step. This is a plain
elementwise update on tensors, in place, in optax's order of operations.
"""

from typing import List, Sequence

import numpy as np
import torch


class RMSprop:
    def __init__(self, learning_rate: float, decay: float = 0.9, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.decay = decay
        self.eps = eps

    def init(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The second moments ``nu``, zero, one per parameter."""
        return [torch.zeros_like(p) for p in params]

    def load_state(self, state: List[torch.Tensor], nu, count=None) -> None:
        """Copy second moments given as arrays in parameter order; optax's
        RMSprop keeps no count."""
        with torch.no_grad():
            for dst, src in zip(state, nu):
                dst.copy_(torch.from_numpy(np.array(src)))

    @torch.no_grad()
    def update(
        self,
        params: Sequence[torch.Tensor],
        grads: Sequence[torch.Tensor],
        nu: Sequence[torch.Tensor],
    ) -> None:
        """Updates ``params`` and ``nu`` in place."""
        for p, g, n in zip(params, grads, nu):
            n.copy_((1 - self.decay) * (g * g) + self.decay * n)
            p.add_(-self.learning_rate * (torch.rsqrt(n + self.eps) * g))
