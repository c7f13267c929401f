"""Adam with optax's order of operations, not ``torch.optim.Adam``'s.

Counterpart of ``optax.adam(learning_rate, b1, b2, eps, eps_root=0)``:

    mu     <- (1 - b1) * g    + b1 * mu            (both start at zero)
    nu     <- (1 - b2) * g**2 + b2 * nu
    count  <- count + 1
    mu_hat  = mu / (1 - b1**count)
    nu_hat  = nu / (1 - b2**count)
    param  <- param + (-learning_rate) * (mu_hat / (sqrt(nu_hat) + eps))

``torch.optim.Adam`` folds the bias corrections into a step size and a
rescaled denominator; with Rainbow's eps of 1.5e-4 the two round apart.
This is a plain elementwise update on tensors, in place. ``count`` lives on
the host, like the runner's step counter, and the bias corrections are
float32 scalars computed there.
"""

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    mu: List[torch.Tensor]  # first moments, one per parameter
    nu: List[torch.Tensor]  # second moments
    count: int = 0          # updates so far


class Adam:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.b1 = b1
        self.b2 = b2
        self.eps = eps

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    def load_state(self, state: AdamState, mu, nu, count) -> None:
        """Copy moments given as arrays in parameter order, and the count."""
        with torch.no_grad():
            for dst, src in zip(state.mu + state.nu, list(mu) + list(nu)):
                dst.copy_(torch.from_numpy(np.array(src)))
        state.count = int(count)

    @torch.no_grad()
    def update(
        self,
        params: Sequence[torch.Tensor],
        grads: Sequence[torch.Tensor],
        state: AdamState,
    ) -> None:
        """Updates ``params`` and ``state`` in place."""
        state.count += 1
        f32 = np.float32
        mu_correction = float(f32(1) - f32(self.b1) ** f32(state.count))
        nu_correction = float(f32(1) - f32(self.b2) ** f32(state.count))
        for p, g, m, n in zip(params, grads, state.mu, state.nu):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            n.copy_((1 - self.b2) * (g * g) + self.b2 * n)
            step = (m / mu_correction) / (torch.sqrt(n / nu_correction) + self.eps)
            p.add_(-self.learning_rate * step)
