"""RMSprop with epsilon inside the square root (counterpart of
``pfrl_tpu/optimizers/rmsprop_eps_inside_sqrt.py::rmsprop_eps_inside_sqrt``).

Nature DQN's Torch7 RMSprop divides by ``sqrt(v + eps)``, not by
``sqrt(v) + eps``. This is neither ``torch.optim.RMSprop`` nor the port's
:class:`~pfrl_tpu_torch.optimizers.rmsprop.RMSprop` (``optax.rmsprop``,
which multiplies by ``rsqrt``). In the JAX transform's order of operations:

    square_avg <- alpha * v + (1 - alpha) * g * g
    grad_avg   <- alpha * m + (1 - alpha) * g                 (centered)
    avg         = sqrt(square_avg - grad_avg**2 + eps)        (centered)
                  sqrt(square_avg + eps)                      (otherwise)
    s           = g / avg                                     (a division)
    buf        <- momentum * buf + s                          (momentum > 0)
    param      <- param + (-lr * buf)           or  param + (-lr * s)

The state's ``momentum_buf`` and ``grad_avg`` are ``()`` when unused, as in
the JAX state (flax writes them as ``{}``).

The root is taken in float64 and rounded once to float32, which is the
correctly rounded float32 root that XLA takes: torch's float32 ``sqrt`` on
an AVX-512 CPU is not correctly rounded (670 of 10^5 values an ulp off),
and ``g / avg`` carries that ulp into every update.
"""

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class RMSpropEpsInsideSqrtState:
    square_avg: Any    # one tensor per parameter
    momentum_buf: Any  # one per parameter with momentum, else ()
    grad_avg: Any      # one per parameter when centered, else ()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)


class RMSpropEpsInsideSqrt:
    def __init__(
        self,
        learning_rate: float,
        alpha: float = 0.99,
        eps: float = 1e-8,
        momentum: float = 0.0,
        centered: bool = False,
    ):
        self.learning_rate = learning_rate
        self.alpha = alpha
        self.eps = eps
        self.momentum = momentum
        self.centered = centered

    def init(self, params: Sequence[torch.Tensor]) -> RMSpropEpsInsideSqrtState:
        def zeros():
            return [torch.zeros_like(p) for p in params]

        return RMSpropEpsInsideSqrtState(
            square_avg=zeros(),
            momentum_buf=zeros() if self.momentum > 0 else (),
            grad_avg=zeros() if self.centered else (),
        )

    def load_state(self, state: RMSpropEpsInsideSqrtState, square_avg, momentum_buf=(), grad_avg=()) -> None:
        """Copy the state's trees given as arrays in parameter order (the
        unused ones empty); the transform keeps no count."""
        with torch.no_grad():
            for field, src in (("square_avg", square_avg), ("momentum_buf", momentum_buf), ("grad_avg", grad_avg)):
                dst = getattr(state, field)
                if len(dst) != len(src):
                    raise ValueError(f"{field}: {len(src)} arrays for {len(dst)} tensors")
                for d, s in zip(dst, src):
                    d.copy_(torch.from_numpy(np.array(s)))

    @torch.no_grad()
    def update(
        self,
        params: Sequence[torch.Tensor],
        grads: Sequence[torch.Tensor],
        state: RMSpropEpsInsideSqrtState,
    ) -> None:
        """Updates ``params`` and ``state`` in place."""
        alpha, lr = self.alpha, self.learning_rate
        for i, (p, g) in enumerate(zip(params, grads)):
            v = state.square_avg[i]
            v.copy_(alpha * v + (1 - alpha) * g * g)
            if self.centered:
                m = state.grad_avg[i]
                m.copy_(alpha * m + (1 - alpha) * g)
                avg = _sqrt(v - m * m + self.eps)
            else:
                avg = _sqrt(v + self.eps)
            scaled = g / avg
            if self.momentum > 0:
                buf = state.momentum_buf[i]
                buf.copy_(self.momentum * buf + scaled)
                p.add_(-lr * buf)
            else:
                p.add_(-lr * scaled)
