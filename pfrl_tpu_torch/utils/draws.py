"""Sources of random draws, the port's counterpart of JAX PRNG keys.

JAX threads a key through every random function; the port passes a draw
source instead: any object with ``uniform(n)``, ``normal(n)``,
``randint(high, n)`` and ``randint_below(high, n)``. :class:`Draws` takes
every draw from one ``torch.Generator`` on the device.
The parity tests pass a source of their own that hands the JAX package the
very same numbers (the two frameworks' generators never agree).
"""

import numpy as np
import torch


class Draws:
    """Uniform and normal floats and integers from one ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def uniform(self, n: int) -> torch.Tensor:
        """float32 ``[n]`` in ``[0, 1)``."""
        return torch.rand(n, generator=self.generator, device=self.device)

    def randint(self, high: int, n: int) -> torch.Tensor:
        """int32 ``[n]`` in ``[0, high)``."""
        return torch.randint(
            0, high, (n,), generator=self.generator, device=self.device,
            dtype=torch.int32,
        )

    def normal(self, n: int) -> torch.Tensor:
        """float32 ``[n]``, standard normal."""
        return torch.randn(n, generator=self.generator, device=self.device)

    def randint_below(self, high: torch.Tensor, n: int) -> torch.Tensor:
        """int32 ``[n]`` in ``[0, high)`` for a positive bound that is a 0-d
        integer tensor on the device (a ring's fill level, say). The bound
        is never read on the host, so the draw does not wait for the device.
        62 random bits modulo the bound: the bias is below ``high / 2**62``.
        """
        bits = torch.randint(
            0, 1 << 62, (n,), generator=self.generator, device=self.device,
            dtype=torch.int64,
        )
        return (bits % high).to(torch.int32)


def normal(draws, shape) -> torch.Tensor:
    """Standard normal float32 of ``shape``: one ``draws.normal`` of its
    element count, reshaped (row-major, as ``jax.random.normal`` fills)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    return draws.normal(n).reshape(shape)


def uniform_between(draws, low: float, high: float, shape) -> torch.Tensor:
    """float32 of ``shape`` in ``[low, high)`` from one ``draws.uniform``,
    with the arithmetic of ``jax.random.uniform(key, shape, minval=low,
    maxval=high)``: ``max(low, u * (high - low) + low)``, each op rounded
    to float32 (where XLA fuses the product into the add, a value moves by
    an ulp)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    low32, high32 = np.float32(low), np.float32(high)
    u = draws.uniform(n).reshape(shape)
    return torch.clamp_min(u * float(high32 - low32) + float(low32), float(low32))
