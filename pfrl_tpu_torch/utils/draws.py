"""Sources of random draws, the port's counterpart of JAX PRNG keys.

JAX threads a key through every random function; the port passes a draw
source instead: any object with ``uniform(n)``, ``normal(n)``,
``randint(high, n)``, ``randint_below(high, n)`` and ``permutation(n)``.
:class:`Draws` takes every draw from one ``torch.Generator`` on the device.
The parity tests pass a source of their own that hands the JAX package the
very same numbers (the two frameworks' generators never agree).

**Draw kinds.** Under a mesh each rank holds its share of the lanes or of a
batch's rows, and every draw is drawn whole from an equally seeded source
on every rank (``parallel/lane_sharding.py``). A draw names its kind where
it is made, never inferred from its shape: :func:`per_row` (and the
helpers built on it, :func:`normal`, :func:`uniform`,
:func:`uniform_between`, :func:`categorical`) is a draw with one block of
numbers per row, the rows on a stated axis, of which a rank keeps its own
rows; :func:`per_parameter` is a draw for the weights (a noisy layer's
``eps_in`` and ``eps_out``), which every rank uses whole. On a plain
source both are one flat draw, reshaped row-major.
"""

import math

import numpy as np
import torch


class Draws:
    """Uniform and normal floats and integers from one ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def state_dict(self) -> dict:
        """The generator's state (a CUDA generator's seed and offset, or a
        CPU generator's whole state): what a resumed run needs to draw the
        same numbers."""
        return {"generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.generator.set_state(state["generator"])

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

    def permutation(self, n: int) -> torch.Tensor:
        """int64 ``[n]``, a random order of ``0 .. n - 1``. It only indexes,
        so it stays int64: an int32 index is widened at every indexing op."""
        return torch.randperm(n, generator=self.generator, device=self.device)


def per_row(draws, kind: str, shape, row_axis: int = 0) -> torch.Tensor:
    """A per-row draw of ``shape`` (``kind`` ``"uniform"`` or ``"normal"``):
    one ``draws.<kind>`` of its element count, reshaped row-major. A
    source that holds a rank's share (``draws.rows``) draws the whole
    batch's and keeps this rank's rows on ``row_axis``."""
    shape = tuple(shape)
    if hasattr(draws, "rows"):
        return draws.rows(kind, shape, row_axis)
    return getattr(draws, kind)(math.prod(shape)).reshape(shape)


def per_parameter(draws, kind: str, n: int) -> torch.Tensor:
    """A draw of ``n`` numbers for the weights, the same on every rank of a
    mesh (``draws.whole``)."""
    if hasattr(draws, "whole"):
        return draws.whole(kind, n)
    return getattr(draws, kind)(n)


def normal(draws, shape, row_axis: int = 0) -> torch.Tensor:
    """Standard normal float32 of ``shape``, a per-row draw (row-major, as
    ``jax.random.normal`` fills)."""
    return per_row(draws, "normal", shape, row_axis)


def uniform(draws, shape, row_axis: int = 0) -> torch.Tensor:
    """float32 of ``shape`` in ``[0, 1)``, a per-row draw."""
    return per_row(draws, "uniform", shape, row_axis)


def uniform_between(draws, low: float, high: float, shape) -> torch.Tensor:
    """float32 of ``shape`` in ``[low, high)`` from one ``draws.uniform``,
    with the arithmetic of ``jax.random.uniform(key, shape, minval=low,
    maxval=high)``: ``max(low, u * (high - low) + low)``, each op rounded
    to float32 (where XLA fuses the product into the add, a value moves by
    an ulp)."""
    low32, high32 = np.float32(low), np.float32(high)
    u = uniform(draws, shape)
    return torch.clamp_min(u * float(high32 - low32) + float(low32), float(low32))


def categorical(draws, logits: torch.Tensor) -> torch.Tensor:
    """int64 indices ``[...]``, one sample per row of ``logits [..., n]`` by
    the Gumbel-max trick, as ``jax.random.categorical`` samples: one
    per-row ``uniform`` of the logits' shape, ``u`` clamped to
    ``[tiny, 1)`` (JAX's ``gumbel`` at ``mode="low"`` draws over that range),
    then ``argmax(logits - log(-log(u)))`` over the last axis."""
    u = uniform(draws, logits.shape)
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)
