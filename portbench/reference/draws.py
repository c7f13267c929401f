"""Draw sources: the one the benchmark hands the program, and its replay.

The port takes its random numbers from a draw source (``uniform(n)``,
``randint(high, n)``, ``randint_below(high, n)``, ``normal(n)``,
``permutation(n)``). :class:`LoggedDraws` is such a source over one
``torch.Generator`` on the device, seeded by the benchmark, which keeps
every draw. :class:`ReplayedDraws` hands the same
numbers, in the same order, to the reference: each draw must be asked for
with the kind and size it was made with, or :class:`DrawMismatch` is raised.
``randint_below`` keeps its 62 raw bits, so that the reference reduces them
by a bound of its own working.

The port documents the order of its draws in a scan step (the act's, the
env's resets, each update's sample), so a draw marks a point of the step:
``LoggedDraws.observer``, where set, is called with a draw's index in the
log before the draw is made, and the benchmark reads the program's state
there.
"""

from typing import Callable, List, Optional, Tuple

import torch


class DrawMismatch(Exception):
    """The reference asked for another draw than the one that was made."""


class LoggedDraws:
    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device
        self.log: List[Tuple[str, int, Optional[int], torch.Tensor]] = []
        self.observer: Optional[Callable[[int], None]] = None

    def _before(self) -> None:
        if self.observer is not None:
            self.observer(len(self.log))

    def _keep(self, kind: str, n: int, high, x: torch.Tensor) -> torch.Tensor:
        self.log.append((kind, n, high, x))
        return x

    def uniform(self, n: int) -> torch.Tensor:
        self._before()
        return self._keep("uniform", n, None, torch.rand(n, generator=self.generator, device=self.device))

    def normal(self, n: int) -> torch.Tensor:
        self._before()
        return self._keep("normal", n, None, torch.randn(n, generator=self.generator, device=self.device))

    def randint(self, high: int, n: int) -> torch.Tensor:
        self._before()
        x = torch.randint(0, high, (n,), generator=self.generator, device=self.device, dtype=torch.int32)
        return self._keep("randint", n, int(high), x)

    def randint_below(self, high: torch.Tensor, n: int) -> torch.Tensor:
        self._before()
        bits = torch.randint(0, 1 << 62, (n,), generator=self.generator, device=self.device, dtype=torch.int64)
        self._keep("randint_below", n, None, bits)
        return (bits % high).to(torch.int32)

    def permutation(self, n: int) -> torch.Tensor:
        self._before()
        return self._keep("permutation", n, None, torch.randperm(n, generator=self.generator, device=self.device))


class ReplayedDraws:
    def __init__(self, log):
        self.log = log
        self.at = 0

    def _next(self, kind: str, n: int, high=None) -> torch.Tensor:
        if self.at >= len(self.log):
            raise DrawMismatch(f"draw {self.at}: {kind}({n}) asked for, but the run made no more draws")
        k, m, h, x = self.log[self.at]
        if (k, m, h) != (kind, n, high):
            raise DrawMismatch(f"draw {self.at}: {kind}({n}, high={high}) asked for, {k}({m}, high={h}) made")
        self.at += 1
        return x

    def raw(self, kind: str, n: int, high=None) -> torch.Tensor:
        """The next draw as it was logged (``randint_below``'s raw bits)."""
        return self._next(kind, n, high)

    def uniform(self, n: int) -> torch.Tensor:
        return self._next("uniform", n)

    def normal(self, n: int) -> torch.Tensor:
        return self._next("normal", n)

    def randint(self, high: int, n: int) -> torch.Tensor:
        return self._next("randint", n, int(high))

    def randint_below(self, high: torch.Tensor, n: int) -> torch.Tensor:
        return (self._next("randint_below", n) % high).to(torch.int32)

    def permutation(self, n: int) -> torch.Tensor:
        return self._next("permutation", n)
