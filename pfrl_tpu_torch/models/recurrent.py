"""Recurrent cells and containers (counterpart of
``pfrl_tpu/models/recurrent.py``).

Every recurrent module has ``initial_carry(batch_size, device=None)`` (a
zero carry, on the parameters' device by default) and
``forward(x, carry, sequence=False) -> (y, new_carry)``: one step on
``x [B, ...]``, or with ``sequence`` a whole time-major window
``xs [T, B, ...]`` with no resets, ``y`` then ``[T, B, ...]`` and the carry
the final one. Stateless layers inside a container see the window's
``[T, B, ...]`` as it is, so they must take leading axes. Carries are
tensors or nested tuples of tensors (:mod:`pfrl_tpu_torch.utils.recurrent`).

:class:`LSTMCellModule` is flax's ``OptimizedLSTMCell``: the carry is
``(c, h)``; the gates come in the order i, f, g, o with no forget-gate bias
of +1; the input side is one bias-free matmul of the four gates' kernels
concatenated (``ih``, flax's ``ii``/``if``/``ig``/``io``), the hidden side
one matmul with a bias (``hh``, flax's ``hi``/``hf``/``hg``/``ho``), and
the gate pre-activations are ``hh(h) + ih(x)``. Both sides go through
:func:`~pfrl_tpu_torch.models.layers.linear`, so under a bf16 compute dtype
the hidden side, which sees the float32 carry, promotes to float32 while
the input side runs in bf16, as with flax (``torch.nn.LSTMCell`` takes
``(h, c)`` and two fused biases, and is not used). Its ``forward`` with
``sequence`` takes the input side of all steps in one matmul and loops only the
hidden side.

:class:`GRUCellModule` is flax's ``GRUCell``: ``ir``, ``iz``, ``in`` with a
bias, ``hr`` and ``hz`` without, ``hn`` with one;
``n = tanh(in(x) + r * hn(h))`` and ``h' = (1 - z) * n + z * h``.

Initialization follows flax: the input kernels truncated LeCun normal, the
hidden kernels orthogonal per gate, zero biases.
"""

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.models.layers import Linear
from pfrl_tpu_torch.models.mlp import scoped_names
from pfrl_tpu_torch.utils.recurrent import unroll

_GATES = "ifgo"


def _device_of(module: nn.Module, device) -> torch.device:
    return device if device is not None else next(module.parameters()).device


@torch.no_grad()
def _orthogonal_blocks_(weight: torch.Tensor, n_blocks: int, generator=None) -> None:
    for block in weight.chunk(n_blocks, dim=0):
        nn.init.orthogonal_(block, generator=generator)


class LSTMCellModule(nn.Module):
    """One LSTM layer, ``in_size -> features``, carry ``(c, h)``."""

    def __init__(self, in_size: int, features: int):
        super().__init__()
        self.features = features
        self.ih = Linear(in_size, 4 * features, bias=False)
        self.hh = Linear(features, 4 * features)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        initializers.truncated_lecun_normal_(self.ih.weight, generator=generator)
        _orthogonal_blocks_(self.hh.weight, 4, generator)
        self.hh.bias.zero_()

    def flax_names(self) -> Dict[str, Any]:
        return {
            "ih": [f"OptimizedLSTMCell_0/i{g}" for g in _GATES],
            "hh": [f"OptimizedLSTMCell_0/h{g}" for g in _GATES],
        }

    def initial_carry(self, batch_size: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros(batch_size, self.features, dtype=torch.float32, device=_device_of(self, device))
        return (z, z.clone())

    def step(self, xi: torch.Tensor, carry) -> Tuple[torch.Tensor, Any]:
        """One step from the input side already projected, ``xi = ih(x)``."""
        c, h = carry
        i, f, g, o = torch.chunk(self.hh(h) + xi, 4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_c, new_h)

    def forward(self, x: torch.Tensor, carry, sequence: bool = False) -> Tuple[torch.Tensor, Any]:
        if not sequence:
            return self.step(self.ih(x), carry)
        ys = []
        for xi in self.ih(x):
            y, carry = self.step(xi, carry)
            ys.append(y)
        return torch.stack(ys), carry


class GRUCellModule(nn.Module):
    """One GRU layer, ``in_size -> features``, carry ``h``."""

    def __init__(self, in_size: int, features: int):
        super().__init__()
        self.features = features
        for name in ("ir", "iz", "in_"):
            self.add_module(name, Linear(in_size, features))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, Linear(features, features, bias=bias))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.ir, self.iz, self.in_):
            initializers.truncated_lecun_normal_(layer.weight, generator=generator)
            layer.bias.zero_()
        for layer in (self.hr, self.hz, self.hn):
            nn.init.orthogonal_(layer.weight, generator=generator)
        self.hn.bias.zero_()

    def flax_names(self) -> Dict[str, str]:
        return {name: f"GRUCell_0/{name.rstrip('_')}" for name in ("ir", "iz", "in_", "hr", "hz", "hn")}

    def initial_carry(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.zeros(batch_size, self.features, dtype=torch.float32, device=_device_of(self, device))

    def step(self, x: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(self.in_(x) + r * self.hn(h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h

    def forward(self, x: torch.Tensor, h: torch.Tensor, sequence: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return unroll(self.step, x, h) if sequence else self.step(x, h)


def is_recurrent(module: Any) -> bool:
    return hasattr(module, "initial_carry")


def _reset_children(module: nn.Module, generator) -> None:
    for child in module.children():
        if hasattr(child, "reset_parameters"):
            child.reset_parameters(generator)


def _child_names(prefix: str, child: nn.Module) -> Dict[str, Any]:
    """A child's parameters under the flax scope ``prefix``."""
    if hasattr(child, "flax_names"):
        return scoped_names(prefix, prefix, child)
    return {prefix: prefix} if any(True for _ in child.parameters()) else {}


class RecurrentSequential(nn.Module):
    """Stateless and recurrent layers in sequence (modules or plain
    functions such as ``torch.relu``). The carry has one entry per
    recurrent layer. flax names the layers ``layers_<i>`` by position."""

    def __init__(self, *layers):
        super().__init__()
        self.layers = list(layers)
        for i, layer in enumerate(layers):
            if isinstance(layer, nn.Module):
                self.add_module(f"layers_{i}", layer)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_children(self, generator)

    def flax_names(self) -> Dict[str, Any]:
        names = {}
        for name, child in self.named_children():
            names.update(_child_names(name, child))
        return names

    def initial_carry(self, batch_size: int, device=None) -> Tuple:
        return tuple(layer.initial_carry(batch_size, device) for layer in self.layers if is_recurrent(layer))

    def forward(self, x, carry, sequence: bool = False) -> Tuple[Any, Tuple]:
        new_carries, k = [], 0
        for layer in self.layers:
            if is_recurrent(layer):
                x, c = layer(x, carry[k], sequence=sequence)
                new_carries.append(c)
                k += 1
            else:
                x = layer(x)
        return x, tuple(new_carries)


class RecurrentBranched(nn.Module):
    """Parallel branches over one input; the carry is a tuple of the
    branches' carries (``()`` for a stateless branch) and so is the output.
    flax names the branches ``branches_<i>``."""

    def __init__(self, *branches):
        super().__init__()
        self.branches = list(branches)
        for i, branch in enumerate(branches):
            self.add_module(f"branches_{i}", branch)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_children(self, generator)

    def flax_names(self) -> Dict[str, Any]:
        names = {}
        for name, child in self.named_children():
            names.update(_child_names(name, child))
        return names

    def initial_carry(self, batch_size: int, device=None) -> Tuple:
        return tuple(b.initial_carry(batch_size, device) if is_recurrent(b) else () for b in self.branches)

    def forward(self, x, carry, sequence: bool = False) -> Tuple[Tuple, Tuple]:
        outs, new_carries = [], []
        for branch, c in zip(self.branches, carry):
            if is_recurrent(branch):
                y, c = branch(x, c, sequence=sequence)
            else:
                y, c = branch(x), ()
            outs.append(y)
            new_carries.append(c)
        return tuple(outs), tuple(new_carries)
