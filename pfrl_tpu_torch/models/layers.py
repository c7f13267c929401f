"""Linear and convolution layers with flax's dtype arithmetic.

flax's ``Dense`` and ``Conv`` promote their input, kernel and bias to one
dtype (``promote_dtype``), take the product in it and add the bias after.
Below float32 the product is rounded to that dtype before the bias is
added; ``F.linear`` and ``F.conv2d`` with a fused bias round once, which
differs from flax by an ulp in a quarter of the outputs. So below float32
these layers add the bias after the product. In float32 they are
``F.linear`` and ``F.conv2d`` as before.

torch refuses mixed dtypes in ``@`` and ``F.linear``; jnp promotes them (a
float32 input through bfloat16 parameters computes in float32). These
layers promote first, as jnp does.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def promoted(*tensors: torch.Tensor):
    """The tensors in their common promoted dtype (``jnp.result_type``).
    Tensors of one dtype come back as they are, with no op dispatched."""
    dtype = tensors[0].dtype
    if all(t.dtype == dtype for t in tensors[1:]):
        return tensors
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ weight.T + bias`` in the promoted dtype; ``weight`` is ``[out, in]``;
    ``bias`` None: no bias (flax's ``use_bias=False``)."""
    if bias is None:
        x, weight = promoted(x, weight)
        return F.linear(x, weight) if x.dtype == torch.float32 else x @ weight.T
    x, weight, bias = promoted(x, weight, bias)
    if x.dtype == torch.float32:
        return F.linear(x, weight, bias)
    return x @ weight.T + bias


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride) -> torch.Tensor:
    """A VALID convolution of NCHW ``x`` in the promoted dtype."""
    x, weight, bias = promoted(x, weight, bias)
    if x.dtype == torch.float32:
        return F.conv2d(x, weight, bias, stride=stride)
    return F.conv2d(x, weight, None, stride=stride) + bias[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` through :func:`linear`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (no padding) through :func:`conv2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride)
