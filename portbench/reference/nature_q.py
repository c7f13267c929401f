"""The Nature-DQN network as plain functions of a dict of tensors.

Mnih et al. 2015, Methods: three VALID convolutions (32 8x8/4, 64 4x4/2,
64 3x3/1) and a dense layer of 512, each followed by a ReLU, then a linear
head of one output per action. Frames come in as ``[B, h, w, c]`` float32;
the convolutions take them as NCHW and the flattened features are in
(h, w, c) order. Weights are ``[out, in, kh, kw]`` and ``[out, in]``.

``tf32=True`` is the control's precision: on a CUDA device the
convolutions and products run in TF32; on the CPU, which has no TF32, each
product's operands are rounded to TF32's 10-bit mantissa first (the
gradient passes straight through the rounding).
"""

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F


def param_spec(n_actions: int, frame_shape, convs: Sequence[Sequence[int]], hidden: int,
               torso_bias: float) -> List[Tuple[str, Tuple[int, ...], int, float]]:
    """``(name, shape, fan_in, bias value)`` of every parameter, in the
    network's order; the bias value is used only for biases."""
    h, w, c = frame_shape
    spec = []
    for i, (features, k, s) in enumerate(convs):
        spec.append((f"torso.convs.{i}.weight", (features, c, k, k), c * k * k, 0.0))
        spec.append((f"torso.convs.{i}.bias", (features,), 0, torso_bias))
        c, h, w = features, (h - k) // s + 1, (w - k) // s + 1
    spec.append(("torso.dense.weight", (hidden, h * w * c), h * w * c, 0.0))
    spec.append(("torso.dense.bias", (hidden,), 0, torso_bias))
    spec.append(("head.weight", (n_actions, hidden), hidden, 0.0))
    spec.append(("head.bias", (n_actions,), 0, 0.0))
    return spec


def make_weights(spec, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """LeCun-normal weights (std ``1 / sqrt(fan_in)``) from one normal draw
    on the generator's device, and constant biases."""
    device = generator.device
    sizes = [math.prod(shape) for name, shape, _, _ in spec if name.endswith("weight")]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for name, shape, fan_in, bias in spec:
        if name.endswith("weight"):
            n = math.prod(shape)
            out[name] = (flat[at:at + n] / math.sqrt(fan_in)).reshape(shape)
            at += n
        else:
            out[name] = torch.full(shape, bias, dtype=torch.float32, device=device)
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (to nearest, ties away),
    with the gradient of the identity."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


@contextlib.contextmanager
def precision(tf32: bool, device: torch.device):
    """On CUDA: TF32 on for convolutions and products while inside (the
    control) or off (the configuration's float32); restored after."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def q_values(params: Dict[str, torch.Tensor], frames: torch.Tensor, convs, tf32: bool = False) -> torch.Tensor:
    """float32 ``[B, n_actions]`` of float32 frames ``[B, h, w, c]``."""
    emulate = tf32 and frames.device.type != "cuda"
    r = round_tf32 if emulate else (lambda x: x)  # noqa: E731
    x = frames.permute(0, 3, 1, 2)
    for i, (_, _, s) in enumerate(convs):
        x = torch.relu(F.conv2d(r(x), r(params[f"torso.convs.{i}.weight"]), params[f"torso.convs.{i}.bias"], stride=s))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(F.linear(r(x), r(params["torso.dense.weight"]), params["torso.dense.bias"]))
    return F.linear(r(x), r(params["head.weight"]), params["head.bias"])
