"""Observation feature maps (counterpart of ``pfrl_tpu/utils/batch_states.py``)."""

import torch


def atari_phi(x: torch.Tensor) -> torch.Tensor:
    """Dtype-aware Atari feature map: ``uint8 -> float32 / 255``.

    Float input passes through unchanged: the replay gather already
    dequantized it with ``x * (1/255)`` (``fused_dequant_scale``). The two
    ops differ in the last ulp, so each path keeps its own, as the JAX
    package does.
    """
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x
