"""Device resolution: the card by default, the CPU only when asked for."""

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; raises when there is none.

    There is no quiet fallback to the CPU: a caller that wants the CPU (the
    parity tests) passes ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pfrl_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def use_full_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32, not TF32, and
    reduce bf16 GEMMs in float32.

    At ``compute_dtype=None`` the port runs float32 like the JAX reference;
    cuDNN would otherwise take TF32 for convolutions by default. At
    ``compute_dtype=torch.bfloat16`` XLA accumulates products in float32
    and rounds once; cuBLAS may reduce a bf16 GEMM in bf16 unless
    ``allow_bf16_reduced_precision_reduction`` is off. cuDNN's bf16
    convolutions accumulate in float32 already.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def check_same_device(**named: torch.device) -> torch.device:
    """The one device all ``named`` components live on; raises otherwise."""
    devices = {name: torch.device(d) for name, d in named.items()}
    if len(set(devices.values())) != 1:
        raise ValueError(f"components live on different devices: {devices}")
    return next(iter(devices.values()))
