"""PER prefix sampling: the hand-written CUDA kernel, its wrapper and its
plain version.

``out[b] = #{i : cumsum(priorities)[i] <= targets[b]}``, the leaf whose
cumulative-priority interval holds each target. Counterpart of
``pfrl_tpu/ops/pallas_kernels.py::prefix_sample_pallas`` (the Pallas
kernel) and ``prefix_sample_reference`` (its XLA version). The kernel's
design and bound are in ``csrc/prefix_sample.cu``.

:func:`prefix_sample` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; there is no fallback between them.
"""

import ctypes

import torch

from pfrl_tpu_torch.ops import cuda_build

MAX_LEN = 2**31 - 1  # leaves and targets are counted in int32


def prefix_sample_reference(priorities: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: cumsum, then compare and count."""
    cs = torch.cumsum(priorities, 0)
    return (cs[None, :] <= targets[:, None]).sum(1).to(torch.int32)


def _check(priorities: torch.Tensor, targets: torch.Tensor) -> None:
    for name, x in (("priorities", priorities), ("targets", targets)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(x.shape)}")
        if not 1 <= x.shape[0] <= MAX_LEN:
            raise ValueError(f"{name} length must be in [1, 2**31 - 1], got {x.shape[0]}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if priorities.device != targets.device:
        raise ValueError(
            f"priorities on {priorities.device} but targets on {targets.device}"
        )
    if priorities.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {priorities.device}")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("prefix_sample")
    if not getattr(lib, "_typed", False):
        lib.prefix_sample_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.prefix_sample_launch.restype = ctypes.c_int
        lib.prefix_sample_chunk.argtypes = []
        lib.prefix_sample_chunk.restype = ctypes.c_int
        lib.prefix_sample_error_string.argtypes = [ctypes.c_int]
        lib.prefix_sample_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def prefix_sample(priorities: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """int32 ``[B]`` counts; launches the CUDA kernel on CUDA tensors.

    Takes float32 1-D contiguous ``priorities [C]`` and ``targets [B]`` on
    one device, any C and B in [1, 2**31 - 1]. Raises on anything else.
    Each kernel launch adds one to ``prefix_sample.launches``.
    """
    _check(priorities, targets)
    if priorities.device.type == "cpu":
        return prefix_sample_reference(priorities, targets)
    lib = _library()
    n, b = priorities.shape[0], targets.shape[0]
    chunk = lib.prefix_sample_chunk()
    device = priorities.device
    totals = torch.empty((n + chunk - 1) // chunk, dtype=torch.float32, device=device)
    out = torch.empty(b, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.prefix_sample_launch(
            priorities.data_ptr(), n, targets.data_ptr(), b,
            totals.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.prefix_sample_error_string(err).decode()
        raise RuntimeError(f"prefix_sample kernel launch failed: {msg} ({err})")
    prefix_sample.launches += 1
    return out


prefix_sample.launches = 0
