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


CLUSTER = 16  # blocks in the kernel's one cluster: kCluster in csrc/prefix_sample.cu

_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of a built kernel library."""
    lib.prefix_sample_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.prefix_sample_launch.restype = ctypes.c_int
    lib.prefix_sample_max_active_clusters.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    lib.prefix_sample_max_active_clusters.restype = ctypes.c_int
    lib.prefix_sample_smem_bytes.argtypes = [ctypes.c_longlong]
    lib.prefix_sample_smem_bytes.restype = ctypes.c_longlong
    lib.prefix_sample_error_string.argtypes = [ctypes.c_int]
    lib.prefix_sample_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    """The built kernel library, bound once."""
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load("prefix_sample"))
    return _lib


def _raise(lib: ctypes.CDLL, err: int, what: str) -> None:
    msg = lib.prefix_sample_error_string(err).decode()
    raise RuntimeError(f"prefix_sample {what} failed: {msg} ({err})")


def cluster_info(n: int) -> dict:
    """Dynamic shared memory per block and how many of the kernel's
    clusters the current device can hold at once, for a call over ``n``
    leaves."""
    lib = _library()
    count = ctypes.c_int(0)
    err = lib.prefix_sample_max_active_clusters(n, ctypes.byref(count))
    if err != 0:
        _raise(lib, err, "occupancy query")
    return {
        "cluster": CLUSTER,
        "smem_bytes_per_block": lib.prefix_sample_smem_bytes(n),
        "max_active_clusters": count.value,
    }


def prefix_sample(priorities: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """int32 ``[B]`` counts; launches the CUDA kernel on CUDA tensors.

    Takes float32 1-D contiguous ``priorities [C]`` (non-negative) and
    ``targets [B]`` on one device, any C and B in [1, 2**31 - 1]. Raises on
    anything else. Each call on CUDA tensors is one kernel launch and adds
    one to ``prefix_sample.launches``.
    """
    _check(priorities, targets)
    device = priorities.device
    if device.type == "cpu":
        return prefix_sample_reference(priorities, targets)
    lib = _lib or _library()
    n, b = priorities.shape[0], targets.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=device)
    err = lib.prefix_sample_launch(
        priorities.data_ptr(), n, targets.data_ptr(), b, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(device.index), device.index,
    )
    if err != 0:
        _raise(lib, err, "kernel launch")
    prefix_sample.launches += 1
    return out


prefix_sample.launches = 0
