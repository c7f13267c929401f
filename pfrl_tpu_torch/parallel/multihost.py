"""Joining a multi-process job (counterpart of
``pfrl_tpu/parallel/multihost.py``).

The JAX package calls ``jax.distributed.initialize`` and builds one mesh
over every process's devices. The port runs one process per card (or per
CPU rank) and joins them with ``torch.distributed.init_process_group``
over ``tcp://``: NCCL when the device is a CUDA card, Gloo on the CPU.
Every process then runs the same program on its own lanes
(:func:`local_lane_slice`); the runners all-gather what they must see
whole and all-reduce the gradients. Nothing tells a process of a cluster:
the coordinator's address, the number of processes and this process's
index are given, as arguments or in ``PFRL_TPU_COORDINATOR``,
``PFRL_TPU_NUM_PROCESSES`` and ``PFRL_TPU_PROCESS_ID``.

NCCL refuses two ranks on one card, so one card runs a mesh of one rank
over NCCL; two ranks on one machine run over Gloo on the CPU.
"""

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join the job; returns this process's device (the CUDA card by
    default, whose index is this process's rank modulo the cards it sees;
    ``device="cpu"`` for Gloo). ``coordinator_address`` is ``HOST:PORT``
    (a ``tcp://`` prefix is optional); the three arguments default to the
    ``PFRL_TPU_*`` variables. Raises if any is missing or the group does
    not form within ``timeout_s``: no process runs alone quietly."""
    coordinator_address = coordinator_address or os.environ.get("PFRL_TPU_COORDINATOR")
    if num_processes is None and "PFRL_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PFRL_TPU_NUM_PROCESSES"])
    if process_id is None and "PFRL_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PFRL_TPU_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs the coordinator's address, the number of processes and "
                         "this process's index (arguments or PFRL_TPU_COORDINATOR / PFRL_TPU_NUM_PROCESSES / "
                         "PFRL_TPU_PROCESS_ID)")
    if device is None or torch.device(device).type == "cuda":
        card = resolve_device(device)
        if device is None:
            card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        device, backend = card, "nccl"
    else:
        device, backend = resolve_device(device), "gloo"
    address = coordinator_address if coordinator_address.startswith("tcp://") else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=address, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def global_mesh(axis_names: Sequence[str] = ("dp",)) -> Mesh:
    """The mesh over every process of the job (after
    :func:`initialize_multihost`): one rank per process."""
    return make_mesh(axis_names)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on exactly one process (and in a process that joined no job):
    gate writes, ``scores.txt`` and printing on it."""
    return process_index() == 0


def local_lane_slice(num_global_lanes: int) -> slice:
    """The lanes this process owns of ``num_global_lanes`` split evenly
    over the processes."""
    n = process_count()
    assert num_global_lanes % n == 0, (num_global_lanes, n)
    per = num_global_lanes // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def shutdown() -> None:
    """Leave the job (the process group is global state of the process)."""
    if dist.is_initialized():
        dist.destroy_process_group()
