"""A data mesh over a ``torch.distributed`` process group (counterpart of
``pfrl_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over devices and lets XLA
place sharded arrays. The port runs one process per card (or, on the CPU,
per Gloo rank), so its mesh is a plain description of the process group:
the axis name, the number of ranks and this process's rank. Sharding is
done by hand: :func:`shard_batch` keeps this rank's rows of a lane-major
batch, :func:`replicate` broadcasts rank 0's values, and :func:`all_gather`
stacks every rank's tensor.

Only 1-D data meshes exist: RL models are small, so the lanes and the
replay ring shard over the ranks and the weights replicate, as in the JAX
package.
"""

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` and ``shape`` as the JAX mesh has them (every axis
    after the first of size 1); ``rank`` is this process's index along the
    data axis of the default process group."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over every rank of the (initialized) default process group.

    ``shape`` defaults to ``(world_size, 1, ...)``; a given one must hold
    the world size on its first axis and 1 on every other."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (initialize_multihost)")
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    shape = (world,) + (1,) * (len(axis_names) - 1) if shape is None else tuple(shape)
    if len(shape) != len(axis_names) or shape[0] != world or any(s != 1 for s in shape[1:]):
        raise ValueError(f"a data mesh over {world} ranks has shape ({world}, 1, ...), not {shape}")
    return Mesh(axis_names, shape, dist.get_rank())


def map_tensors(fn, tree):
    """``fn`` over the tensors of a tensor, dataclass, dict, tuple or list
    tree; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of ``n`` rows split evenly over the mesh."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch, dim: int = 0):
    """This rank's rows of every tensor in ``batch``, whose axis ``dim``
    (the leading one by default) is split evenly over the mesh (a view;
    tensors without that axis are kept whole)."""
    def share(x):
        if x.dim() <= dim:
            return x
        return x[(slice(None),) * dim + (local_rows(mesh, x.shape[dim]),)]

    return map_tensors(share, batch)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``[mesh.size, *x.shape]``: every rank's ``x``, in rank order. Bools
    travel as bytes (not every backend has a bool type)."""
    as_bool = x.dtype == torch.bool
    src = (x.view(torch.uint8) if as_bool else x).contiguous()
    out = torch.empty((mesh.size,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.unbind(0)), src)
    return out.view(torch.bool) if as_bool else out


def all_gather_rows(mesh: Mesh, tree, dim: int = 0):
    """Every rank's rows of each tensor of ``tree`` concatenated along
    ``dim`` in rank order: the inverse of :func:`shard_batch`."""
    def gather(x):
        g = all_gather(mesh, x)  # [n, ..., rows, ...]
        return torch.cat(g.unbind(0), dim=dim)

    return map_tensors(gather, tree)


def replicate(mesh: Mesh, tree):
    """Broadcasts every tensor of ``tree`` (and every parameter and buffer
    of a module in it) from rank 0, in place; returns ``tree``."""
    def broadcast(x):
        with torch.no_grad():
            buf = x.view(torch.uint8) if x.dtype == torch.bool else x
            src = buf.contiguous()
            dist.broadcast(src, 0)
            if src.data_ptr() != buf.data_ptr():
                buf.copy_(src)
        return x

    def walk(node):
        if isinstance(node, torch.nn.Module):
            for t in list(node.parameters()) + list(node.buffers()):
                broadcast(t)
        elif isinstance(node, torch.Tensor):
            broadcast(node)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(tree)
    return tree
