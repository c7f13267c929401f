"""Data-parallel learner updates over a :class:`~.mesh.Mesh` (counterpart of
``pfrl_tpu/parallel/data_parallel.py``).

Each rank differentiates its share of the batch; the gradients are
all-reduced before the optimizer's step, so every rank takes the
identical step and the replicated weights stay equal to the bit. The JAX
wrapper leaves the gradient ``pmean`` to ``update_fn`` (``pmean_grads``
inside it) and averages the aux metrics; here a core's optimizers are
wrapped by :class:`AllReduceGradients` (:func:`data_parallel_core` wraps
every one of a core's), and :func:`data_parallel_update` shards the batch
and reduces the metrics.

**Mean or sum.** A core whose loss is a mean over the batch (the
``"mean"`` accumulator, and every on-policy loss) gets the mean of the
ranks' gradients: with equal shares that is the gradient of the mean over
the whole batch. A core whose ``batch_accumulator`` is ``"sum"`` gets their
sum, the gradient of the sum over the whole batch, and its ``loss`` metric
is summed too. Either way the result equals the single-process update up
to the order of the reduction (ROADMAP C22, C54); over one rank it is the
single-process update to the bit.

An update that draws from the draw source (IQN's taus, a noisy net's
noise) is refused by name under a mesh: each rank would draw the whole
batch's draws and use its share, which the cores do not do yet.
"""

import copy
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from pfrl_tpu_torch.parallel.mesh import Mesh, all_gather_rows, shard_batch


def _reduce(mesh: Mesh, tensors, op: str) -> list:
    """All-reduce a list of tensors (a sum, divided by the world size for
    ``"mean"``); returns new tensors."""
    out = []
    for t in tensors:
        r = t.detach().clone().contiguous()
        dist.all_reduce(r, op=dist.ReduceOp.SUM)
        out.append(r / mesh.size if op == "mean" else r)
    return out


def pmean_grads(grads, mesh: Mesh, op: str = "mean") -> list:
    """The ranks' gradients averaged (``op="mean"``) or summed
    (``op="sum"``) with an all-reduce, in the order given."""
    if op not in ("mean", "sum"):
        raise ValueError(f"op: {op!r}")
    return _reduce(mesh, list(grads), op)


class AllReduceGradients:
    """An optimizer whose ``update`` all-reduces the gradients first (the
    optax ``chain`` of a ``pmean`` and ``inner``)."""

    def __init__(self, inner, mesh: Mesh, op: str = "mean"):
        self.inner, self.mesh, self.op = inner, mesh, op

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state) -> None:
        return self.inner.update(params, pmean_grads(grads, self.mesh, self.op), state)


class _NoDraws:
    """The draw source of an update under a mesh: any draw raises."""

    def __init__(self, core):
        self.core = type(core).__name__

    def __getattr__(self, name):
        raise NotImplementedError(f"{self.core}'s update draws ({name}); draws inside a data-parallel "
                                  "update are not ported")


def accumulator(core) -> str:
    """``"sum"`` for a core whose loss sums over the batch, else ``"mean"``."""
    return "sum" if getattr(core, "batch_accumulator", "mean") == "sum" else "mean"


def data_parallel_core(core, mesh: Mesh):
    """A shallow copy of ``core`` whose optimizers (every attribute named
    ``optimizer`` or ``*_optimizer``) all-reduce their gradients over
    ``mesh``, with ``core.mesh`` set (an on-policy core splits each
    minibatch over it). The original core is left as it is; the states
    it made stay valid for the copy."""
    dp = copy.copy(core)
    op = accumulator(core)
    for name, value in vars(core).items():
        if (name == "optimizer" or name.endswith("_optimizer")) and hasattr(value, "update"):
            setattr(dp, name, AllReduceGradients(value, mesh, op))
    dp.mesh = mesh
    return dp


def reduce_aux(mesh: Mesh, aux: dict, op: str = "mean", share_rows: Optional[int] = None) -> dict:
    """The metrics of the ranks' updates made whole: a tensor of
    ``share_rows`` rows (a per-sample quantity: ``errors``) is gathered in
    rank order; any other floating tensor is averaged over the ranks, the
    ``loss`` of a ``"sum"`` core summed; the rest is kept."""
    out = {}
    for k, v in aux.items():
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            out[k] = v
        elif share_rows is not None and v.dim() >= 1 and v.shape[0] == share_rows:
            out[k] = all_gather_rows(mesh, v)
        else:
            out[k] = _reduce(mesh, [v], "sum" if (op == "sum" and k == "loss") else "mean")[0]
    return out


def data_parallel_update(mesh: Mesh, update_fn: Callable, op: str = "mean") -> Callable:
    """Wrap ``update_fn(state, batch, draws) -> (state, aux)``: it runs on
    this rank's rows of ``batch`` (whose leading axis splits evenly over
    the mesh) with a draw source that refuses to draw, and its metrics are
    made whole (:func:`reduce_aux`). ``update_fn`` must all-reduce its
    gradients itself: pass the update of a :func:`data_parallel_core`."""
    def wrapped(state, batch, draws=None) -> Any:
        share = shard_batch(mesh, batch)
        rows = share.reward.shape[0] if hasattr(share, "reward") else None
        owner = getattr(update_fn, "__self__", update_fn)
        state, aux = update_fn(state, share, _NoDraws(owner))
        return state, reduce_aux(mesh, aux, op, rows)

    return wrapped
