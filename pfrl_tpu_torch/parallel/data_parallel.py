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

**Masked means** (a core with ``global_denominator``: the recurrent
value cores and ACER). A mean over a window's valid steps is not the mean
of the ranks' means where their shares hold different numbers of valid
steps. Every rank holds the whole batch of windows before it takes its
share (the episodic buffers gather them), so :func:`data_parallel_update`
hands the share the whole batch's mask (``EpisodeBatch.whole_mask``); the
core divides its share's sum by the whole batch's count, and its
gradients are **summed**: the sum of the ranks' partial losses is the
whole batch's loss. So are the metrics it names in ``summed_metrics``.

**Draws inside the update.** The update draws from :class:`~.lane_sharding.RowDraws`
over the shared source: every draw is drawn whole on every rank, a
per-row draw (IQN's taus, SAC's and TD3's noise, ACER's) keeps this rank's
rows on the rows' axis and a per-parameter draw (a noisy layer's) is used
whole, so the draws equal the single-process update's.
"""

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from pfrl_tpu_torch.parallel.lane_sharding import RowDraws
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


def accumulator(core) -> str:
    """``"sum"`` for a core whose loss sums over the batch or divides by the
    whole batch's count (``global_denominator``), else ``"mean"``."""
    summing = getattr(core, "global_denominator", False) or getattr(core, "batch_accumulator", "mean") == "sum"
    return "sum" if summing else "mean"


def summed_metrics(core) -> tuple:
    """The metrics of ``core``'s update that the ranks' shares sum to."""
    if getattr(core, "global_denominator", False):
        return tuple(getattr(core, "summed_metrics", ("loss",)))
    return ("loss",) if accumulator(core) == "sum" else ()


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


def reduce_aux(mesh: Mesh, aux: dict, summed=(), share_rows: Optional[int] = None) -> dict:
    """The metrics of the ranks' updates made whole: a tensor of
    ``share_rows`` rows (a per-sample or per-window quantity: ``errors``)
    is gathered in rank order; any other floating tensor is averaged over
    the ranks, or summed where its name is in ``summed``; the rest is kept."""
    out = {}
    for k, v in aux.items():
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            out[k] = v
        elif share_rows is not None and v.dim() >= 1 and v.shape[0] == share_rows:
            out[k] = all_gather_rows(mesh, v)
        else:
            out[k] = _reduce(mesh, [v], "sum" if k in summed else "mean")[0]
    return out


def _rows(batch) -> Optional[int]:
    """The rows of a transition batch (``reward [B]``) or of a batch of
    windows (``mask [B, T]``)."""
    if hasattr(batch, "mask"):
        return batch.mask.shape[0]
    return batch.reward.shape[0] if hasattr(batch, "reward") else None


def data_parallel_update(mesh: Mesh, update_fn: Callable, summed=()) -> Callable:
    """Wrap ``update_fn(state, batch, draws) -> (state, aux)`` (a core's
    ``update`` or ``update_episodic``): it runs on this rank's rows of
    ``batch`` (whose leading axis splits evenly over the mesh; a batch of
    windows carries the whole batch's mask too) with
    :class:`~.lane_sharding.RowDraws` over ``draws``, and its metrics are
    made whole (:func:`reduce_aux`, the names in ``summed`` summed).
    ``update_fn`` must all-reduce its gradients itself: pass the update of
    a :func:`data_parallel_core`."""
    def wrapped(state, batch, draws=None) -> Any:
        share = shard_batch(mesh, batch)
        if hasattr(batch, "whole_mask"):  # a batch of windows: its masked means divide by the whole batch's count
            share = dataclasses.replace(share, whole_mask=batch.mask)
        state, aux = update_fn(state, share, RowDraws(draws, mesh))
        return state, reduce_aux(mesh, aux, summed, _rows(share))

    return wrapped
