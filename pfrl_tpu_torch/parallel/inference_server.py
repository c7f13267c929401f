"""Batched inference for host-side actor threads (counterpart of
``pfrl_tpu/parallel/inference_server.py``).

Actors own no parameters. Each submits its observations to one server
thread, which stacks the requests of a short window into one batch, runs
one forward of the learner's acting network on the card and routes each
slice of the actions back to its caller.

The batch is padded to ``n_slots`` rows (copies of its first row), as the
JAX server pads it for its one compile per ``training`` flag. Torch needs
no fixed shape, but the act's draws (ε-greedy's uniforms and random
actions) cover the whole padded batch, and the actions match the JAX
package's only on the same draws of the same shape.

Requests are row-batched: an actor that drives K env lanes submits one
request of K rows (``submit_batch``), and the server concatenates requests
up to ``n_slots`` rows. A request of the other ``training`` flag, or one
that would overflow ``n_slots``, starts the next batch. The window waits
up to half the forward's moving average for stragglers (clamped to
50 ms, or ``timeout`` if larger); the first forward of each flag (in the
port: cuDNN's algorithm choice and the allocator's warm-up) and gross
outliers stay out of the average. An error of a forward reaches every
actor waiting on that batch; ``stop`` fails every request still queued,
and a server thread that dies for any reason fails what it holds.
"""

import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _concatenate(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.cat(xs)
    return np.concatenate(xs)


def _pad(x, pad: int):
    if isinstance(x, torch.Tensor):
        return x[:1].expand((pad,) + tuple(x.shape[1:]))
    return np.broadcast_to(x[:1], (pad,) + x.shape[1:])


def _as_batch_leaf(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


class _Request:
    __slots__ = ("obs", "rows", "training", "event", "actions", "error")

    def __init__(self, obs, rows, training):
        self.obs = obs  # [rows, ...] leaves
        self.rows = rows
        self.training = training
        self.event = threading.Event()
        self.actions = None  # [rows, ...] numpy on completion
        self.error = None


class BatchedInferenceServer:
    """Micro-batching action server shared by all actor threads.

    Args:
        act_fn: ``act_fn(seed: int, obs[n_slots], t: int, training: bool)
            -> actions[n_slots]`` (a tensor or an array), called on the
            server thread only; ``seed`` counts the batches from 1 (the JAX
            server's ``PRNGKey(seed)``; the port's act draws from a source
            of the server thread's own).
        n_slots: the batch's width in rows, to which every batch is padded:
            normally every env lane (actors x lanes per actor).
        t_fn: the global env-step count handed to the explorer's schedule.
        timeout: the shortest collection window, in seconds.
    """

    def __init__(self, act_fn: Callable[..., Any], n_slots: int, t_fn: Callable[[], int] = lambda: 0,
                 timeout: float = 0.002):
        self.act_fn = act_fn
        self.n_slots = n_slots
        self.t_fn = t_fn
        self.timeout = timeout
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._seed = 0
        self._thread: Optional[threading.Thread] = None
        self._fwd_ema = 0.0
        self._warm_flags = set()
        # Host timings: rows per forward, and each request's round trip as
        # ``(submitted, answered)`` on ``time.perf_counter``'s clock.
        self.batch_rows = []
        self.round_trips = []

    # ---------------------------------------------------------------- server
    def start(self) -> None:
        self._thread = threading.Thread(target=self._serve, daemon=True, name="inference-server")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def _serve(self) -> None:
        pending: list = []
        batch: list = []
        try:
            while not self._stop.is_set():
                try:
                    first = pending.pop(0) if pending else self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                batch = [first]
                rows = first.rows
                # Collect until the batch is full or the window closes.
                deadline = time.monotonic() + min(max(0.05, self.timeout), max(self.timeout, 0.5 * self._fwd_ema))
                while rows < self.n_slots:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        req = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if req.training != first.training or rows + req.rows > self.n_slots:
                        pending.append(req)
                        break
                    batch.append(req)
                    rows += req.rows
                try:
                    t0 = time.monotonic()
                    self._run_batch(batch, rows)
                    dt = time.monotonic() - t0
                    if first.training not in self._warm_flags:
                        self._warm_flags.add(first.training)  # the first forward of a flag warms up
                    elif not (self._fwd_ema and dt > 10.0 * self._fwd_ema):  # a gross outlier is dropped
                        self._fwd_ema = dt if not self._fwd_ema else 0.9 * self._fwd_ema + 0.1 * dt
                except Exception as e:  # every waiting actor raises it
                    for req in batch:
                        req.error = e
                        req.event.set()
                batch = []
        finally:
            # Whatever ends the loop, no actor waits for ever.
            leftovers = [r for r in batch if not r.event.is_set()] + pending
            while True:
                try:
                    leftovers.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            for req in leftovers:
                req.error = RuntimeError("inference server stopped")
                req.event.set()

    def _run_batch(self, batch, rows) -> None:
        pad = self.n_slots - rows
        parts = [r.obs for r in batch]
        if pad:
            parts.append(_map(lambda x: _pad(x, pad), batch[0].obs))
        obs = parts[0] if len(parts) == 1 else _map(_concatenate, *parts)
        self._seed += 1
        actions = self.act_fn(self._seed, obs, self.t_fn(), batch[0].training)
        if isinstance(actions, torch.Tensor):
            actions = actions.cpu().numpy()
        actions = np.asarray(actions)
        self.batch_rows.append(rows)
        off = 0
        for req in batch:
            req.actions = actions[off: off + req.rows]
            off += req.rows
            req.event.set()

    # ---------------------------------------------------------------- client
    def submit_batch(self, obs, training: bool):
        """Blocking act for row-batched observations ``obs[K, ...]`` (an
        array, a tensor, or a tuple, list or dict of them with one shared
        leading dimension K). One unbatched array of one leaf cannot be told
        from K rows: the caller owns the batching of one-leaf observations."""
        obs = _map(_as_batch_leaf, obs)
        dims = {x.shape[0] if x.ndim else None for x in _leaves(obs)}
        if len(dims) != 1 or None in dims:
            raise ValueError(f"submit_batch requires [K, ...] leaves with one shared leading dimension; "
                             f"got leading dims {sorted(map(str, dims))}")
        rows = dims.pop()
        if rows > self.n_slots:
            raise ValueError(f"request of {rows} rows exceeds the server's batch width n_slots={self.n_slots}")
        req = _Request(obs, rows, training)
        t0 = time.perf_counter()
        self._queue.put(req)
        while not req.event.wait(0.05):
            if self._thread is not None and not self._thread.is_alive() and not req.event.is_set():
                req.error = RuntimeError("inference server stopped")  # it died after draining its queue
                break
        self.round_trips.append((t0, time.perf_counter()))
        if req.error is not None:
            raise req.error
        return req.actions

    def submit(self, obs, training: bool):
        """Blocking act for one observation row."""
        return self.submit_batch(_map(lambda x: _as_batch_leaf(x)[None], obs), training)[0]
