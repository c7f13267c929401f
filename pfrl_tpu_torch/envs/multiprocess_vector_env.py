"""Subprocess-per-env host vector env (counterpart of
``pfrl_tpu/envs/multiprocess_vector_env.py``; reference parity:
pfrl/envs/multiprocess_vector_env.py:11-141): the same pipe protocol
(step, reset, close, get_spaces, seed), and a masked reset keeps the last
observation of the envs still running.

The workers are **spawned**, never forked: the parent may have initialised
CUDA, and a fork of it would inherit a CUDA context it cannot use. Each
factory ships to its worker by ``pickle`` (no ``cloudpickle``), so it must
be a module-level function or a ``functools.partial`` of one; a lambda or a
closure raises here, naming the cause. The worker imports this module,
``env.py`` and what its factory needs, and no torch, as long as the
factory's module imports none: a worker of the shipped factories
(``envs/synthetic_ale.py``, ``wrappers/``, ``envs/gymnasium_env.py``) never
loads torch and so never touches the card. A script run as ``__main__`` is
re-imported by every spawned process, as Python's ``spawn`` does.
"""

import concurrent.futures
import multiprocessing as mp
import pickle
import time
from multiprocessing.connection import Connection

import numpy as np

from pfrl_tpu_torch.env import VectorEnv


def _worker(remote: Connection, env_fn_bytes: bytes) -> None:
    env = pickle.loads(env_fn_bytes)()
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                remote.send(env.step(data))
            elif cmd == "reset":
                remote.send(env.reset())
            elif cmd == "close":
                remote.close()
                break
            elif cmd == "get_spaces":
                remote.send((env.action_space, env.observation_space))
            elif cmd == "seed":
                remote.send(env.seed(data) if hasattr(env, "seed") else None)
            else:
                raise NotImplementedError(cmd)
    finally:
        env.close()


def _pickled(env_fn) -> bytes:
    try:
        return pickle.dumps(env_fn)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"MultiprocessVectorEnv ships each env factory to a spawned worker with pickle, and "
            f"{env_fn!r} cannot be pickled ({e}); pass a module-level function or a "
            f"functools.partial of one in place of a lambda or a closure"
        ) from e


class MultiprocessVectorEnv(VectorEnv):
    """One spawned worker process per env factory. ``startup_s`` is the
    wall time from the first spawn to every worker's answer to
    ``get_spaces`` (so every env was built)."""

    def __init__(self, env_fns):
        payloads = [_pickled(fn) for fn in env_fns]
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        self.remotes, work_remotes = zip(*[ctx.Pipe() for _ in payloads])
        self.ps = [
            ctx.Process(target=_worker, args=(work_remote, payload), daemon=True)
            for work_remote, payload in zip(work_remotes, payloads)
        ]
        for p in self.ps:
            p.start()
        for work_remote in work_remotes:
            work_remote.close()  # the parent's copy: a worker that dies is an EOF
        self.closed = False
        self.last_obs = [None] * len(payloads)
        try:
            spaces = self._roundtrip("get_spaces")
        except RuntimeError:
            self.close()
            raise
        self.action_space, self.observation_space = spaces[0]
        self.startup_s = time.perf_counter() - t0

    def __del__(self):
        if not getattr(self, "closed", True):
            self.close()

    @property
    def num_envs(self) -> int:
        return len(self.remotes)

    def _roundtrip(self, cmd, payloads=None, lanes=None):
        """Sends ``(cmd, payload)`` to the selected lanes, then collects one
        reply per lane (the reference's wire protocol)."""
        assert not self.closed, "This env is already closed"
        picked = range(self.num_envs) if lanes is None else lanes
        replies = {}
        try:
            for i in picked:
                self.remotes[i].send((cmd, None if payloads is None else payloads[i]))
            for i in picked:
                replies[i] = self.remotes[i].recv()
        except (EOFError, OSError):
            dead = [j for j, p in enumerate(self.ps) if not p.is_alive()]
            raise RuntimeError(
                f"worker {dead[0] if dead else i} of MultiprocessVectorEnv ended (exit codes "
                f"{[self.ps[j].exitcode for j in dead]}); its error is on its stderr"
            ) from None
        return replies

    def step(self, actions):
        replies = self._roundtrip("step", list(actions))
        obss, rews, dones, infos = zip(*[replies[i] for i in range(self.num_envs)])
        self.last_obs = list(obss)
        return obss, np.asarray(rews, dtype=np.float32), np.asarray(dones, dtype=bool), infos

    def reset(self, mask=None):
        """``mask`` true: the lane is still running and keeps its last
        observation."""
        if mask is None:
            mask = np.zeros(self.num_envs, dtype=bool)
        fresh = self._roundtrip("reset", lanes=[i for i in range(self.num_envs) if not mask[i]])
        self.last_obs = [fresh.get(i, self.last_obs[i]) for i in range(self.num_envs)]
        return list(self.last_obs)

    def seed(self, seeds=None):
        if seeds is None:
            seeds = [None] * self.num_envs
        elif np.isscalar(seeds):
            seeds = [seeds] * self.num_envs
        else:
            seeds = list(seeds)
        replies = self._roundtrip("seed", seeds)
        return [replies[i] for i in range(self.num_envs)]

    def close(self):
        assert not self.closed, "This env is already closed"
        self.closed = True
        for remote in self.remotes:
            try:
                remote.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self.ps:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        for remote in self.remotes:
            remote.close()


def make_together(*makers):
    """Call each of ``makers`` (functions that build a vector env) in a
    thread of its own, so that their spawned workers start at once; returns
    the envs in order. If any fails, the ones built are closed and its
    error is raised."""
    with concurrent.futures.ThreadPoolExecutor(len(makers)) as pool:
        futures = [pool.submit(make) for make in makers]
    envs, errors = [], []
    for future in futures:
        try:
            envs.append(future.result())
        except BaseException as e:  # noqa: B902 -- raised below, after the others are closed
            errors.append(e)
    if errors:
        for env in envs:
            env.close()
        raise errors[0]
    return tuple(envs)
