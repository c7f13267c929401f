"""The actor processes of the Atari pipeline and their channels: shared
memory for data, pipes for credit tokens (counterpart of
``pfrl_tpu/parallel/atari_pipeline.py:77-224``, kept as it is but for
one line: the worker drops its views into the mapping before closing it).

This module imports no torch, and nor do the env factories the port ships
(``envs/synthetic_ale.py``, ``wrappers/atari_wrappers.py``): a spawned actor
process unpickles its factory and runs :func:`_env_worker` without ever
loading torch, so it can never touch the card.

Wire protocol (per worker, per vector step): the worker writes plane +
prev_done into shm slot s and sends ("req", s); the server act-stages,
writes actions into shm and replies ("act", s); the worker steps its K
envs, writes rewards and flags and sends ("trans", s); the committer
drains full rows across workers, commits them, and returns ("free", s)
credits.
"""

import threading
from multiprocessing import shared_memory

import numpy as np


class _WorkerChannel:
    """Main-process handle to one actor process: shm views + pipe."""

    def __init__(self, ctx, worker_id, lanes, slots, hw):
        self.worker_id = worker_id
        self.lanes = lanes
        self.slots = slots
        K, R, HW = lanes, slots, hw[0] * hw[1]
        sizes = {
            "planes": R * K * HW,          # u8
            "prev_done": R * K,            # u8
            "act": R * K * 4,              # i32
            "rew": R * K * 4,              # f32
            "term": R * K,                 # u8
            "done": R * K,                 # u8
        }
        self.shm = shared_memory.SharedMemory(
            create=True, size=sum(sizes.values())
        )
        self.views = _shm_views(self.shm.buf, K, R, hw)
        self.conn, self.child_conn = ctx.Pipe(duplex=True)
        self.send_lock = threading.Lock()
        self.step = 0            # vector steps acted so far (server side)

    def send(self, msg):
        with self.send_lock:
            self.conn.send(msg)

    def close(self):
        try:
            self.conn.close()
        except OSError:
            pass
        # Drop the numpy views before closing: frombuffer arrays hold
        # exported pointers into the mapping.
        self.views = None
        try:
            self.shm.close()
        except BufferError:
            # A worker/thread torn down uncleanly may still pin a view;
            # unlink below still reclaims the segment at process exit.
            pass
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


def _shm_views(buf, K, R, hw):
    """Map the packed shm block to named np arrays (same math both sides)."""
    HW = hw[0] * hw[1]
    out = {}
    off = 0

    def take(name, shape, dtype):
        nonlocal off
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out[name] = np.frombuffer(buf, dtype, count=int(np.prod(shape)), offset=off).reshape(shape)
        off += n

    take("planes", (R, K, HW), np.uint8)
    take("prev_done", (R, K), np.uint8)
    take("act", (R, K), np.int32)
    take("rew", (R, K), np.float32)
    take("term", (R, K), np.uint8)
    take("done", (R, K), np.uint8)
    return out


def _env_worker(child_conn, shm_name, K, R, hw, env_factory, seed0):
    """Actor process: step K envs, move data via shm, tokens via pipe."""
    envs, shm = [], None  # bound before the try: an early SharedMemory or
    #                       env_factory failure must surface, not be masked
    #                       by a NameError in the finally cleanup
    try:
        from multiprocessing import resource_tracker

        shm = shared_memory.SharedMemory(name=shm_name)
        try:  # attached, not owned: the main process unlinks
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        v = _shm_views(shm.buf, K, R, hw)
        envs = []
        for j in range(K):
            envs.append(env_factory(seed0 + j))
        obs = [e.reset() for e in envs]
        free = R
        slot = 0
        prev_done = np.ones(K, np.uint8)  # first plane is a reset frame

        def pump_one():
            """Process exactly one message; return it unless consumed."""
            nonlocal free
            msg = child_conn.recv()
            if msg[0] == "stop":
                raise SystemExit
            if msg[0] == "free":
                free += 1
                return None
            return msg

        def recv_until(kind, slot_wanted):
            while True:
                msg = pump_one()
                if msg and msg[0] == kind and msg[1] == slot_wanted:
                    return msg

        while True:
            # Occupy `slot` (guaranteed free), publish plane + reset flags.
            free -= 1
            planes = v["planes"][slot]
            for j, o in enumerate(obs):
                planes[j] = np.asarray(o, np.uint8).reshape(-1)
            v["prev_done"][slot] = prev_done
            child_conn.send(("req", slot))
            recv_until("act", slot)
            actions = v["act"][slot]
            rew, term, done = v["rew"][slot], v["term"][slot], v["done"][slot]
            nxt = []
            for j, e in enumerate(envs):
                o2, r, d, info = e.step(int(actions[j]))
                reset = bool(info.get("needs_reset", False))
                rew[j] = r
                term[j] = d
                done[j] = d or reset
                if d or reset:
                    o2 = e.reset()
                nxt.append(o2)
            prev_done = v["done"][slot].copy()
            obs = nxt
            child_conn.send(("trans", slot))
            slot = (slot + 1) % R
            while free == 0:
                pump_one()  # only free/stop can arrive here
    except (SystemExit, EOFError, KeyboardInterrupt, BrokenPipeError):
        pass
    finally:
        # Drop the views into the mapping first: numpy arrays over it hold
        # exported pointers, and ``close`` refuses while any is alive.
        v = planes = actions = rew = term = done = None  # noqa: F841
        for e in envs:
            try:
                e.close()
            except Exception:
                pass
        if shm is not None:
            try:
                shm.close()
            except Exception:
                pass
