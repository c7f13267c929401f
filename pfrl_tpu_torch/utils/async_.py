"""Process-pool helper (counterpart of ``pfrl_tpu/utils/async_.py``;
reference parity: pfrl/utils/async_.py:12-44).

For host-side tooling that needs processes. Workers are started by
**spawn**, never fork: a forked child of a process that has touched CUDA
cannot use it, and a spawned one starts clean. ``run_func`` must therefore
pickle (a module-level function or a ``functools.partial`` of one), and a
script that calls :func:`run_async` needs an ``if __name__ == "__main__"``
guard, because spawn re-imports it in every worker. A worker must not touch
CUDA (ROADMAP C52); training in this package never runs here: the
actor-learner mode's actors are threads (``experiments/train_agent_async.py``).
Host code only: it imports no torch.
"""

import multiprocessing as mp
import warnings
from typing import Callable, Sequence


class AbnormalExitWarning(Warning):
    """A worker exited abnormally (reference :8-11)."""


def run_async(n_process: int, run_func: Callable[[int], None]) -> None:
    """Spawn ``n_process`` workers running ``run_func(process_idx)`` and
    wait for them all; warn of each that exits with a nonzero code."""
    ctx = mp.get_context("spawn")
    processes: Sequence[mp.Process] = [ctx.Process(target=run_func, args=(i,)) for i in range(n_process)]
    for p in processes:
        p.start()
    for p in processes:
        p.join()
        if p.exitcode and p.exitcode != 0:
            warnings.warn(f"Process #{p.pid} exited with code {p.exitcode}", AbnormalExitWarning)
