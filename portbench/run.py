"""Runs one cell of the port's benchmark once; see ``portbench/main.py``.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

STARTED = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def prepare() -> None:
    """Every cache inside the checkout, at fixed paths; one thread of host
    math; no library loads JAX on the port's behalf. Before torch loads."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, in place of this folder
    prepare()
    import torch

    torch.set_num_threads(1)
    from portbench.main import main

    sys.exit(main(started=STARTED))
