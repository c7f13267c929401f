"""Global seeding (counterpart of ``pfrl_tpu/utils/random_seed.py``;
reference parity: pfrl/utils/random_seed.py:7-24).

The reference seeds ``random``, ``numpy`` and torch's global generator.
The JAX package seeds the two host generators and returns a root PRNG key
that callers thread through the functional cores. The port seeds the same
two and returns its root draw source instead: a :class:`Draws` over a
``torch.Generator`` seeded with ``seed`` on the requested device. Torch's
global generator is left alone, as JAX touches no global of the device:
the port draws only from explicit sources.
"""

import random

import numpy as np
import torch

from pfrl_tpu_torch._device import DeviceLike, resolve_device
from pfrl_tpu_torch.utils.draws import Draws


def set_random_seed(seed: int, device: DeviceLike = None) -> Draws:
    """Seed python's and numpy's generators (numpy with ``seed % 2**32``)
    and return a root draw source on ``device`` (default: the CUDA device;
    ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return Draws(torch.Generator(device=device).manual_seed(seed))
