"""Host-side collections (counterpart of ``pfrl_tpu/collections_``;
reference parity: pfrl/collections/).

The hot-path equivalents live on the device (:mod:`pfrl_tpu_torch.replay`:
rings, sum trees). These host classes exist for API parity and for
disk-backed experience storage; they import neither torch nor numpy.
"""

from pfrl_tpu_torch.collections_.persistent_collections import (
    PersistentRandomAccessQueue,
)
from pfrl_tpu_torch.collections_.random_access_queue import RandomAccessQueue

__all__ = ["PersistentRandomAccessQueue", "RandomAccessQueue"]
