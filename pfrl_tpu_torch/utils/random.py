"""Sampling helpers (counterpart of ``pfrl_tpu/utils/random.py``; reference
parity: pfrl/utils/random.py:4-27).

The reference samples ``k`` of ``n`` without replacement by a partial
Fisher-Yates on the host. The JAX package takes the top ``k`` of ``n``
uniform draws (Gumbel-top-k); so does the port, on a draw source
(:mod:`pfrl_tpu_torch.utils.draws`) in place of a PRNG key, so that the
same draws give the same indices in both. ``lax.top_k`` breaks ties toward
the lower index and ``torch.topk`` promises no order among ties; the
uniforms of a real source are untied but for a collision of float32 values.
"""

import torch


def sample_n_k(draws, n: int, k: int) -> torch.Tensor:
    """``k`` distinct indices of ``range(n)``, uniformly: the indices of the
    ``k`` largest of ``n`` uniform draws (one ``draws.uniform(n)``), int32,
    largest first."""
    if k > n:
        raise ValueError(f"cannot sample {k} distinct items from {n}")
    z = draws.uniform(n)
    _, idx = torch.topk(z, k)
    return idx.to(torch.int32)


def sample_with_replacement(draws, n: int, k: int) -> torch.Tensor:
    """``k`` indices of ``range(n)``, iid uniform (``draws.randint(n, k)``)."""
    return draws.randint(n, k)
