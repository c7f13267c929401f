"""A3C (counterpart of ``pfrl_tpu/agents/a3c.py``; reference parity:
pfrl/agents/a3c.py).

The JAX package maps the reference's asynchronous workers to the
synchronous batched A2C, one env lane per worker: the same n-step
actor-critic loss and ``t_max``, without the racy shared-memory gradient
pushes. ``A3CCore`` and ``A3C`` are the port's ``A2CCore`` and ``A2C``
under the reference's names, as they are in JAX.
"""

from pfrl_tpu_torch.agents.a2c import A2C, A2CCore


class A3CCore(A2CCore):
    pass


class A3C(A2C):
    """The synchronous stand-in for the reference's A3C: ``A2C``'s
    constructor, with ``num_processes`` as the reference's worker count."""
