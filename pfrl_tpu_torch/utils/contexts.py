"""Small context managers (counterpart of ``pfrl_tpu/utils/contexts.py``;
reference parity: pfrl/utils/contexts.py)."""

import contextlib


@contextlib.contextmanager
def set_temporarily(obj, attr, value):
    """Temporarily set ``obj.attr = value`` inside a ``with`` block.

    Used by eval-mode switches on host agent shells (the device cores take
    an explicit ``greedy`` flag instead). Reference: pfrl/utils/contexts.py.
    """
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


@contextlib.contextmanager
def evaluating(agent):
    """Temporarily switch a host agent shell to evaluation mode.

    Reference: pfrl/utils/contexts.py ``evaluating(net)`` flips a torch
    module's train/eval mode; here, as in the JAX package, the switch is
    the host shell's ``training`` flag, and no module's ``eval()`` is
    called (the device cores take an explicit ``greedy`` flag instead).
    """
    with set_temporarily(agent, "training", False):
        yield agent
