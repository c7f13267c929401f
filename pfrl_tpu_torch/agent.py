"""Agent interfaces (counterpart of ``pfrl_tpu/agent.py``; reference parity:
pfrl/agent.py:9-200).

The shells of :mod:`pfrl_tpu_torch.agents` speak the reference's object
protocol (``act``/``observe``/``batch_act``/``batch_observe``,
``save``/``load``, ``get_statistics``) over a core of the port: numpy in and
out, host step counters, and the update gating on the host.

:class:`AttributeSavingMixin` writes the port's own format: one
``torch.save`` file, ``<attr>.pt``, per saved attribute. A state is saved as
plain data (tensors, numbers, lists and dicts; a module by its
``state_dict``) and loaded back into the live object in place, so no class
is pickled. A JAX checkpoint (msgpack) reaches the port only through the
converters of :mod:`pfrl_tpu_torch.convert`.

``AsyncAgent`` has no counterpart here, as in the JAX package.
"""

import contextlib
import dataclasses
import os
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn


class Agent:
    """Abstract agent (pfrl/agent.py:9-70)."""

    training = True

    def act(self, obs) -> Any:
        raise NotImplementedError

    def observe(self, obs, reward, done, reset) -> None:
        raise NotImplementedError

    def save(self, dirname: str) -> None:
        raise NotImplementedError

    def load(self, dirname: str) -> None:
        raise NotImplementedError

    def get_statistics(self) -> Sequence:
        return []

    @contextlib.contextmanager
    def eval_mode(self):
        orig = self.training
        self.training = False
        try:
            yield self
        finally:
            self.training = orig


class BatchAgent(Agent):
    """Agent that acts and observes over a batch of envs
    (pfrl/agent.py:157-200); ``act``/``observe`` are a batch of one."""

    def act(self, obs) -> Any:
        return self.batch_act(np.expand_dims(np.asarray(obs), 0))[0]

    def observe(self, obs, reward, done, reset) -> None:
        self.batch_observe(
            np.expand_dims(np.asarray(obs), 0),
            np.asarray([reward], dtype=np.float32),
            np.asarray([done]),
            np.asarray([reset]),
        )

    def batch_act(self, batch_obs) -> Any:
        raise NotImplementedError

    def batch_observe(self, batch_obs, batch_reward, batch_done, batch_reset) -> None:
        raise NotImplementedError


def to_saved(value: Any) -> Any:
    """``value`` as plain data for ``torch.save(..., weights_only)``: a
    module becomes its ``state_dict``, a dataclass a dict of its fields."""
    if isinstance(value, nn.Module):
        return {"state_dict": value.state_dict()}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: to_saved(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [to_saved(v) for v in value]
    if isinstance(value, dict):
        return {k: to_saved(v) for k, v in value.items()}
    return value


def restore_saved(value: Any, saved: Any) -> Any:
    """Loads ``saved`` (from :func:`to_saved`) into ``value``: modules and
    tensors in place, anything else replaced. Returns the restored value."""
    if isinstance(value, nn.Module):
        value.load_state_dict(saved["state_dict"])
        return value
    if isinstance(value, torch.Tensor):
        with torch.no_grad():
            value.copy_(saved)
        return value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            setattr(value, f.name, restore_saved(getattr(value, f.name), saved[f.name]))
        return value
    if isinstance(value, (list, tuple)):
        if len(value) != len(saved):
            raise ValueError(f"saved {len(saved)} items where the live value has {len(value)}")
        return type(value)(restore_saved(v, s) for v, s in zip(value, saved))
    if isinstance(value, dict):
        return {k: restore_saved(v, saved[k]) for k, v in value.items()}
    return saved


def _saves_itself(value: Any) -> bool:
    return hasattr(value, "save") and hasattr(value, "load") and not isinstance(value, (torch.Tensor, nn.Module))


class AttributeSavingMixin:
    """Save and load ``saved_attributes`` (pfrl/agent.py:73-137).

    An attribute with its own ``save``/``load`` (a nested agent) is recursed
    into under ``<dirname>/<attr>``. An attribute that is still ``None`` at
    ``load`` (a shell builds its state at the first act) is kept pending
    and applied by :meth:`_restore_pending` once the shell has built it, so
    construct -> load -> act works as in the reference.
    """

    saved_attributes: Sequence[str] = ()

    def save(self, dirname: str) -> None:
        os.makedirs(dirname, exist_ok=True)
        for attr in self.saved_attributes:
            value = getattr(self, attr)
            if _saves_itself(value):
                value.save(os.path.join(dirname, attr))
            else:
                torch.save(to_saved(value), os.path.join(dirname, f"{attr}.pt"))

    def load(self, dirname: str) -> None:
        for attr in self.saved_attributes:
            value = getattr(self, attr)
            if _saves_itself(value):
                value.load(os.path.join(dirname, attr))
                continue
            saved = torch.load(os.path.join(dirname, f"{attr}.pt"), map_location="cpu", weights_only=True)
            if value is None:
                if not hasattr(self, "_pending_restores"):
                    self._pending_restores = {}
                self._pending_restores[attr] = saved
            else:
                setattr(self, attr, restore_saved(value, saved))

    def _restore_pending(self) -> None:
        """Apply loads stashed before the attributes existed; the shells
        call it right after building their state."""
        pending = getattr(self, "_pending_restores", None)
        if not pending:
            return
        for attr in list(pending):
            value = getattr(self, attr)
            if value is not None:
                setattr(self, attr, restore_saved(value, pending.pop(attr)))
