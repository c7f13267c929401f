"""Agent interfaces (counterpart of ``pfrl_tpu/agent.py``; reference parity:
pfrl/agent.py:9-200).

The shells of :mod:`pfrl_tpu_torch.agents` speak the reference's object
protocol (``act``/``observe``/``batch_act``/``batch_observe``,
``save``/``load``, ``get_statistics``) over a core of the port: numpy in and
out, host step counters, and the update gating on the host.

:class:`AttributeSavingMixin` writes the port's own format: one
``torch.save`` file, ``<attr>.pt``, per saved attribute. A state is saved as
plain data (tensors, numbers, lists and dicts; a module, or any object with
``state_dict``/``load_state_dict`` such as a draw source, by its
``state_dict``) and loaded back into the live object in place, so no class
is pickled. A load checks every tensor's shape and dtype against the live
one and raises :class:`CheckpointMismatchError` where they differ. A
directory a JAX shell saved (``<attr>.msgpack``, no ``<attr>.pt``) loads
through the reader of :mod:`pfrl_tpu_torch.utils.flax_msgpack` and the
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


class CheckpointMismatchError(ValueError):
    """A saved value does not fit the live one it is loaded into."""


def _has_state_dict(value: Any) -> bool:
    return hasattr(value, "state_dict") and hasattr(value, "load_state_dict") and not isinstance(value, type)


def to_saved(value: Any) -> Any:
    """``value`` as plain data for ``torch.save(..., weights_only)``: a
    module (or any object with ``state_dict``/``load_state_dict``) becomes
    its ``state_dict``, a dataclass a dict of its fields."""
    if _has_state_dict(value):
        return {"state_dict": value.state_dict()}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: to_saved(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [to_saved(v) for v in value]
    if isinstance(value, dict):
        return {k: to_saved(v) for k, v in value.items()}
    return value


def _check_tensor(live: torch.Tensor, saved: Any, where: str) -> None:
    if not isinstance(saved, torch.Tensor):
        raise CheckpointMismatchError(f"{where}: saved a {type(saved).__name__} where the live value is a tensor")
    if saved.shape != live.shape or saved.dtype != live.dtype:
        raise CheckpointMismatchError(
            f"{where}: saved {saved.dtype}{list(saved.shape)} where the live tensor is "
            f"{live.dtype}{list(live.shape)}")


def _check_equal(live: Any, saved: Any, where: str) -> None:
    """Raises where plain data (from :func:`to_saved`) first differs."""
    if isinstance(live, dict) and isinstance(saved, dict) and set(live) == set(saved):
        for k in live:
            _check_equal(live[k], saved[k], f"{where}[{k!r}]")
    elif isinstance(live, list) and isinstance(saved, list) and len(live) == len(saved) and any(
            isinstance(x, (list, dict)) for x in live):
        for i, (a, b) in enumerate(zip(live, saved)):
            _check_equal(a, b, f"{where}[{i}]")
    elif live != saved:
        raise CheckpointMismatchError(f"{where}: saved {saved!r:.80} where the live value is {live!r:.80}")


def restore_saved(value: Any, saved: Any, where: str = "state") -> Any:
    """Loads ``saved`` (from :func:`to_saved`) into ``value``: modules and
    tensors in place, anything else replaced. Every tensor's shape and
    dtype must equal the live one's, every dict's keys and every list's
    length, and the fields a dataclass names in ``strict_fields`` (a
    ring's item shapes) the live values; :class:`CheckpointMismatchError`
    says where they do not. A live
    tensor whose storage another live tensor shares (an env's reset may
    hand out one zeros tensor for two fields) is replaced by a copy of its
    saved value instead, so that restoring one never overwrites the other.
    Returns the restored value."""
    return _restore(value, saved, where, set())


def _restore(value: Any, saved: Any, where: str, written: set) -> Any:
    if _has_state_dict(value):
        if not isinstance(saved, dict) or "state_dict" not in saved:
            raise CheckpointMismatchError(f"{where}: no state_dict saved")
        if isinstance(value, nn.Module):
            live = value.state_dict()
            if set(live) != set(saved["state_dict"]):
                raise CheckpointMismatchError(
                    f"{where}: saved entries {sorted(saved['state_dict'])} where the module has {sorted(live)}")
            for k, t in live.items():
                _check_tensor(t, saved["state_dict"][k], f"{where}.{k}")
        value.load_state_dict(saved["state_dict"])
        return value
    if isinstance(value, torch.Tensor):
        _check_tensor(value, saved, where)
        storage = value.untyped_storage().data_ptr()
        if storage in written and value.numel():
            return saved.to(device=value.device, copy=True)
        written.add(storage)
        with torch.no_grad():
            value.copy_(saved)
        return value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        if not isinstance(saved, dict) or set(saved) != {f.name for f in dataclasses.fields(value)}:
            raise CheckpointMismatchError(f"{where}: the saved fields are not {type(value).__name__}'s")
        for name in getattr(value, "strict_fields", ()):
            _check_equal(to_saved(getattr(value, name)), saved[name], f"{where}.{name}")
        for f in dataclasses.fields(value):
            setattr(value, f.name, _restore(getattr(value, f.name), saved[f.name], f"{where}.{f.name}", written))
        return value
    if isinstance(value, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(value) != len(saved):
            raise CheckpointMismatchError(f"{where}: saved {saved!r:.80} where the live value has {len(value)} items")
        return type(value)(_restore(v, s, f"{where}[{i}]", written) for i, (v, s) in enumerate(zip(value, saved)))
    if isinstance(value, dict):
        if not isinstance(saved, dict) or set(saved) != set(value):
            raise CheckpointMismatchError(f"{where}: saved {saved!r:.80} where the live value has keys {sorted(value)}")
        return {k: _restore(v, saved[k], f"{where}[{k!r}]", written) for k, v in value.items()}
    if isinstance(saved, (torch.Tensor, list, dict)) or (value is None) != (saved is None):
        raise CheckpointMismatchError(f"{where}: saved {saved!r:.80} where the live value is {value!r:.80}")
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
        """Loads ``<attr>.pt`` of each attribute or, where there is none, a
        JAX shell's ``<attr>.msgpack`` through :meth:`_from_flax`. A
        missing file raises ``FileNotFoundError``."""
        for attr in self.saved_attributes:
            value = getattr(self, attr)
            if _saves_itself(value):
                value.load(os.path.join(dirname, attr))
                continue
            path = os.path.join(dirname, f"{attr}.pt")
            flax_path = os.path.join(dirname, f"{attr}.msgpack")
            if not os.path.exists(path) and os.path.exists(flax_path):
                from pfrl_tpu_torch.utils import flax_msgpack

                saved = to_saved(self._from_flax(attr, flax_msgpack.load(flax_path)))
            else:
                saved = torch.load(path, map_location="cpu", weights_only=True)
            if value is None:
                if not hasattr(self, "_pending_restores"):
                    self._pending_restores = {}
                self._pending_restores[attr] = saved
            else:
                setattr(self, attr, restore_saved(value, saved, attr))

    def _from_flax(self, attr: str, tree) -> Any:
        """The port's value of ``attr`` from a JAX shell's checkpoint of it
        (a :class:`~pfrl_tpu_torch.utils.flax_msgpack.FlaxTree`): a
        ``train_state`` converts by the shell's core
        (:func:`pfrl_tpu_torch.convert.state_from_flax`), on the shell's
        device."""
        if attr != "train_state":
            raise NotImplementedError(f"no conversion of a JAX {attr!r}")
        from pfrl_tpu_torch import convert

        return convert.state_from_flax(self.core, tree, device=self.device)

    def _restore_pending(self) -> None:
        """Apply loads stashed before the attributes existed; the shells
        call it right after building their state."""
        pending = getattr(self, "_pending_restores", None)
        if not pending:
            return
        for attr in list(pending):
            value = getattr(self, attr)
            if value is not None:
                setattr(self, attr, restore_saved(value, pending.pop(attr), attr))
