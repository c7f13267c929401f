"""JAX (flax/optax) parameters, as numpy arrays, to the port's.

Layouts: conv kernels go from flax's HWIO to torch's OIHW, Dense kernels
and a noisy layer's ``w_mu``/``w_sigma`` from ``[in, out]`` to
``[out, in]``, biases (``b_mu``/``b_sigma``) are copied. The port's models
flatten in flax's (H, W, C) order (see ``models/atari_cnn.py``), so no rows
are permuted. A module names its flax scopes with ``flax_names()``:
submodule name -> ``"Scope_0/Sub_1"`` path, nested scopes included.

Takes nested dicts of numpy arrays (``jax.tree.map(np.asarray, tree)`` on
the JAX side); imports nothing of JAX.
"""

import copy
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch.agents.dqn import DQNCore, DQNState


def _to_torch_layout(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:  # HWIO -> OIHW
        return np.transpose(kernel, (3, 2, 0, 1))
    if kernel.ndim == 2:  # [in, out] -> [out, in]
        return kernel.T
    raise ValueError(f"no layout rule for a kernel of shape {kernel.shape}")


def _strip(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _scope(tree: Mapping, path: str) -> Mapping:
    for part in path.split("/"):
        tree = tree[part]
    return tree


def torch_arrays(module: nn.Module, flax_tree: Mapping) -> Dict[str, np.ndarray]:
    """Parameter name -> array in the port's layout, for every parameter."""
    out = {}
    for sub, path in module.flax_names().items():
        node = _scope(_strip(flax_tree), path)
        if "w_mu" in node:  # a factorized noisy layer's four leaves
            for leaf in ("w_mu", "w_sigma"):
                out[f"{sub}.{leaf}"] = _to_torch_layout(np.asarray(node[leaf]))
            for leaf in ("b_mu", "b_sigma"):
                out[f"{sub}.{leaf}"] = np.asarray(node[leaf])
        else:
            out[f"{sub}.weight"] = _to_torch_layout(np.asarray(node["kernel"]))
            out[f"{sub}.bias"] = np.asarray(node["bias"])
    missing = set(dict(module.named_parameters())) - set(out)
    if missing:
        raise ValueError(f"no flax scope for parameters {sorted(missing)}")
    return out


def load_flax_params(module: nn.Module, flax_tree: Mapping) -> nn.Module:
    """Copy flax parameters into ``module``'s, in place."""
    arrays = torch_arrays(module, flax_tree)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(np.array(arrays[name])))
    return module


def dqn_state_from_flax(
    core: DQNCore,
    params: Mapping,
    target_params: Mapping,
    nu: Mapping,
    device="cpu",
    mu: Optional[Mapping] = None,
    count=None,
) -> DQNState:
    """A whole JAX ``DQNState``, each part a numpy tree, into a port
    :class:`DQNState`: ``params``, ``target_params`` and the optimizer's
    state. For optax's rmsprop chain that is the second moments ``nu``
    (``opt_state[0].nu``); for ``optax.adam`` ``mu``, ``nu`` and ``count``
    (``opt_state[0]``'s fields)."""
    model = copy.deepcopy(core.model).to(device)
    load_flax_params(model, params)
    state = core.state_from_model(model)
    load_flax_params(state.target_model, target_params)
    moments = {"nu": nu} if mu is None else {"mu": mu, "nu": nu}
    names = [name for name, _ in model.named_parameters()]
    core.optimizer.load_state(
        state.opt_state,
        count=count,
        **{k: [torch_arrays(model, tree)[n] for n in names] for k, tree in moments.items()},
    )
    return state
