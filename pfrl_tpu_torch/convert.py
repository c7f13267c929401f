"""JAX (flax/optax) train states to the port's, and the port's back.

Layouts: conv kernels go from flax's HWIO to torch's OIHW, Dense kernels
and a noisy layer's ``w_mu``/``w_sigma`` from ``[in, out]`` to
``[out, in]``, biases (``b_mu``/``b_sigma``) are copied. The port's models
flatten in flax's (H, W, C) order (see ``models/atari_cnn.py``), so no rows
are permuted. A module names its flax scopes with ``flax_names()``:
submodule name -> ``"Scope_0/Sub_1"`` path, nested scopes included
(``MLP_0/Dense_1`` under a compact wrapper); a parameter that is neither
``kernel`` nor ``bias`` (a head's ``log_std``) maps from its own name to
its leaf and is copied as it is. A list of paths is one fused layer: the
Dense kernels are concatenated along their output axis, and the biases if
every scope has one, as flax's ``OptimizedLSTMCell`` concatenates its
gates' kernels before its one matmul. A Dense without a bias
(``use_bias=False``) maps to a layer without one. A
:class:`~pfrl_tpu_torch.models.batch_norm.BatchNorm` scope holds ``scale``
and ``bias`` in ``params`` and its running ``mean`` and ``var`` in the
``batch_stats`` collection, which map to the module's buffers.

From JAX: the ``*_state_from_flax`` functions take a whole train state
whose leaves are numpy arrays, as ``jax.tree.map(np.asarray, state)``
gives it, or a checkpoint read by the port's own reader
(:func:`pfrl_tpu_torch.utils.flax_msgpack.load`, whose view offers the
same fields and indices); its fields are read by name. An optimizer state
converts by the port optimizer's kind: optax's Adam (``mu``, ``nu``,
``count``), RMSprop (``nu``), the ``(clip_by_global_norm, inner)`` chain's
inner state, or ``rmsprop_eps_inside_sqrt``'s (``square_avg``,
``momentum_buf``, ``grad_avg``). Like every entry point of the port, they
build on the CUDA device unless given ``device="cpu"``
(:func:`~pfrl_tpu_torch._device.resolve_device`). :func:`state_from_flax`
picks the converter by the core's class, and :func:`load_flax_checkpoint`
reads a ``train_state.msgpack`` and converts it in one call.

To JAX: :func:`flax_arrays` runs the layouts in reverse (a fused layer is
split back into its gates' scopes along the output axis), and
:func:`state_to_flax` builds, by the same class dispatch, the state dict
that ``flax.serialization.to_state_dict`` gives of the JAX core's state:
its dataclass fields in order, each optimizer state in optax's layout
(Adam ``{"0": {count, mu, nu}, "1": {}}``, RMSprop ``{"0": {nu}, "1":
{}, "2": {}}``, the clip chain ``{"0": {}, "1": inner}``, an optax ``EmptyState``
and an unused tree as ``{}``), ``n_updates`` and Adam's ``count`` as 0-d
int32 arrays. :func:`save_flax_checkpoint` writes it with the port's own
msgpack writer, so that the JAX package's ``load_state`` (flax's
``from_bytes`` against its core's template) reads it. Imports nothing of
JAX.
"""

import copy
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch._device import resolve_device
from pfrl_tpu_torch.agents.acer import ACERContinuousCore, ACERCore, ACERState
from pfrl_tpu_torch.agents.ddpg import ActorCriticState, DDPGCore
from pfrl_tpu_torch.agents.dqn import DQNCore, DQNState
from pfrl_tpu_torch.agents.ppo import PPOCore, PPOState
from pfrl_tpu_torch.agents.reinforce import ReinforceCore, ReinforceState
from pfrl_tpu_torch.agents.soft_actor_critic import SACCore, SACState
from pfrl_tpu_torch.agents.td3 import TD3Core, TD3State
from pfrl_tpu_torch.agents.trpo import TRPOCore, TRPOState
from pfrl_tpu_torch.models.batch_norm import BatchNorm
from pfrl_tpu_torch.optimizers import Adam, ClipByGlobalNorm, RMSprop, RMSpropEpsInsideSqrt


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
        if isinstance(path, (list, tuple)):  # one fused layer of several Dense scopes
            nodes = [_scope(_strip(flax_tree), p) for p in path]
            kernel = np.concatenate([np.asarray(n["kernel"]) for n in nodes], axis=-1)
            out[f"{sub}.weight"] = _to_torch_layout(kernel)
            if all("bias" in n for n in nodes):
                out[f"{sub}.bias"] = np.concatenate([np.asarray(n["bias"]) for n in nodes])
            continue
        node = _scope(_strip(flax_tree), path)
        if not isinstance(node, Mapping):  # a bare parameter leaf (``log_std``)
            out[sub] = np.asarray(node)
        elif "scale" in node and "kernel" not in node:  # a BatchNorm's scale and bias
            for leaf in ("scale", "bias"):
                out[f"{sub}.{leaf}"] = np.asarray(node[leaf])
        elif "w_mu" in node:  # a factorized noisy layer's four leaves
            for leaf in ("w_mu", "w_sigma"):
                out[f"{sub}.{leaf}"] = _to_torch_layout(np.asarray(node[leaf]))
            for leaf in ("b_mu", "b_sigma"):
                out[f"{sub}.{leaf}"] = np.asarray(node[leaf])
        else:
            out[f"{sub}.weight"] = _to_torch_layout(np.asarray(node["kernel"]))
            if "bias" in node:  # flax's ``use_bias=False`` stores none
                out[f"{sub}.bias"] = np.asarray(node["bias"])
    missing = set(dict(module.named_parameters())) - set(out)
    if missing:
        raise ValueError(f"no flax scope for parameters {sorted(missing)}")
    return out


def _batch_norms(module: nn.Module):
    return [(name, m) for name, m in module.named_modules() if isinstance(m, BatchNorm)]


def torch_batch_stats(module: nn.Module, flax_tree: Mapping) -> Dict[str, np.ndarray]:
    """Buffer name -> array for every BatchNorm's running ``mean`` and
    ``var``, from the tree's ``batch_stats`` collection."""
    names = module.flax_names()
    return {
        f"{name}.{leaf}": np.asarray(_scope(flax_tree["batch_stats"], names[name])[leaf])
        for name, _ in _batch_norms(module) for leaf in ("mean", "var")
    }


def load_flax_params(module: nn.Module, flax_tree: Mapping) -> nn.Module:
    """Copy flax parameters into ``module``'s, in place, and a BatchNorm's
    running statistics from the tree's ``batch_stats`` (which a module with
    a BatchNorm requires)."""
    arrays = torch_arrays(module, flax_tree)
    if _batch_norms(module):
        if "batch_stats" not in flax_tree:
            raise ValueError(f"{type(module).__name__} has BatchNorms and the tree no batch_stats")
        arrays.update(torch_batch_stats(module, flax_tree))
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(np.array(arrays[name])))
        for name, b in module.named_buffers():
            if name in arrays:
                b.copy_(torch.from_numpy(np.array(arrays[name])))
    return module


def dqn_state_from_flax(
    core: DQNCore,
    params: Mapping,
    target_params: Mapping,
    opt_state,
    device=None,
    n_updates: int = 0,
) -> DQNState:
    """A JAX ``DQNState``, each part a numpy tree, into a port
    :class:`DQNState`: ``params``, ``target_params``, the whole optax state
    ``opt_state`` (read by the port optimizer's kind, see
    :func:`_load_optimizer`) and ``n_updates``."""
    model = copy.deepcopy(core.model).to(resolve_device(device))
    load_flax_params(model, params)
    state = core.state_from_model(model)
    load_flax_params(state.target_model, target_params)
    _load_optimizer(core.optimizer, state.opt_state, model, opt_state)
    state.n_updates = int(n_updates)
    return state


def dqn_shell_from_flax(shell, flax_state):
    """A JAX ``DQN`` shell's ``train_state`` (the tree its ``save`` writes,
    with numpy leaves: ``params``, ``target_params``, ``opt_state``,
    ``n_updates``) into the port's shell ``shell`` (``DQN``, ``DoubleDQN``
    or a shell of another value core: the categorical and IQN states are
    ``DQNState`` too), on the shell's device. Set before the first act, it is
    the state the shell acts and learns from. Returns ``shell``."""
    shell.train_state = dqn_state_from_flax(
        shell.core, flax_state.params, flax_state.target_params, flax_state.opt_state,
        device=shell.device, n_updates=int(np.asarray(flax_state.n_updates)),
    )
    return shell


def _load_network(template: nn.Module, flax_state, params_field: str, device) -> nn.Module:
    module = copy.deepcopy(template).to(device)
    return load_flax_params(module, getattr(flax_state, params_field))


def _load_adam(optimizer, opt_state, module: Optional[nn.Module], flax_opt_state) -> None:
    """``optax.adam``'s state (``opt_state[0]``: ``mu``, ``nu``, ``count``)
    into the port's, in the order of ``module``'s parameters; for a single
    0-d parameter (``module`` None) the moments are the leaves themselves."""
    adam = flax_opt_state[0]
    moments = {}
    for k in ("mu", "nu"):
        tree = getattr(adam, k)
        if module is None:
            moments[k] = [np.asarray(tree)]
        else:
            arrays = torch_arrays(module, tree)
            moments[k] = [arrays[name] for name, _ in module.named_parameters()]
    optimizer.load_state(opt_state, count=int(np.asarray(adam.count)), **moments)


def actor_critic_state_from_flax(core: DDPGCore, flax_state, device=None) -> ActorCriticState:
    """A whole JAX ``ActorCriticState`` into the port's."""
    device = resolve_device(device)
    policy = _load_network(core.policy, flax_state, "policy_params", device)
    q_func = _load_network(core.q_func, flax_state, "q_params", device)
    state = core.state_from_modules(policy, q_func)
    load_flax_params(state.target_policy, flax_state.target_policy_params)
    load_flax_params(state.target_q_func, flax_state.target_q_params)
    _load_adam(core.policy_optimizer, state.policy_opt_state, policy, flax_state.policy_opt_state)
    _load_adam(core.q_optimizer, state.q_opt_state, q_func, flax_state.q_opt_state)
    state.n_updates = int(np.asarray(flax_state.n_updates))
    return state


def _load_twin(core, state, flax_state) -> None:
    """What TD3's and SAC's states share: the target critics, the three
    networks' Adam states and ``n_updates``."""
    load_flax_params(state.target_q_func1, flax_state.target_q1_params)
    load_flax_params(state.target_q_func2, flax_state.target_q2_params)
    for optimizer, opt_state, module, name in (
        (core.policy_optimizer, state.policy_opt_state, state.policy, "policy_opt_state"),
        (core.q_func1_optimizer, state.q1_opt_state, state.q_func1, "q1_opt_state"),
        (core.q_func2_optimizer, state.q2_opt_state, state.q_func2, "q2_opt_state"),
    ):
        _load_adam(optimizer, opt_state, module, getattr(flax_state, name))
    state.n_updates = int(np.asarray(flax_state.n_updates))


def td3_state_from_flax(core: TD3Core, flax_state, device=None) -> TD3State:
    """A whole JAX ``TD3State`` into the port's."""
    device = resolve_device(device)
    state = core.state_from_modules(
        _load_network(core.policy, flax_state, "policy_params", device),
        _load_network(core.q_func1, flax_state, "q1_params", device),
        _load_network(core.q_func2, flax_state, "q2_params", device),
    )
    load_flax_params(state.target_policy, flax_state.target_policy_params)
    _load_twin(core, state, flax_state)
    return state


def sac_state_from_flax(core: SACCore, flax_state, device=None) -> SACState:
    """A whole JAX ``SACState`` into the port's, ``log_temperature`` and
    its 0-d Adam state included."""
    device = resolve_device(device)
    state = core.state_from_modules(
        _load_network(core.policy, flax_state, "policy_params", device),
        _load_network(core.q_func1, flax_state, "q1_params", device),
        _load_network(core.q_func2, flax_state, "q2_params", device),
    )
    _load_twin(core, state, flax_state)
    with torch.no_grad():
        state.log_temperature.copy_(
            torch.from_numpy(np.array(flax_state.log_temperature, np.float32))
        )
    _load_adam(
        core.temperature_optimizer, state.temperature_opt_state, None,
        flax_state.temperature_opt_state,
    )
    return state


def _load_optimizer(optimizer, opt_state, module: nn.Module, flax_opt_state) -> None:
    """An optax state into the port's optimizer state, by the port
    optimizer's kind: ``optax.adam``'s, ``optax.rmsprop``'s (``nu`` of its
    first element), ``rmsprop_eps_inside_sqrt``'s or, for a
    :class:`ClipByGlobalNorm`, the chain ``(EmptyState(), inner)``'s inner
    state (Adam's moments then sit at ``opt_state[1][0]``)."""
    if isinstance(optimizer, ClipByGlobalNorm):
        _load_optimizer(optimizer.inner, opt_state, module, flax_opt_state[1])
    elif isinstance(optimizer, Adam):
        _load_adam(optimizer, opt_state, module, flax_opt_state)
    elif isinstance(optimizer, RMSprop):
        arrays = torch_arrays(module, flax_opt_state[0].nu)
        optimizer.load_state(opt_state, [arrays[name] for name, _ in module.named_parameters()])
    elif isinstance(optimizer, RMSpropEpsInsideSqrt):
        trees = {}
        for k in ("square_avg", "momentum_buf", "grad_avg"):
            tree = getattr(flax_opt_state, k)
            if len(tree) == 0:  # unused: () in JAX, {} in a checkpoint
                trees[k] = ()
            else:
                arrays = torch_arrays(module, tree)
                trees[k] = [arrays[name] for name, _ in module.named_parameters()]
        optimizer.load_state(opt_state, **trees)
    else:
        raise NotImplementedError(f"no conversion for {type(optimizer).__name__}")


def ppo_state_from_flax(core: PPOCore, flax_state, device=None) -> PPOState:
    """A whole JAX ``PPOState`` (A2C's too) into the port's: the model, the
    optimizer's state (Adam, or the ``(clip_by_global_norm, rmsprop)``
    chain's) and ``n_updates``."""
    device = resolve_device(device)
    model = _load_network(core.model, flax_state, "params", device)
    state = core.state_from_model(model)
    _load_optimizer(core.optimizer, state.opt_state, model, flax_state.opt_state)
    state.n_updates = int(np.asarray(flax_state.n_updates))
    return state


def reinforce_state_from_flax(core: ReinforceCore, flax_state, device=None) -> ReinforceState:
    """A whole JAX ``ReinforceState`` (a ``REINFORCE`` shell's
    ``train_state``) into the port's: the policy, its optimizer's state and
    ``n_updates``."""
    device = resolve_device(device)
    model = _load_network(core.model, flax_state, "params", device)
    state = core.state_from_model(model)
    _load_optimizer(core.optimizer, state.opt_state, model, flax_state.opt_state)
    state.n_updates = int(np.asarray(flax_state.n_updates))
    return state


def trpo_state_from_flax(core: TRPOCore, flax_state, device=None) -> TRPOState:
    """A whole JAX ``TRPOState`` into the port's: the policy, the value
    function, its Adam state and ``n_updates``."""
    device = resolve_device(device)
    state = core.state_from_modules(
        _load_network(core.policy, flax_state, "policy_params", device),
        _load_network(core.vf, flax_state, "vf_params", device),
    )
    _load_optimizer(core.vf_optimizer, state.vf_opt_state, state.vf, flax_state.vf_opt_state)
    state.n_updates = int(np.asarray(flax_state.n_updates))
    return state


def actor_critic_shell_from_flax(shell, flax_state):
    """A JAX actor-critic shell's ``train_state`` (DDPG's, TD3's or SAC's,
    numpy leaves) into the port's shell ``shell`` of the same algorithm, on
    the shell's device, optimizer moments included. Set before the first
    act, it is the state the shell acts and learns from. Returns ``shell``."""
    if not isinstance(shell.core, (DDPGCore, TD3Core, SACCore)):
        raise TypeError(f"no actor-critic state for {type(shell.core).__name__}")
    shell.train_state = state_from_flax(shell.core, flax_state, device=shell.device)
    return shell


def onpolicy_shell_from_flax(shell, flax_state):
    """A JAX on-policy shell's ``train_state`` (PPO's and A2C's
    ``PPOState``, or TRPO's) into the port's shell ``shell``, as
    :func:`actor_critic_shell_from_flax` does. Returns ``shell``."""
    if not isinstance(shell.core, (PPOCore, TRPOCore)):
        raise TypeError(f"no on-policy state for {type(shell.core).__name__}")
    shell.train_state = state_from_flax(shell.core, flax_state, device=shell.device)
    return shell


def acer_state_from_flax(core, flax_state, device=None) -> ACERState:
    """A whole JAX ``ACERState`` (or ``ACERContinuousState``) into the
    port's: the model (``params``), the average model (``avg_params``), the
    optimizer's state (Adam's or RMSprop's moments) and ``n_updates``."""
    device = resolve_device(device)
    model = _load_network(core.model, flax_state, "params", device)
    state = core.state_from_model(model)
    load_flax_params(state.avg_model, flax_state.avg_params)
    _load_optimizer(core.optimizer, state.opt_state, model, flax_state.opt_state)
    state.n_updates = int(np.asarray(flax_state.n_updates))
    return state


def state_from_flax(core, flax_state, device=None):
    """A whole JAX train state of ``core``'s algorithm, by the core's class:
    the value family (every ``DQNCore``: DQN, Double DQN, C51, AL, PAL, DPP,
    IQN, the recurrent DRQN and IQN) through :func:`dqn_state_from_flax`;
    DDPG, TD3 and SAC; PPO, A2C, A3C and recurrent PPO (``PPOCore``); TRPO
    and recurrent TRPO; REINFORCE; ACER, discrete and continuous."""
    if isinstance(core, DQNCore):
        return dqn_state_from_flax(
            core, flax_state.params, flax_state.target_params, flax_state.opt_state, device=device,
            n_updates=int(np.asarray(flax_state.n_updates)),
        )
    for cls, convert in (
        (SACCore, sac_state_from_flax),
        (TD3Core, td3_state_from_flax),
        (DDPGCore, actor_critic_state_from_flax),
        (TRPOCore, trpo_state_from_flax),
        (PPOCore, ppo_state_from_flax),
        (ReinforceCore, reinforce_state_from_flax),
        (ACERCore, acer_state_from_flax),
        (ACERContinuousCore, acer_state_from_flax),
    ):
        if isinstance(core, cls):
            return convert(core, flax_state, device=device)
    raise TypeError(f"no converter for a JAX state of {type(core).__name__}")


def load_flax_checkpoint(core, path: str, device=None):
    """The JAX checkpoint at ``path`` (flax msgpack, read without JAX),
    converted for ``core`` by :func:`state_from_flax`."""
    from pfrl_tpu_torch.utils import flax_msgpack

    return state_from_flax(core, flax_msgpack.load(path), device=device)


# ------------------------------------------------------------ port -> JAX
def _array(t: torch.Tensor):
    """A tensor as the writer takes it: a numpy array, or a CPU
    ``torch.bfloat16`` tensor (numpy has no bfloat16)."""
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _to_flax_layout(weight: torch.Tensor) -> torch.Tensor:
    if weight.dim() == 4:  # OIHW -> HWIO
        return weight.permute(2, 3, 1, 0)
    if weight.dim() == 2:  # [out, in] -> [in, out]
        return weight.t()
    raise ValueError(f"no layout rule for a weight of shape {tuple(weight.shape)}")


def _put(tree: dict, path: str, leaf: str, value) -> None:
    for part in path.split("/"):
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def _sorted(tree):
    """Every map's keys in sorted order, as ``jax.device_get`` (a tree map)
    hands flax a params tree."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _flax_params(module: nn.Module, values: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """:func:`torch_arrays` in reverse: the flax ``params`` tree (without
    the ``"params"`` key) of ``module``'s parameters or of ``values``."""
    tensors = dict(module.named_parameters()) if values is None else dict(values)
    tree, used = {}, set()
    for sub, path in module.flax_names().items():
        if isinstance(path, (list, tuple)):  # one fused layer, split into its scopes
            parts = _to_flax_layout(tensors[f"{sub}.weight"]).chunk(len(path), dim=-1)
            biases = tensors[f"{sub}.bias"].chunk(len(path)) if f"{sub}.bias" in tensors else None
            for i, p in enumerate(path):
                _put(tree, p, "kernel", _array(parts[i]))
                if biases is not None:
                    _put(tree, p, "bias", _array(biases[i]))
            used.update({f"{sub}.weight", f"{sub}.bias"})
        elif sub in tensors:  # a bare parameter leaf (``log_std``)
            scope, _, leaf = path.rpartition("/")
            if scope:
                _put(tree, scope, leaf, _array(tensors[sub]))
            else:
                tree[leaf] = _array(tensors[sub])
            used.add(sub)
        elif f"{sub}.w_mu" in tensors:  # a factorized noisy layer's four leaves
            for leaf in ("w_mu", "w_sigma"):
                _put(tree, path, leaf, _array(_to_flax_layout(tensors[f"{sub}.{leaf}"])))
            for leaf in ("b_mu", "b_sigma"):
                _put(tree, path, leaf, _array(tensors[f"{sub}.{leaf}"]))
            used.update(f"{sub}.{leaf}" for leaf in ("w_mu", "w_sigma", "b_mu", "b_sigma"))
        elif f"{sub}.scale" in tensors:  # a BatchNorm's scale and bias
            for leaf in ("scale", "bias"):
                _put(tree, path, leaf, _array(tensors[f"{sub}.{leaf}"]))
            used.update({f"{sub}.scale", f"{sub}.bias"})
        else:
            _put(tree, path, "kernel", _array(_to_flax_layout(tensors[f"{sub}.weight"])))
            if f"{sub}.bias" in tensors:  # flax's ``use_bias=False`` stores none
                _put(tree, path, "bias", _array(tensors[f"{sub}.bias"]))
            used.update({f"{sub}.weight", f"{sub}.bias"})
    missing = set(tensors) - used
    if missing:
        raise ValueError(f"no flax scope for parameters {sorted(missing)}")
    return _sorted(tree)


def _flax_batch_stats(module: nn.Module) -> dict:
    names = module.flax_names()
    tree = {}
    for name, bn in _batch_norms(module):
        for leaf in ("mean", "var"):
            _put(tree, names[name], leaf, _array(getattr(bn, leaf)))
    return _sorted(tree)


def flax_arrays(module: nn.Module, values: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """``module``'s flax variables, ``{"params": ...}`` and, where it has
    BatchNorms, ``"batch_stats"``; with ``values`` (parameter name ->
    tensor of its shape: an optimizer's moments, gradients) the
    ``{"params": ...}`` tree of those."""
    out = {"params": _flax_params(module, values)}
    if values is None and _batch_norms(module):
        out["batch_stats"] = _flax_batch_stats(module)
    return _sorted(out)


def _int32(n) -> np.ndarray:
    return np.asarray(int(n), np.int32)


def optimizer_to_flax(optimizer, opt_state, module: Optional[nn.Module]) -> dict:
    """The port optimizer's state in optax's layout for ``module``'s
    parameters (``module`` None: one 0-d parameter, SAC's temperature, whose
    moments are the leaves themselves): :func:`_load_optimizer` in
    reverse."""
    names = [name for name, _ in module.named_parameters()] if module is not None else None

    def tree(tensors):
        if module is None:
            (t,) = tensors
            return _array(t)
        return flax_arrays(module, dict(zip(names, tensors)))

    if isinstance(optimizer, ClipByGlobalNorm):
        return {"0": {}, "1": optimizer_to_flax(optimizer.inner, opt_state, module)}
    if isinstance(optimizer, Adam):
        return {"0": {"count": _int32(opt_state.count), "mu": tree(opt_state.mu), "nu": tree(opt_state.nu)}, "1": {}}
    if isinstance(optimizer, RMSprop):
        # optax.rmsprop chains scale_by_rms, the learning rate and, with no
        # momentum, an identity: three states, the last two empty.
        return {"0": {"nu": tree(opt_state)}, "1": {}, "2": {}}
    if isinstance(optimizer, RMSpropEpsInsideSqrt):
        return {k: tree(getattr(opt_state, k)) if len(getattr(opt_state, k)) else {}
                for k in ("square_avg", "momentum_buf", "grad_avg")}
    raise NotImplementedError(f"no conversion for {type(optimizer).__name__}")


def _twin_to_flax(core, state) -> dict:
    return {
        "policy_opt_state": optimizer_to_flax(core.policy_optimizer, state.policy_opt_state, state.policy),
        "q1_opt_state": optimizer_to_flax(core.q_func1_optimizer, state.q1_opt_state, state.q_func1),
        "q2_opt_state": optimizer_to_flax(core.q_func2_optimizer, state.q2_opt_state, state.q_func2),
    }


def state_to_flax(core, state) -> dict:
    """The port's train ``state`` of ``core`` as the state dict flax makes
    of the JAX core's state (``flax.serialization.to_state_dict``), numpy
    leaves, by the class dispatch of :func:`state_from_flax`."""
    n_updates = _int32(state.n_updates)
    if isinstance(core, DQNCore):
        return {
            "params": flax_arrays(state.model),
            "target_params": flax_arrays(state.target_model),
            "opt_state": optimizer_to_flax(core.optimizer, state.opt_state, state.model),
            "n_updates": n_updates,
        }
    if isinstance(core, SACCore):
        twin = _twin_to_flax(core, state)
        return {
            "policy_params": flax_arrays(state.policy),
            "q1_params": flax_arrays(state.q_func1),
            "q2_params": flax_arrays(state.q_func2),
            "target_q1_params": flax_arrays(state.target_q_func1),
            "target_q2_params": flax_arrays(state.target_q_func2),
            **twin,
            "log_temperature": _array(state.log_temperature),
            "temperature_opt_state": optimizer_to_flax(
                core.temperature_optimizer, state.temperature_opt_state, None),
            "n_updates": n_updates,
        }
    if isinstance(core, TD3Core):
        return {
            "policy_params": flax_arrays(state.policy),
            "q1_params": flax_arrays(state.q_func1),
            "q2_params": flax_arrays(state.q_func2),
            "target_policy_params": flax_arrays(state.target_policy),
            "target_q1_params": flax_arrays(state.target_q_func1),
            "target_q2_params": flax_arrays(state.target_q_func2),
            **_twin_to_flax(core, state),
            "n_updates": n_updates,
        }
    if isinstance(core, DDPGCore):
        return {
            "policy_params": flax_arrays(state.policy),
            "q_params": flax_arrays(state.q_func),
            "target_policy_params": flax_arrays(state.target_policy),
            "target_q_params": flax_arrays(state.target_q_func),
            "policy_opt_state": optimizer_to_flax(core.policy_optimizer, state.policy_opt_state, state.policy),
            "q_opt_state": optimizer_to_flax(core.q_optimizer, state.q_opt_state, state.q_func),
            "n_updates": n_updates,
            "extras": None,
        }
    if isinstance(core, TRPOCore):
        return {
            "policy_params": flax_arrays(state.policy),
            "vf_params": flax_arrays(state.vf),
            "vf_opt_state": optimizer_to_flax(core.vf_optimizer, state.vf_opt_state, state.vf),
            "n_updates": n_updates,
        }
    if isinstance(core, (PPOCore, ReinforceCore)):
        return {
            "params": flax_arrays(state.model),
            "opt_state": optimizer_to_flax(core.optimizer, state.opt_state, state.model),
            "n_updates": n_updates,
        }
    if isinstance(core, (ACERCore, ACERContinuousCore)):
        return {
            "params": flax_arrays(state.model),
            "avg_params": flax_arrays(state.avg_model),
            "opt_state": optimizer_to_flax(core.optimizer, state.opt_state, state.model),
            "n_updates": n_updates,
        }
    raise TypeError(f"no JAX state for {type(core).__name__}")


def save_flax_checkpoint(core, state, path: str) -> str:
    """Write the port's train ``state`` of ``core`` to ``path`` as the JAX
    package's ``train_state.msgpack`` (:func:`state_to_flax`, then the
    port's msgpack writer; atomic). Returns ``path``."""
    from pfrl_tpu_torch.utils import flax_msgpack

    flax_msgpack.write(path, state_to_flax(core, state))
    return path
