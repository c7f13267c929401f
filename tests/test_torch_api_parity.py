"""The port's public surface against the JAX package's, read with ``ast``.

For every module of ``pfrl_tpu/``: (a) each public top-level class and
function has a counterpart of the same name in ``pfrl_tpu_torch/``, in the
module at the same relative path or, failing that, anywhere in the port;
(b) each argument of a public function, and each constructor argument,
dataclass field, public method (with its arguments) and property of a
public class, exists on the counterpart, looked up through the
counterpart's base classes within the port. Whatever fails (a) or (b)
stands in :data:`DIFFERENCES` with one of the reasons of :data:`REASONS`;
an entry that no longer names something of ``pfrl_tpu/``, or that the port
now has, fails the test. Neither package is imported, so the test runs
where JAX is absent.
"""

import ast
import functools
import os
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "pfrl_tpu")
PORT_ROOT = os.path.join(REPO, "pfrl_tpu_torch")

# The reasons a JAX name or argument may lack a counterpart of its own:
# the parameters live in the port's nn.Modules (a state holds modules, a
# method takes the module); JAX-only (jit, Pallas, use_pallas, mesh axes,
# device lists, XLA's storage layout, and the PRNG key a pure function
# takes where the port draws nothing: the port's draw source is an object
# passed only where something is drawn); renamed (the counterpart says
# to what); no quiet fallback (the port's runtime raises
# FrameOpsBuildError where the JAX package would fall back to numpy);
# unused in the reference (read nowhere in pfrl_tpu/).
PARAMS = "the parameters live in the module"
JAX_ONLY = "JAX-only"
RENAMED = "renamed"
NO_FALLBACK = "no quiet fallback"
UNUSED = "unused in the reference"
REASONS = (PARAMS, JAX_ONLY, RENAMED, NO_FALLBACK, UNUSED)


# ------------------------------------------------------------------ the scan
class Api(NamedTuple):
    """One top-level class or function of a module."""

    path: str  # relative to the package's root, "/"-separated
    name: str
    node: ast.AST


def _module_files(root: str) -> List[str]:
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if not x.startswith(("_", ".")))
        out += [os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


@functools.lru_cache(maxsize=None)
def _parse(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), path)


def _top_level(tree: ast.Module) -> List[ast.AST]:
    """Class and function definitions of a module's body, also inside its
    top-level ``if`` and ``try`` blocks."""
    out, todo = [], list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node)
        elif isinstance(node, ast.If):
            todo += node.body + node.orelse
        elif isinstance(node, ast.Try):
            todo += node.body + [s for h in node.handlers for s in h.body] + node.orelse + node.finalbody
    return out


def public(name: str) -> bool:
    return not name.startswith("_")


def _args(fn: ast.AST) -> Tuple[str, ...]:
    """A function's argument names, ``*`` and ``**`` for the variadic ones;
    ``self`` and ``cls`` left out."""
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*"] * (a.vararg is not None) + ["**"] * (a.kwarg is not None)
    return tuple(n for n in names if n not in ("self", "cls"))


def _decorators(fn: ast.AST) -> List[str]:
    out = []
    for d in fn.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        out.append(d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", ""))
    return out


def _base_names(cls: ast.ClassDef) -> List[str]:
    out = []
    for b in cls.bases:
        b = b.value if isinstance(b, ast.Subscript) else b
        out.append(b.attr if isinstance(b, ast.Attribute) else getattr(b, "id", ""))
    return out


class Members(NamedTuple):
    """What a class offers: constructor arguments (``None``: none of its
    own), fields, methods with their arguments, and other attributes."""

    init: Optional[Tuple[str, ...]]
    fields: Tuple[str, ...]
    methods: Dict[str, Tuple[str, ...]]
    attributes: frozenset


def _class_members(cls: ast.ClassDef) -> Members:
    init, fields, methods, attributes = None, [], {}, set()
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            fields.append(node.target.id)
        elif isinstance(node, ast.Assign):
            attributes |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == "__init__":
                init = _args(node)
            if {"property", "cached_property"} & set(_decorators(node)) or "setter" in _decorators(node):
                attributes.add(node.name)
            else:
                methods[node.name] = _args(node)
            for sub in ast.walk(node):  # self.x = ... anywhere in a method
                targets = sub.targets if isinstance(sub, ast.Assign) else (
                    [sub.target] if isinstance(sub, (ast.AnnAssign, ast.AugAssign)) else [])
                for t in targets:
                    if isinstance(t, ast.Attribute) and getattr(t.value, "id", None) == "self":
                        attributes.add(t.attr)
    return Members(init, tuple(fields), methods, frozenset(attributes))


class Tree:
    """The top-level definitions of one package, by module and by name."""

    def __init__(self, root: str, drop: Tuple[Tuple[str, str], ...] = ()):
        self.root = root
        self.modules: Dict[str, Dict[str, Api]] = {}
        self.by_name: Dict[str, List[Api]] = {}
        for path in _module_files(root):
            defs = {}
            for node in _top_level(_parse(os.path.join(root, path))):
                if (path, node.name) not in drop and node.name not in defs:
                    defs[node.name] = Api(path, node.name, node)
            self.modules[path] = defs
            for api in defs.values():
                self.by_name.setdefault(api.name, []).append(api)

    def candidates(self, path: str, name: str) -> List[Api]:
        """The definitions named ``name``: the one at ``path`` first."""
        same = self.modules.get(path, {}).get(name)
        return [same] if same is not None else list(self.by_name.get(name, []))

    def members(self, api: Api, _seen=None) -> Members:
        """A class's members merged over its bases found in this tree (the
        first definition of a base's name; the same module's first)."""
        own = _class_members(api.node)
        seen = (_seen or set()) | {(api.path, api.name)}
        init, fields, methods, attributes = own.init, list(own.fields), dict(own.methods), set(own.attributes)
        for base in _base_names(api.node):
            found = [c for c in self.candidates(api.path, base)
                     if isinstance(c.node, ast.ClassDef) and (c.path, c.name) not in seen]
            if not found:
                continue
            inherited = self.members(found[0], seen)
            init = init if init is not None else inherited.init
            fields += [f for f in inherited.fields if f not in fields]
            methods = {**inherited.methods, **methods}
            attributes |= inherited.attributes
        return Members(init, tuple(fields), methods, frozenset(attributes))


def _call_args(tree: Tree, api: Api) -> Tuple[str, ...]:
    """What a call of ``api`` takes: a function's arguments, a class's
    constructor arguments (its ``__init__``'s, or its fields)."""
    if isinstance(api.node, ast.ClassDef):
        m = tree.members(api)
        return m.init if m.init is not None else m.fields
    return _args(api.node)


def _requirements(jax_tree: Tree, api: Api) -> List[Tuple[str, str]]:
    """``(kind, item)`` pairs the counterpart must have: ``("arg", a)`` for
    the call's arguments, ``("method", m)``, ``("method_arg", "m.a")`` and
    ``("attribute", p)`` for a class's public methods and properties."""
    if not isinstance(api.node, ast.ClassDef):
        return [("arg", a) for a in _args(api.node)]
    own = _class_members(api.node)
    out = [("arg", a) for a in (own.init or ()) + own.fields if public(a) and a not in ("*", "**")]
    for name, args in own.methods.items():
        if public(name):
            out += [("method", name)] + [("method_arg", f"{name}.{a}") for a in args]
    for node in api.node.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and public(node.name) \
                and node.name not in own.methods:
            out.append(("attribute", node.name))
    return out


def _missing(port: Tree, jax_tree: Tree, api: Api, cand: Api) -> List[Tuple[str, str]]:
    call = set(_call_args(port, cand))
    members = port.members(cand) if isinstance(cand.node, ast.ClassDef) else None
    out = []
    for kind, item in _requirements(jax_tree, api):
        if kind == "arg":
            ok = item in call
        elif kind == "method":
            ok = members is not None and (item in members.methods or item in members.attributes)
        elif kind == "method_arg":
            m, a = item.split(".")
            ok = members is not None and (m not in members.methods or a in members.methods[m]
                                          or "**" in members.methods[m] and a not in ("*", "**"))
        else:
            ok = members is not None and (item in members.attributes or item in members.methods
                                          or item in members.fields)
        if not ok:
            out.append((kind, item))
    return out


def _item(name: str, kind: str, item: str) -> str:
    """The table's spelling: ``Name``, ``Name(arg)``, ``Name.member`` or
    ``Name.method(arg)``."""
    if kind == "name":
        return name
    if kind == "arg":
        return f"{name}({item})"
    if kind == "method_arg":
        m, a = item.split(".")
        return f"{name}.{m}({a})"
    return f"{name}.{item}"


def audit(jax_tree: Tree, port: Tree, path: str) -> List[str]:
    """What the port lacks of the JAX module ``path``, in the table's
    spelling (:func:`_item`): a public definition with no counterpart, or
    what its counterpart lacks of :func:`_requirements`. Of several
    counterparts anywhere in the port, the one that lacks least."""
    out = []
    for name, api in jax_tree.modules[path].items():
        if not public(name):
            continue
        cands = port.candidates(path, name)
        if not cands:
            out.append(name)
            continue
        out += [_item(name, kind, item) for kind, item in
                min((_missing(port, jax_tree, api, c) for c in cands), key=len)]
    return out


@functools.lru_cache(maxsize=None)
def jax_tree() -> Tree:
    return Tree(JAX_ROOT)


@functools.lru_cache(maxsize=None)
def port_tree() -> Tree:
    return Tree(PORT_ROOT)


# --------------------------------------------------------------- the table
#: (JAX module, item, the port's counterpart or None, reason). An item is
#: spelled ``Name``, ``Name(arg)`` (an argument of a function or of a
#: class's constructor, or a field), ``Name.member`` or ``Name.method(arg)``;
#: a counterpart is spelled the same way and is looked up in the port.
DIFFERENCES = [
    # agents/a2c.py
    ("agents/a2c.py", "A2CCore.update(rng)", "A2CCore.update(draws)", RENAMED),
    # agents/acer.py
    ("agents/acer.py", "ACERState(params)", "ACERState(model)", PARAMS),
    ("agents/acer.py", "ACERState(avg_params)", "ACERState(avg_model)", PARAMS),
    ("agents/acer.py", "ACERCore.init(rng)", "ACERCore.init(generator)", RENAMED),
    ("agents/acer.py", "ACERCore.forward(params)", "ACERCore.forward(model)", PARAMS),
    ("agents/acer.py", "ACERCore.select_action(rng)", "ACERCore.select_action(draws)", RENAMED),
    ("agents/acer.py", "ACERCore.select_action_with_extras(rng)", "ACERCore.select_action_with_extras(draws)", RENAMED),
    ("agents/acer.py", "ACERCore.update_episodic(rng)", "ACERCore.update_episodic(draws)", RENAMED),
    ("agents/acer.py", "ACERContinuousState", "ACERState", RENAMED),
    ("agents/acer.py", "ACERContinuousCore.init(rng)", "ACERContinuousCore.init(generator)", RENAMED),
    ("agents/acer.py", "ACERContinuousCore.select_action(rng)", "ACERContinuousCore.select_action(draws)", RENAMED),
    ("agents/acer.py", "ACERContinuousCore.select_action_with_extras(rng)", "ACERContinuousCore.select_action_with_extras(draws)", RENAMED),
    ("agents/acer.py", "ACERContinuousCore.update_episodic(rng)", "ACERContinuousCore.update_episodic(draws)", RENAMED),
    # agents/al.py
    ("agents/al.py", "ALCore.compute_y_and_t(params)", "ALCore.compute_y_and_t(model)", PARAMS),
    ("agents/al.py", "ALCore.compute_y_and_t(target_params)", "ALCore.compute_y_and_t(target_model)", PARAMS),
    ("agents/al.py", "ALCore.compute_y_and_t(rng)", "ALCore.compute_y_and_t(draws)", RENAMED),
    # agents/categorical_dqn.py
    ("agents/categorical_dqn.py", "CategoricalDQNCore.target_distribution(params)", "CategoricalDQNCore.target_distribution(model)", PARAMS),
    ("agents/categorical_dqn.py", "CategoricalDQNCore.target_distribution(target_params)", "CategoricalDQNCore.target_distribution(target_model)", PARAMS),
    ("agents/categorical_dqn.py", "CategoricalDQNCore.target_distribution(rng)", "CategoricalDQNCore.target_distribution(draws)", RENAMED),
    ("agents/categorical_dqn.py", "CategoricalDQNCore.compute_loss_components(params)", "CategoricalDQNCore.compute_loss_components(model)", PARAMS),
    ("agents/categorical_dqn.py", "CategoricalDQNCore.compute_loss_components(target_params)", "CategoricalDQNCore.compute_loss_components(target_model)", PARAMS),
    ("agents/categorical_dqn.py", "CategoricalDQNCore.compute_loss_components(rng)", "CategoricalDQNCore.compute_loss_components(draws)", RENAMED),
    ("agents/categorical_dqn.py", "CategoricalDQNCore.loss_and_errors(params)", "CategoricalDQNCore.loss_and_errors(model)", PARAMS),
    ("agents/categorical_dqn.py", "CategoricalDQNCore.loss_and_errors(target_params)", "CategoricalDQNCore.loss_and_errors(target_model)", PARAMS),
    ("agents/categorical_dqn.py", "CategoricalDQNCore.loss_and_errors(rng)", "CategoricalDQNCore.loss_and_errors(draws)", RENAMED),
    ("agents/categorical_dqn.py", "CategoricalDoubleDQNCore.target_distribution(params)", "CategoricalDoubleDQNCore.target_distribution(model)", PARAMS),
    ("agents/categorical_dqn.py", "CategoricalDoubleDQNCore.target_distribution(target_params)", "CategoricalDoubleDQNCore.target_distribution(target_model)", PARAMS),
    ("agents/categorical_dqn.py", "CategoricalDoubleDQNCore.target_distribution(rng)", "CategoricalDoubleDQNCore.target_distribution(draws)", RENAMED),
    # agents/ddpg.py
    ("agents/ddpg.py", "ActorCriticState(policy_params)", "ActorCriticState(policy)", PARAMS),
    ("agents/ddpg.py", "ActorCriticState(q_params)", "ActorCriticState(q_func)", PARAMS),
    ("agents/ddpg.py", "ActorCriticState(target_policy_params)", "ActorCriticState(target_policy)", PARAMS),
    ("agents/ddpg.py", "ActorCriticState(target_q_params)", "ActorCriticState(target_q_func)", PARAMS),
    ("agents/ddpg.py", "ActorCriticState(extras)", None, UNUSED),
    ("agents/ddpg.py", "DDPGCore.init(rng)", "DDPGCore.init(generator)", RENAMED),
    ("agents/ddpg.py", "DDPGCore.policy_dist(params)", "DDPGCore.policy_dist(policy)", PARAMS),
    ("agents/ddpg.py", "DDPGCore.select_action(rng)", "DDPGCore.select_action(draws)", RENAMED),
    ("agents/ddpg.py", "DDPGCore.target_next_q(rng)", None, JAX_ONLY),
    ("agents/ddpg.py", "DDPGCore.critic_loss(q_params)", "DDPGCore.critic_loss(state)", PARAMS),
    ("agents/ddpg.py", "DDPGCore.critic_loss(rng)", None, JAX_ONLY),
    ("agents/ddpg.py", "DDPGCore.actor_loss(policy_params)", "DDPGCore.actor_loss(state)", PARAMS),
    ("agents/ddpg.py", "DDPGCore.actor_loss(rng)", None, JAX_ONLY),
    ("agents/ddpg.py", "DDPGCore.update(rng)", "DDPGCore.update(draws)", RENAMED),
    # agents/double_dqn.py
    ("agents/double_dqn.py", "DoubleDQNCore.compute_y_and_t(params)", "DoubleDQNCore.compute_y_and_t(model)", PARAMS),
    ("agents/double_dqn.py", "DoubleDQNCore.compute_y_and_t(target_params)", "DoubleDQNCore.compute_y_and_t(target_model)", PARAMS),
    ("agents/double_dqn.py", "DoubleDQNCore.compute_y_and_t(rng)", "DoubleDQNCore.compute_y_and_t(draws)", RENAMED),
    # agents/dpp.py
    ("agents/dpp.py", "DPPCore.compute_y_and_t(params)", "DPPCore.compute_y_and_t(model)", PARAMS),
    ("agents/dpp.py", "DPPCore.compute_y_and_t(target_params)", "DPPCore.compute_y_and_t(target_model)", PARAMS),
    ("agents/dpp.py", "DPPCore.compute_y_and_t(rng)", "DPPCore.compute_y_and_t(draws)", RENAMED),
    # agents/dqn.py
    ("agents/dqn.py", "DQNState(params)", "DQNState(model)", PARAMS),
    ("agents/dqn.py", "DQNState(target_params)", "DQNState(target_model)", PARAMS),
    ("agents/dqn.py", "DQNCore.init(rng)", "DQNCore.init(generator)", RENAMED),
    ("agents/dqn.py", "DQNCore.action_value(params)", "DQNCore.action_value(model)", PARAMS),
    ("agents/dqn.py", "DQNCore.action_value(rng)", "DQNCore.action_value(draws)", RENAMED),
    ("agents/dqn.py", "DQNCore.select_action(rng)", "DQNCore.select_action(draws)", RENAMED),
    ("agents/dqn.py", "DQNCore.compute_y_and_t(params)", "DQNCore.compute_y_and_t(model)", PARAMS),
    ("agents/dqn.py", "DQNCore.compute_y_and_t(target_params)", "DQNCore.compute_y_and_t(target_model)", PARAMS),
    ("agents/dqn.py", "DQNCore.compute_y_and_t(rng)", "DQNCore.compute_y_and_t(draws)", RENAMED),
    ("agents/dqn.py", "DQNCore.loss_and_errors(params)", "DQNCore.loss_and_errors(model)", PARAMS),
    ("agents/dqn.py", "DQNCore.loss_and_errors(target_params)", "DQNCore.loss_and_errors(target_model)", PARAMS),
    ("agents/dqn.py", "DQNCore.loss_and_errors(rng)", "DQNCore.loss_and_errors(draws)", RENAMED),
    ("agents/dqn.py", "DQNCore.update(rng)", "DQNCore.update(draws)", RENAMED),
    # agents/iqn.py
    ("agents/iqn.py", "IQNCore.action_value(params)", "IQNCore.action_value(model)", PARAMS),
    ("agents/iqn.py", "IQNCore.action_value(rng)", "IQNCore.action_value(draws)", RENAMED),
    ("agents/iqn.py", "IQNCore.select_action(rng)", "IQNCore.select_action(draws)", RENAMED),
    ("agents/iqn.py", "IQNCore.loss_and_errors(params)", "IQNCore.loss_and_errors(model)", PARAMS),
    ("agents/iqn.py", "IQNCore.loss_and_errors(target_params)", "IQNCore.loss_and_errors(target_model)", PARAMS),
    ("agents/iqn.py", "IQNCore.loss_and_errors(rng)", "IQNCore.loss_and_errors(draws)", RENAMED),
    ("agents/iqn.py", "IQNCore.target_greedy_actions(params)", "IQNCore.target_greedy_actions(model)", PARAMS),
    ("agents/iqn.py", "IQNCore.target_greedy_actions(target_params)", None, PARAMS),
    ("agents/iqn.py", "IQNCore.target_greedy_actions(rng)", "IQNCore.target_greedy_actions(draws)", RENAMED),
    ("agents/iqn.py", "DoubleIQNCore.target_greedy_actions(params)", "DoubleIQNCore.target_greedy_actions(model)", PARAMS),
    ("agents/iqn.py", "DoubleIQNCore.target_greedy_actions(target_params)", None, PARAMS),
    ("agents/iqn.py", "DoubleIQNCore.target_greedy_actions(rng)", "DoubleIQNCore.target_greedy_actions(draws)", RENAMED),
    # agents/pal.py
    ("agents/pal.py", "PALCore.compute_y_and_t(params)", "PALCore.compute_y_and_t(model)", PARAMS),
    ("agents/pal.py", "PALCore.compute_y_and_t(target_params)", "PALCore.compute_y_and_t(target_model)", PARAMS),
    ("agents/pal.py", "PALCore.compute_y_and_t(rng)", "PALCore.compute_y_and_t(draws)", RENAMED),
    ("agents/pal.py", "DoublePALCore.compute_y_and_t(params)", "DoublePALCore.compute_y_and_t(model)", PARAMS),
    ("agents/pal.py", "DoublePALCore.compute_y_and_t(target_params)", "DoublePALCore.compute_y_and_t(target_model)", PARAMS),
    ("agents/pal.py", "DoublePALCore.compute_y_and_t(rng)", "DoublePALCore.compute_y_and_t(draws)", RENAMED),
    # agents/ppo.py
    ("agents/ppo.py", "PPOState(params)", "PPOState(model)", PARAMS),
    ("agents/ppo.py", "PPOCore.init(rng)", "PPOCore.init(generator)", RENAMED),
    ("agents/ppo.py", "PPOCore.forward(params)", "PPOCore.forward(model)", PARAMS),
    ("agents/ppo.py", "PPOCore.select_action(rng)", "PPOCore.select_action(draws)", RENAMED),
    ("agents/ppo.py", "PPOCore.act_with_aux(rng)", "PPOCore.act_with_aux(draws)", RENAMED),
    ("agents/ppo.py", "PPOCore.update(rng)", "PPOCore.update(draws)", RENAMED),
    # agents/recurrent_dqn.py
    ("agents/recurrent_dqn.py", "RecurrentDQNCore.init(rng)", "RecurrentDQNCore.init(generator)", RENAMED),
    ("agents/recurrent_dqn.py", "RecurrentDQNCore.select_action_recurrent(rng)", "RecurrentDQNCore.select_action_recurrent(draws)", RENAMED),
    ("agents/recurrent_dqn.py", "RecurrentDQNCore.update_episodic(rng)", "RecurrentDQNCore.update_episodic(draws)", RENAMED),
    # agents/recurrent_iqn.py
    ("agents/recurrent_iqn.py", "RecurrentIQNCore.init(rng)", "RecurrentIQNCore.init(generator)", RENAMED),
    ("agents/recurrent_iqn.py", "RecurrentIQNCore.select_action_recurrent(rng)", "RecurrentIQNCore.select_action_recurrent(draws)", RENAMED),
    ("agents/recurrent_iqn.py", "RecurrentIQNCore.update_episodic(rng)", "RecurrentIQNCore.update_episodic(draws)", RENAMED),
    # agents/recurrent_ppo.py
    ("agents/recurrent_ppo.py", "RecurrentPPOCore.init(rng)", "RecurrentPPOCore.init(generator)", RENAMED),
    ("agents/recurrent_ppo.py", "RecurrentPPOCore.select_action_recurrent(rng)", "RecurrentPPOCore.select_action_recurrent(draws)", RENAMED),
    ("agents/recurrent_ppo.py", "RecurrentPPOCore.act_with_aux_recurrent(rng)", "RecurrentPPOCore.act_with_aux_recurrent(draws)", RENAMED),
    ("agents/recurrent_ppo.py", "RecurrentPPOCore.update(rng)", "RecurrentPPOCore.update(draws)", RENAMED),
    # agents/recurrent_trpo.py
    ("agents/recurrent_trpo.py", "RecurrentTRPOCore.init(rng)", "RecurrentTRPOCore.init(generator)", RENAMED),
    ("agents/recurrent_trpo.py", "RecurrentTRPOCore.select_action_recurrent(rng)", "RecurrentTRPOCore.select_action_recurrent(draws)", RENAMED),
    ("agents/recurrent_trpo.py", "RecurrentTRPOCore.act_with_aux_recurrent(rng)", "RecurrentTRPOCore.act_with_aux_recurrent(draws)", RENAMED),
    ("agents/recurrent_trpo.py", "RecurrentTRPOCore.update(rng)", "RecurrentTRPOCore.update(draws)", RENAMED),
    # agents/reinforce.py
    ("agents/reinforce.py", "ReinforceState(params)", "ReinforceState(model)", PARAMS),
    ("agents/reinforce.py", "ReinforceCore.init(rng)", "ReinforceCore.init(generator)", RENAMED),
    ("agents/reinforce.py", "ReinforceCore.select_action(rng)", "ReinforceCore.select_action(draws)", RENAMED),
    ("agents/reinforce.py", "ReinforceCore.update(rng)", None, JAX_ONLY),
    # agents/soft_actor_critic.py
    ("agents/soft_actor_critic.py", "SACState(policy_params)", "SACState(policy)", PARAMS),
    ("agents/soft_actor_critic.py", "SACState(q1_params)", "SACState(q_func1)", PARAMS),
    ("agents/soft_actor_critic.py", "SACState(q2_params)", "SACState(q_func2)", PARAMS),
    ("agents/soft_actor_critic.py", "SACState(target_q1_params)", "SACState(target_q_func1)", PARAMS),
    ("agents/soft_actor_critic.py", "SACState(target_q2_params)", "SACState(target_q_func2)", PARAMS),
    ("agents/soft_actor_critic.py", "SACCore.init(rng)", "SACCore.init(generator)", RENAMED),
    ("agents/soft_actor_critic.py", "SACCore.select_action(rng)", "SACCore.select_action(draws)", RENAMED),
    ("agents/soft_actor_critic.py", "SACCore.critic_losses(q1_params)", "SACCore.critic_losses(state)", PARAMS),
    ("agents/soft_actor_critic.py", "SACCore.critic_losses(q2_params)", "SACCore.critic_losses(state)", PARAMS),
    ("agents/soft_actor_critic.py", "SACCore.critic_losses(rng)", "SACCore.critic_losses(draws)", RENAMED),
    ("agents/soft_actor_critic.py", "SACCore.actor_and_temp_loss(policy_params)", "SACCore.actor_and_temp_loss(state)", PARAMS),
    ("agents/soft_actor_critic.py", "SACCore.actor_and_temp_loss(log_temp)", "SACCore.actor_and_temp_loss(state)", PARAMS),
    ("agents/soft_actor_critic.py", "SACCore.actor_and_temp_loss(rng)", "SACCore.actor_and_temp_loss(draws)", RENAMED),
    ("agents/soft_actor_critic.py", "SACCore.update(rng)", "SACCore.update(draws)", RENAMED),
    # agents/td3.py
    ("agents/td3.py", "TD3State(policy_params)", "TD3State(policy)", PARAMS),
    ("agents/td3.py", "TD3State(q1_params)", "TD3State(q_func1)", PARAMS),
    ("agents/td3.py", "TD3State(q2_params)", "TD3State(q_func2)", PARAMS),
    ("agents/td3.py", "TD3State(target_policy_params)", "TD3State(target_policy)", PARAMS),
    ("agents/td3.py", "TD3State(target_q1_params)", "TD3State(target_q_func1)", PARAMS),
    ("agents/td3.py", "TD3State(target_q2_params)", "TD3State(target_q_func2)", PARAMS),
    ("agents/td3.py", "default_target_policy_smoothing_func(rng)", "default_target_policy_smoothing_func(draws)", RENAMED),
    ("agents/td3.py", "TD3Core.init(rng)", "TD3Core.init(generator)", RENAMED),
    ("agents/td3.py", "TD3Core.select_action(rng)", "TD3Core.select_action(draws)", RENAMED),
    ("agents/td3.py", "TD3Core.critic_losses(q1_params)", "TD3Core.critic_losses(state)", PARAMS),
    ("agents/td3.py", "TD3Core.critic_losses(q2_params)", "TD3Core.critic_losses(state)", PARAMS),
    ("agents/td3.py", "TD3Core.critic_losses(rng)", "TD3Core.critic_losses(draws)", RENAMED),
    ("agents/td3.py", "TD3Core.actor_loss(policy_params)", "TD3Core.actor_loss(state)", PARAMS),
    ("agents/td3.py", "TD3Core.update(rng)", "TD3Core.update(draws)", RENAMED),
    # agents/trpo.py
    ("agents/trpo.py", "TRPOState(policy_params)", "TRPOState(policy)", PARAMS),
    ("agents/trpo.py", "TRPOState(vf_params)", "TRPOState(vf)", PARAMS),
    ("agents/trpo.py", "TRPOCore.init(rng)", "TRPOCore.init(generator)", RENAMED),
    ("agents/trpo.py", "TRPOCore.forward(state_or_params)", "TRPOCore.forward(state_or_policy)", PARAMS),
    ("agents/trpo.py", "TRPOCore.value(vf_params)", "TRPOCore.value(vf)", PARAMS),
    ("agents/trpo.py", "TRPOCore.select_action(rng)", "TRPOCore.select_action(draws)", RENAMED),
    ("agents/trpo.py", "TRPOCore.act_with_aux(rng)", "TRPOCore.act_with_aux(draws)", RENAMED),
    ("agents/trpo.py", "TRPOCore.update(rng)", "TRPOCore.update(draws)", RENAMED),
    # distributions/base.py
    ("distributions/base.py", "Distribution.sample(rng)", "Distribution.sample(draws)", RENAMED),
    ("distributions/base.py", "Distribution.rsample(rng)", "Distribution.rsample(draws)", RENAMED),
    ("distributions/base.py", "Distribution.sample_and_log_prob(rng)", "Distribution.sample_and_log_prob(draws)", RENAMED),
    # distributions/categorical.py
    ("distributions/categorical.py", "Categorical.sample(rng)", "Categorical.sample(draws)", RENAMED),
    # distributions/delta.py
    ("distributions/delta.py", "Delta.sample(rng)", "Delta.sample(draws)", RENAMED),
    ("distributions/delta.py", "Delta.rsample(rng)", "Delta.rsample(draws)", RENAMED),
    # distributions/normal.py
    ("distributions/normal.py", "Normal.sample(rng)", "Normal.sample(draws)", RENAMED),
    ("distributions/normal.py", "Normal.rsample(rng)", "Normal.rsample(draws)", RENAMED),
    # distributions/squashed_normal.py
    ("distributions/squashed_normal.py", "SquashedNormal.sample(rng)", "SquashedNormal.sample(draws)", RENAMED),
    ("distributions/squashed_normal.py", "SquashedNormal.rsample(rng)", "SquashedNormal.rsample(draws)", RENAMED),
    ("distributions/squashed_normal.py", "SquashedNormal.sample_and_log_prob(rng)", "SquashedNormal.sample_and_log_prob(draws)", RENAMED),
    # env.py
    ("env.py", "JaxEnv", "TorchEnv", RENAMED),
    # envs/abc.py
    ("envs/abc.py", "ABC.reset(rng)", "ABC.reset(draws)", RENAMED),
    ("envs/abc.py", "ABC.step(rng)", "ABC.step(draws)", RENAMED),
    ("envs/abc.py", "ABC.step(action)", "ABC.step(actions)", RENAMED),
    # envs/atari_sim.py
    ("envs/atari_sim.py", "AtariSim.reset(rng)", "AtariSim.reset(draws)", RENAMED),
    ("envs/atari_sim.py", "AtariSim.step(rng)", None, JAX_ONLY),
    ("envs/atari_sim.py", "AtariSim.step(action)", "AtariSim.step(actions)", RENAMED),
    # envs/cartpole.py
    ("envs/cartpole.py", "CartPole.reset(rng)", "CartPole.reset(draws)", RENAMED),
    ("envs/cartpole.py", "CartPole.step(rng)", None, JAX_ONLY),
    ("envs/cartpole.py", "CartPole.step(action)", "CartPole.step(actions)", RENAMED),
    # envs/delayed_cue.py
    ("envs/delayed_cue.py", "DelayedCue.reset(rng)", "DelayedCue.reset(draws)", RENAMED),
    ("envs/delayed_cue.py", "DelayedCue.step(rng)", None, JAX_ONLY),
    ("envs/delayed_cue.py", "DelayedCue.step(action)", "DelayedCue.step(actions)", RENAMED),
    # envs/host_adapter.py
    ("envs/host_adapter.py", "HostJaxEnv", "HostTorchEnv", RENAMED),
    # envs/mountain_car.py
    ("envs/mountain_car.py", "MountainCarContinuous.reset(rng)", "MountainCarContinuous.reset(draws)", RENAMED),
    ("envs/mountain_car.py", "MountainCarContinuous.step(rng)", None, JAX_ONLY),
    ("envs/mountain_car.py", "MountainCarContinuous.step(action)", "MountainCarContinuous.step(actions)", RENAMED),
    # envs/mujoco_sim.py
    ("envs/mujoco_sim.py", "MujocoSim.reset(rng)", "MujocoSim.reset(draws)", RENAMED),
    ("envs/mujoco_sim.py", "MujocoSim.step(rng)", None, JAX_ONLY),
    ("envs/mujoco_sim.py", "MujocoSim.step(action)", "MujocoSim.step(actions)", RENAMED),
    # envs/pendulum.py
    ("envs/pendulum.py", "Pendulum.reset(rng)", "Pendulum.reset(draws)", RENAMED),
    ("envs/pendulum.py", "Pendulum.step(rng)", None, JAX_ONLY),
    ("envs/pendulum.py", "Pendulum.step(action)", "Pendulum.step(actions)", RENAMED),
    # envs/vector_jax_env.py
    ("envs/vector_jax_env.py", "VectorJaxEnv", "VectorTorchEnv", RENAMED),
    # envs/wrappers.py
    ("envs/wrappers.py", "TimeLimit.reset(rng)", "TimeLimit.reset(draws)", RENAMED),
    ("envs/wrappers.py", "TimeLimit.step(rng)", None, JAX_ONLY),
    ("envs/wrappers.py", "TimeLimit.step(action)", "TimeLimit.step(actions)", RENAMED),
    ("envs/wrappers.py", "ScaleReward.reset(rng)", "ScaleReward.reset(draws)", RENAMED),
    ("envs/wrappers.py", "ScaleReward.step(rng)", None, JAX_ONLY),
    ("envs/wrappers.py", "ScaleReward.step(action)", "ScaleReward.step(actions)", RENAMED),
    ("envs/wrappers.py", "CastObservationToFloat32.reset(rng)", "CastObservationToFloat32.reset(draws)", RENAMED),
    ("envs/wrappers.py", "CastObservationToFloat32.step(rng)", None, JAX_ONLY),
    ("envs/wrappers.py", "CastObservationToFloat32.step(action)", "CastObservationToFloat32.step(actions)", RENAMED),
    ("envs/wrappers.py", "NormalizeActionSpace.reset(rng)", "NormalizeActionSpace.reset(draws)", RENAMED),
    ("envs/wrappers.py", "NormalizeActionSpace.step(rng)", None, JAX_ONLY),
    ("envs/wrappers.py", "NormalizeActionSpace.step(action)", "NormalizeActionSpace.step(actions)", RENAMED),
    # experiments/env_cli.py
    ("experiments/env_cli.py", "make_backend_env(jax_env_factory)", "make_backend_env(torch_env_factory)", RENAMED),
    # experiments/onpolicy_runner.py
    ("experiments/onpolicy_runner.py", "OnPolicyRunnerState(rng)", "OnPolicyRunnerState(draws)", RENAMED),
    ("experiments/onpolicy_runner.py", "OnPolicyRunner(data_axis)", None, JAX_ONLY),
    ("experiments/onpolicy_runner.py", "OnPolicyRunner.init(rng)", "OnPolicyRunner.init(draws)", RENAMED),
    # experiments/runner.py
    ("experiments/runner.py", "RunnerState(rng)", "RunnerState(draws)", RENAMED),
    ("experiments/runner.py", "OffPolicyRunner(data_axis)", None, JAX_ONLY),
    ("experiments/runner.py", "OffPolicyRunner.init(rng)", "OffPolicyRunner.init(draws)", RENAMED),
    ("experiments/runner.py", "JaxEvalLoop", "EvalLoop", RENAMED),
    # explorer.py
    ("explorer.py", "Explorer.select_action(rng)", "Explorer.select_action(draws)", RENAMED),
    # explorers/additive_gaussian.py
    ("explorers/additive_gaussian.py", "AdditiveGaussian.select_action(rng)", "AdditiveGaussian.select_action(draws)", RENAMED),
    # explorers/additive_ou.py
    ("explorers/additive_ou.py", "AdditiveOU.select_action_stateful(rng)", "AdditiveOU.select_action_stateful(draws)", RENAMED),
    ("explorers/additive_ou.py", "AdditiveOU.select_action(rng)", "AdditiveOU.select_action(draws)", RENAMED),
    # explorers/boltzmann.py
    ("explorers/boltzmann.py", "Boltzmann.select_action(rng)", "Boltzmann.select_action(draws)", RENAMED),
    # explorers/epsilon_greedy.py
    ("explorers/epsilon_greedy.py", "ConstantEpsilonGreedy.select_action(rng)", "ConstantEpsilonGreedy.select_action(draws)", RENAMED),
    ("explorers/epsilon_greedy.py", "LinearDecayEpsilonGreedy.select_action(rng)", "LinearDecayEpsilonGreedy.select_action(draws)", RENAMED),
    ("explorers/epsilon_greedy.py", "ExponentialDecayEpsilonGreedy.select_action(rng)", "ExponentialDecayEpsilonGreedy.select_action(draws)", RENAMED),
    # explorers/greedy.py
    ("explorers/greedy.py", "Greedy.select_action(rng)", "Greedy.select_action(draws)", RENAMED),
    # initializers/__init__.py
    ("initializers/__init__.py", "lecun_normal", "lecun_normal_", RENAMED),
    ("initializers/__init__.py", "chainer_default_w", "chainer_default_", RENAMED),
    ("initializers/__init__.py", "constant_bias", "chainer_default_(bias)", RENAMED),
    # models/noisy_linear.py
    ("models/noisy_linear.py", "FactorizedNoisyDense", "FactorizedNoisyLinear", RENAMED),
    # models/recurrent.py: the layers and branches are positional, as nn.Sequential's
    ("models/recurrent.py", "RecurrentBranched(branches)", "RecurrentBranched", RENAMED),
    ("models/recurrent.py", "RecurrentSequential(layers)", "RecurrentSequential", RENAMED),
    # ops/pallas_kernels.py
    ("ops/pallas_kernels.py", "prefix_sample_pallas", "prefix_sample", RENAMED),
    # optimizers/rmsprop_eps_inside_sqrt.py
    ("optimizers/rmsprop_eps_inside_sqrt.py", "RMSpropEISState", "RMSpropEpsInsideSqrtState", RENAMED),
    ("optimizers/rmsprop_eps_inside_sqrt.py", "rmsprop_eps_inside_sqrt", "RMSpropEpsInsideSqrt", RENAMED),
    # parallel/data_parallel.py
    ("parallel/data_parallel.py", "data_parallel_update(axis)", None, JAX_ONLY),
    ("parallel/data_parallel.py", "pmean_grads(axis)", None, JAX_ONLY),
    # parallel/mesh.py
    ("parallel/mesh.py", "make_mesh(devices)", None, JAX_ONLY),
    ("parallel/mesh.py", "shard_batch(axis)", None, JAX_ONLY),
    # parallel/multihost.py
    ("parallel/multihost.py", "initialize_multihost(local_device_ids)", None, JAX_ONLY),
    # q_functions/quantile_q_functions.py
    ("q_functions/quantile_q_functions.py", "ImplicitQuantileQFunction(hidden_size)", None, UNUSED),
    # replay/episodic.py
    ("replay/episodic.py", "EpisodicReplayState(item_shapes)", None, JAX_ONLY),
    ("replay/episodic.py", "EpisodicReplayBuffer.sample_episodes(rng)", "EpisodicReplayBuffer.sample_episodes(draws)", RENAMED),
    ("replay/episodic.py", "EpisodicReplayBuffer.sample(rng)", "EpisodicReplayBuffer.sample(draws)", RENAMED),
    ("replay/episodic.py", "EpisodicReplayBuffer.split_storage", None, JAX_ONLY),
    ("replay/episodic.py", "EpisodicReplayBuffer.merge_storage", None, JAX_ONLY),
    # replay/prioritized.py
    ("replay/prioritized.py", "PrioritizedReplayBuffer(use_pallas)", None, JAX_ONLY),
    ("replay/prioritized.py", "PrioritizedReplayBuffer.sample(rng)", "PrioritizedReplayBuffer.sample(draws)", RENAMED),
    ("replay/prioritized.py", "PrioritizedReplayBuffer.split_storage", None, JAX_ONLY),
    ("replay/prioritized.py", "PrioritizedReplayBuffer.merge_storage", None, JAX_ONLY),
    # replay/prioritized_episodic.py
    ("replay/prioritized_episodic.py", "PrioritizedEpisodicReplayState(base)", "EpisodicReplayState", RENAMED),
    ("replay/prioritized_episodic.py", "PrioritizedEpisodicReplayBuffer.sample_episodes(rng)", "PrioritizedEpisodicReplayBuffer.sample_episodes(draws)", RENAMED),
    ("replay/prioritized_episodic.py", "PrioritizedEpisodicReplayBuffer.split_storage", None, JAX_ONLY),
    ("replay/prioritized_episodic.py", "PrioritizedEpisodicReplayBuffer.merge_storage", None, JAX_ONLY),
    # replay/sum_tree.py
    ("replay/sum_tree.py", "stratified_targets(rng)", "stratified_targets(u)", RENAMED),
    ("replay/sum_tree.py", "stratified_targets(batch_size)", "stratified_targets(u)", RENAMED),
    ("replay/sum_tree.py", "stratified_sample(rng)", "stratified_sample(draws)", RENAMED),
    # replay/uniform.py
    ("replay/uniform.py", "ItemShape", None, JAX_ONLY),
    ("replay/uniform.py", "flatten_items", None, JAX_ONLY),
    ("replay/uniform.py", "unflatten_items", None, JAX_ONLY),
    ("replay/uniform.py", "ReplayBuffer(use_pallas)", None, JAX_ONLY),
    ("replay/uniform.py", "ReplayBuffer.sample_indices(rng)", "ReplayBuffer.sample_indices(draws)", RENAMED),
    ("replay/uniform.py", "ReplayBuffer.sample(rng)", "ReplayBuffer.sample(draws)", RENAMED),
    ("replay/uniform.py", "ReplayBuffer.update_priorities(priorities)", "ReplayBuffer.update_priorities(errors)", RENAMED),
    ("replay/uniform.py", "ReplayBuffer.split_storage", None, JAX_ONLY),
    ("replay/uniform.py", "ReplayBuffer.merge_storage", None, JAX_ONLY),
    # runtime/__init__.py
    ("runtime/__init__.py", "native_available", None, NO_FALLBACK),
    ("runtime/__init__.py", "warp_frames(_force_numpy)", "warp_frames(plain)", RENAMED),
    # testing.py
    ("testing.py", "jax_assert_allclose", "torch_assert_allclose", RENAMED),
    # utils/precision.py
    ("utils/precision.py", "apply_cast(params)", "apply_cast(module)", PARAMS),
    # utils/random.py
    ("utils/random.py", "sample_n_k(rng)", "sample_n_k(draws)", RENAMED),
    ("utils/random.py", "sample_with_replacement(rng)", "sample_with_replacement(draws)", RENAMED),
    # utils/recurrent.py
    ("utils/recurrent.py", "one_step_forward(params)", "one_step_forward(apply_fn)", PARAMS),
    ("utils/recurrent.py", "unroll(params)", "unroll(apply_fn)", PARAMS),
]


def _counterpart_exists(port: Tree, path: str, spec: str) -> bool:
    name, member, arg = re.fullmatch(r"(\w+)(?:\.(\w+))?(?:\((\w+)\))?", spec).groups()
    for c in port.candidates(path, name):
        if member is None:
            if arg is None or arg in _call_args(port, c):
                return True
        elif isinstance(c.node, ast.ClassDef):
            m = port.members(c)
            if arg is None and (member in m.methods or member in m.attributes or member in m.fields):
                return True
            if arg is not None and arg in m.methods.get(member, ()):
                return True
    return False


def check(jax_tree: Tree, port: Tree, path: str, differences) -> Tuple[List[str], List[str]]:
    """``(unlisted, stale)`` for the JAX module ``path``: what the port
    lacks that ``differences`` does not list, and what it lists that the
    port does not lack (or that no longer exists in ``pfrl_tpu/``)."""
    listed = {item for p, item, _, _ in differences if p == path}
    missing = set(audit(jax_tree, port, path))
    return sorted(missing - listed), sorted(listed - missing)


@functools.lru_cache(maxsize=None)
def jax_tree() -> Tree:
    return Tree(JAX_ROOT)


@functools.lru_cache(maxsize=None)
def port_tree() -> Tree:
    return Tree(PORT_ROOT)


JAX_MODULES = _module_files(JAX_ROOT)


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("path", JAX_MODULES)
def test_module_surface_is_ported_or_listed(path):
    unlisted, stale = check(jax_tree(), port_tree(), path, DIFFERENCES)
    assert not unlisted, f"the port lacks {unlisted} of pfrl_tpu/{path}: port it, or list it in DIFFERENCES"
    assert not stale, f"DIFFERENCES lists {stale} of pfrl_tpu/{path}, which the port has or pfrl_tpu/ no longer does"


def test_differences_are_well_formed():
    assert len(JAX_MODULES) == sum(f.endswith(".py") for _, _, fs in os.walk(JAX_ROOT) for f in fs)
    items = [(path, item) for path, item, _, _ in DIFFERENCES]
    assert len(items) == len(set(items)), "an entry is listed twice"
    for path, item, counterpart, reason in DIFFERENCES:
        assert path in JAX_MODULES, f"{path} is not a module of pfrl_tpu/"
        assert reason in REASONS, (path, item, reason)
        if counterpart is not None:
            assert _counterpart_exists(port_tree(), path, counterpart), f"{path}: {item} -> {counterpart} is not in the port"


def test_a_name_removed_from_the_port_is_reported():
    port = Tree(PORT_ROOT, drop=(("utils/recurrent.py", "one_step_forward"),))
    unlisted, stale = check(jax_tree(), port, "utils/recurrent.py", DIFFERENCES)
    assert unlisted == ["one_step_forward"]
    assert stale == ["one_step_forward(params)"]  # the name's own entries go stale with it
    assert not _counterpart_exists(port, "utils/recurrent.py", "one_step_forward(apply_fn)")


def test_a_removed_argument_and_method_are_reported(tmp_path):
    """A port whose Atari torsos take no ``activation`` and whose TRPO core
    has no ``forward``, read from a copy."""
    for rel, old, new in (
        ("models/atari_cnn.py", "input_hw=(84, 84), activation: Callable = torch.relu)", "input_hw=(84, 84))"),
        ("agents/trpo.py", "    def forward(self, state_or_policy", "    def _forward(self, state_or_policy"),
    ):
        with open(os.path.join(PORT_ROOT, rel)) as f:
            text = f.read()
        assert old in text
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text.replace(old, new))
    port = Tree(str(tmp_path))
    assert check(jax_tree(), port, "models/atari_cnn.py", DIFFERENCES)[0] == [
        "LargeAtariCNN(activation)", "SmallAtariCNN(activation)"]
    assert "TRPOCore.forward" in check(jax_tree(), port, "agents/trpo.py", DIFFERENCES)[0]


def test_a_stale_entry_fails():
    extra = [("utils/recurrent.py", "unroll(resets)", None, RENAMED),  # the port has it
             ("utils/recurrent.py", "no_such_function", None, RENAMED)]  # pfrl_tpu/ has no such name
    unlisted, stale = check(jax_tree(), port_tree(), "utils/recurrent.py", DIFFERENCES + extra)
    assert not unlisted and stale == ["no_such_function", "unroll(resets)"]


def test_inherited_methods_count():
    """The port's ``Delta`` inherits ``rsample``'s counterpart from
    ``distributions/base.py``; the scan finds it through the base class."""
    (delta,) = port_tree().candidates("distributions/delta.py", "Delta")
    assert "rsample" not in _class_members(delta.node).methods
    assert "draws" in port_tree().members(delta).methods["rsample"]
