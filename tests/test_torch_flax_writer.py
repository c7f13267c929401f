"""The port's msgpack writer (``utils/flax_msgpack.py``) and its reverse
converters (``convert.state_to_flax``, ``save_flax_checkpoint``) against
flax and the JAX package.

(a) ``msgpack_serialize`` gives ``flax.serialization.msgpack_serialize``'s
    bytes exactly on the same state dict with numpy leaves (``in_place``,
    as ``to_bytes`` packs; flax's default sorts the keys first): fixed trees with every leaf kind flax writes, a
    bfloat16 leaf (a ``torch.bfloat16`` tensor on the port's side, an
    ``ml_dtypes`` array on flax's), chunked leaves (``MAX_CHUNK_SIZE``
    lowered on both sides by ``monkeypatch``) and random trees
    (hypothesis, ``database=None``).
(b) Every ``zoo/`` entry (26 of them: the value family, recurrent DRQN
    and IQN, DDPG, TD3, SAC, PPO, A2C, recurrent PPO, TRPO, recurrent TRPO,
    REINFORCE, ACER discrete and continuous), loaded by the port and written
    back by ``save_flax_checkpoint``, is the JAX package's own file byte for
    byte; and the JAX package's ``load_state`` (flax's ``from_bytes``)
    restores the port's file into the JAX core's template (its init
    state, as the zoo tests restore it) with every leaf equal to the bit
    and in dtype, and no key left over on either side.
(c) A DQN core over ``RMSpropEpsInsideSqrt`` (each of centered and
    momentum on and off), whose unused trees flax writes as ``{}``:
    ``from_bytes`` of the JAX core's init template takes the port's file.
(d) A port ``--save-to`` directory (the quickstart's device runner)
    loads through the JAX package's ``demo_cli.maybe_load_train_state``.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from pfrl_tpu.replay.persistent import load_state
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agent import to_saved
from pfrl_tpu_torch.experiments import zoo
from pfrl_tpu_torch.utils import flax_msgpack

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(ROOT, "zoo")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_leaves(tree):
    """The same tree with each ``ml_dtypes`` bfloat16 array as the
    ``torch.bfloat16`` tensor of its bits, as the port holds one."""
    if isinstance(tree, dict):
        return {k: port_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return tree


def assert_same_state_dict(got, want, path="state"):
    """The same keys in any order, None where None, and every array leaf
    of the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same_state_dict(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), path


# ------------------------------------------------------------ (a) the bytes
def _fixed_tree():
    rs = np.random.RandomState(0)
    return {
        "params": {"Dense_0": {"kernel": rs.normal(size=(3, 4)).astype(np.float32),
                               "bias": np.zeros(4, np.float32)},
                   "Conv_10": {"kernel": rs.normal(size=(2, 2, 1, 3)).astype(np.float32)}},
        "opt_state": {"0": {"count": np.asarray(7, np.int32), "mu": {"w": np.ones((2,), np.float32)}}, "1": {}},
        "n_updates": np.asarray(2**20, np.int32),
        "extras": None,
        "flags": np.array([True, False]),
        "empty": np.zeros((0, 3), np.uint8),
        "ints": np.arange(-3, 300, 7, dtype=np.int64),
        "half": rs.normal(size=(5,)).astype(ml_dtypes.bfloat16),
        "scalar": np.float32(2.5),
        "py": {"i": -200, "big": 2**40, "neg": -(2**33), "f": 0.1, "t": True, "s": "x" * 40, "b": b"\x00\x01",
               "c": 1 + 2j},
    }


def _sorted_keys(tree):
    return {k: _sorted_keys(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


@pytest.mark.parametrize("order", ["as given", "sorted"])
def test_the_writer_gives_flax_bytes(order):
    """In the tree's own order, as ``to_bytes`` packs (flax's ``in_place``),
    and, for a tree with sorted keys, as flax's default (which sorts them
    by a JAX tree map first) packs."""
    tree = _fixed_tree() if order == "as given" else _sorted_keys(_fixed_tree())
    got = flax_msgpack.msgpack_serialize(port_leaves(tree))
    assert got == serialization.msgpack_serialize(tree, in_place=True)
    assert (got == serialization.msgpack_serialize(tree)) == (order == "sorted")
    assert torch.equal(flax_msgpack.msgpack_restore(got)["half"], port_leaves(tree)["half"])


def test_chunked_leaves_are_written_as_flax_writes_them(monkeypatch):
    """An array above ``MAX_CHUNK_SIZE`` bytes becomes
    ``{"__msgpack_chunked_array__": True, "shape", "chunks"}``, a bfloat16
    array included; the reader joins it back."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 48)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 48)

    def tree():
        rs = np.random.RandomState(1)
        return {"big": rs.normal(size=(7, 5)).astype(np.float32), "small": np.arange(3, dtype=np.int32),
                "nested": {"half": rs.normal(size=(40,)).astype(ml_dtypes.bfloat16),
                           "odd": rs.normal(size=(13,)).astype(np.float64)}}

    got = flax_msgpack.msgpack_serialize(port_leaves(tree()))
    assert got == serialization.msgpack_serialize(tree(), in_place=True) and b"__msgpack_chunked_array__" in got
    want_sorted = serialization.msgpack_serialize(tree())  # flax's default sorts the keys
    assert got != want_sorted and flax_msgpack.msgpack_serialize(port_leaves(_sorted_keys(tree()))) == want_sorted
    back = flax_msgpack.msgpack_restore(got)
    np.testing.assert_array_equal(back["big"], tree()["big"])
    assert torch.equal(back["nested"]["half"], port_leaves(tree())["nested"]["half"])


_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.int8, np.uint16, np.bool_, ml_dtypes.bfloat16]


@st.composite
def _leaf(draw):
    kind = draw(st.sampled_from(["array", "int", "float", "str", "bool", "none", "np_scalar"]))
    if kind == "array":
        shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
        dtype = draw(st.sampled_from(_DTYPES))
        seed = draw(st.integers(0, 2**16))
        return (np.random.RandomState(seed).normal(size=shape) * 50).astype(dtype)
    if kind == "int":
        return draw(st.integers(-(2**63), 2**64 - 1))
    if kind == "float":
        return draw(st.floats(allow_nan=False))
    if kind == "str":
        return draw(st.text(max_size=300))
    if kind == "bool":
        return draw(st.booleans())
    if kind == "np_scalar":
        return np.float32(draw(st.floats(-1e6, 1e6, width=32)))
    return None


_trees = st.recursive(_leaf(), lambda children: st.dictionaries(st.text(max_size=20), children, max_size=20),
                      max_leaves=40)


@settings(max_examples=60, deadline=None, database=None)
@given(tree=st.dictionaries(st.text(max_size=20), _trees, max_size=20))
def test_random_trees_are_written_as_flax_writes_them(tree):
    tree = _sorted_keys(tree)
    assert flax_msgpack.msgpack_serialize(port_leaves(tree)) == serialization.msgpack_serialize(tree)


# ------------------------------------------------------------ (b) the zoo
def jax_state(name):
    """Zoo entry ``name`` as the JAX package restores it: ``load_state``
    into the JAX core's init template, or the JAX shell's ``load`` (the zoo
    test modules' own helpers, imported by name)."""
    alg, env = name.split("/")
    path = zoo.checkpoint_path(name, ZOO)
    if name in ("dqn/cartpole", "c51/cartpole", "al/cartpole", "iqn/cartpole", "rainbow/cartpole"):
        from test_torch_zoo_value import checkpoint

        return checkpoint(alg)[1]
    if name in ("dqn_bf16/cartpole", "sac_bf16/pendulum"):
        from test_torch_zoo_precision import checkpoint

        return checkpoint(name)[1]
    if env == "pendulum" and alg in ("sac", "td3", "ddpg"):
        from test_torch_zoo_actor_critic import _jax_core

        return load_state(_jax_core(alg).init(jax.random.PRNGKey(0), jnp.zeros((1, 3)), jnp.zeros((1, 1))), path)
    if name in ("ppo/pendulum", "trpo/pendulum", "a2c/cartpole", "ppo/hopper_real"):
        from test_torch_zoo_onpolicy import checkpoint

        return checkpoint("hopper" if env == "hopper_real" else alg)[2]
    if env in ("po_abc", "delayed_cue"):
        from test_torch_zoo_recurrent import checkpoint

        return checkpoint(name)[2]
    if alg.startswith("acer"):
        from test_torch_zoo_acer import checkpoint

        return checkpoint(name)[2]
    from test_torch_zoo_host import actor_critic_checkpoint, checkpoint

    jagent, _ = (actor_critic_checkpoint if name in ("sac/hopper_real", "td3/halfcheetah_real") else checkpoint)(name)
    return jagent.train_state


def test_the_zoo_covers_every_family_of_state_from_flax():
    from pfrl_tpu_torch.agents.acer import ACERContinuousCore, ACERCore
    from pfrl_tpu_torch.agents.ddpg import DDPGCore
    from pfrl_tpu_torch.agents.dqn import DQNCore
    from pfrl_tpu_torch.agents.ppo import PPOCore
    from pfrl_tpu_torch.agents.reinforce import ReinforceCore
    from pfrl_tpu_torch.agents.soft_actor_critic import SACCore
    from pfrl_tpu_torch.agents.td3 import TD3Core
    from pfrl_tpu_torch.agents.trpo import TRPOCore

    dispatch = (DQNCore, SACCore, TD3Core, DDPGCore, TRPOCore, PPOCore, ReinforceCore, ACERCore, ACERContinuousCore)
    cores = [entry.build("cpu") for entry in zoo.ENTRIES.values()]
    seen = {next(cls for cls in dispatch if isinstance(core, cls)) for core in cores}
    assert seen == set(dispatch) and len(cores) == 26


@pytest.mark.parametrize("name", sorted(zoo.ENTRIES))
def test_a_zoo_state_is_written_back_as_the_jax_packages_file(name, tmp_path):
    core, state = zoo.load(name, device="cpu", root=ZOO)
    path = convert.save_flax_checkpoint(core, state, str(tmp_path / "train_state.msgpack"))
    with open(path, "rb") as f, open(zoo.checkpoint_path(name, ZOO), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name", sorted(zoo.ENTRIES))
def test_jax_restores_the_ports_checkpoint_into_its_template(name, tmp_path):
    template = jax_state(name)
    core, state = zoo.load(name, device="cpu", root=ZOO)
    path = convert.save_flax_checkpoint(core, state, str(tmp_path / "train_state.msgpack"))
    restored = load_state(template, path)
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    written = flax_msgpack.read(path)
    assert_same_state_dict(np_tree(serialization.to_state_dict(restored)), written)
    assert_same_state_dict(np_tree(serialization.to_state_dict(restored)),
                           np_tree(serialization.to_state_dict(template)))
    # ... and the port converts the JAX restore back to its own tensors.
    again = convert.state_from_flax(core, np_tree(restored), device="cpu")
    g, w = to_saved(again), to_saved(state)
    assert_same_saved(g, w)


def assert_same_saved(got, want, path="saved"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same_saved(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_saved(g, w, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


# ------------------------------------------- (c) RMSpropEpsInsideSqrt's state
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_a_rmsprop_eps_inside_sqrt_core_writes_the_jax_layout(centered, momentum, tmp_path):
    from pfrl_tpu import explorers as jexplorers
    from pfrl_tpu import q_functions as jq
    from pfrl_tpu.agents.dqn import DQNCore as JaxDQN
    from pfrl_tpu.optimizers import rmsprop_eps_inside_sqrt
    from pfrl_tpu_torch.agents.dqn import DQNCore
    from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
    from pfrl_tpu_torch.optimizers import RMSpropEpsInsideSqrt
    from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction

    settings_ = dict(alpha=0.95, eps=1e-2, momentum=momentum, centered=centered)
    jcore = JaxDQN(model=jq.FCStateQFunctionWithDiscreteAction(n_actions=2, n_hidden_channels=16, n_hidden_layers=2),
                   optimizer=rmsprop_eps_inside_sqrt(2.5e-4, **settings_),
                   explorer=jexplorers.LinearDecayEpsilonGreedy(1.0, 0.05, 100, 2), gamma=0.99)
    template = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    core = DQNCore(model=FCStateQFunctionWithDiscreteAction(4, 2, n_hidden_layers=2, n_hidden_channels=16),
                   optimizer=RMSpropEpsInsideSqrt(2.5e-4, **settings_),
                   explorer=LinearDecayEpsilonGreedy(1.0, 0.05, 100, 2), gamma=0.99)
    state = core.init(torch.Generator().manual_seed(0), torch.zeros(1, 4))
    gen = torch.Generator().manual_seed(1)
    for field in ("square_avg", "momentum_buf", "grad_avg"):
        for t in getattr(state.opt_state, field):
            t.copy_(torch.rand(t.shape, generator=gen))
    state.n_updates = 11
    path = convert.save_flax_checkpoint(core, state, str(tmp_path / "train_state.msgpack"))
    written = flax_msgpack.read(path)
    for field, used in (("momentum_buf", momentum > 0), ("grad_avg", centered)):
        assert (written["opt_state"][field] == {}) != used
    restored = load_state(template, path)
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    assert_same_state_dict(np_tree(serialization.to_state_dict(restored)), written)
    assert int(restored.n_updates) == 11 and restored.n_updates.dtype == jnp.int32
    again = convert.state_from_flax(core, np_tree(restored), device="cpu")
    assert_same_saved(to_saved(again), to_saved(state))


# ------------------------------------------------------------ (d) --save-to
def test_a_port_save_to_loads_through_the_jax_demo_cli(tmp_path):
    """The port's quickstart trains 1,536 transitions on the CPU and saves;
    the JAX example's runner state takes the directory through
    ``maybe_load_train_state`` (which picks ``train_state.msgpack``)."""
    from pfrl_tpu import envs as jenvs
    from pfrl_tpu import explorers as jexplorers
    from pfrl_tpu import replay_buffers as jreplay
    from pfrl_tpu import q_functions as jq
    from pfrl_tpu.agents.dqn import DQNCore as JaxDQN
    from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
    from pfrl_tpu.experiments import RunnerConfig as JaxConfig
    from pfrl_tpu.experiments.demo_cli import maybe_load_train_state
    from pfrl_tpu_torch.experiments import quickstart

    out = quickstart.run(["--steps", "1536", "--save-to", str(tmp_path)], device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["train_state.msgpack", "train_state.pt"]
    ts = out["state"].train_state
    assert ts.n_updates > 0
    jcore = JaxDQN(model=jq.FCStateQFunctionWithDiscreteAction(n_actions=2, n_hidden_channels=64, n_hidden_layers=2),
                   optimizer=optax.adam(1e-3), explorer=jexplorers.LinearDecayEpsilonGreedy(1.0, 0.05, 768, 2),
                   gamma=0.99)
    ring = jreplay.ReplayBuffer(1024, gamma=0.99, num_lanes=32)
    runner = JaxRunner(jenvs.TimeLimit(jenvs.CartPole(), 500), jcore, ring,
                       JaxConfig(num_envs=32, replay_start_size=1024, update_interval=32,
                                 target_update_interval=2048, minibatch_size=64))
    jstate = maybe_load_train_state(runner.init(jax.random.PRNGKey(0)), str(tmp_path))
    jts = np_tree(jstate.train_state)
    assert int(jts.n_updates) == ts.n_updates and int(jts.opt_state[0].count) == ts.opt_state.count
    for tree, module in ((jts.params, ts.model), (jts.target_params, ts.target_model)):
        arrays = convert.torch_arrays(module, tree)
        for name, p in module.named_parameters():
            assert arrays[name].dtype == np.float32 and np.array_equal(arrays[name], p.detach().numpy()), name
    for k in ("mu", "nu"):
        arrays = convert.torch_arrays(ts.model, getattr(jts.opt_state[0], k))
        for (name, _), t in zip(ts.model.named_parameters(), getattr(ts.opt_state, k)):
            assert np.array_equal(arrays[name], t.numpy()), (k, name)
    obs = np.random.RandomState(2).normal(size=(16, 4)).astype(np.float32)
    jq_values = np.asarray(jcore.model.apply(jstate.train_state.params, obs).q_values)
    tq_values = ts.model(torch.from_numpy(obs)).q_values.detach().numpy()
    np.testing.assert_allclose(tq_values, jq_values, atol=1e-5, rtol=0)
