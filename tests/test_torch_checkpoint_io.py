"""The port's reader of flax msgpack checkpoints
(``pfrl_tpu_torch/utils/flax_msgpack.py``) against flax's own, and the 26
``zoo/`` checkpoints converted through it against the same checkpoints
restored by the JAX package's ``load_state``.

(a) Every ``zoo/`` file: the same keys, dtypes, shapes and bytes as
    ``flax.serialization.msgpack_restore``.
(b) A chunked file (``MAX_CHUNK_SIZE`` patched small, so flax splits its
    arrays) and random nested trees (hypothesis) of float32, int32, uint8,
    bool, 0-d and empty leaves, numpy scalars, Python scalars, strings,
    complex numbers, an empty map and a bfloat16 leaf written by flax: to
    the bit.
(c) Each zoo entry read by the port and converted by the core's class
    (``convert.load_flax_checkpoint``, the core built by
    ``experiments/zoo.py``) equals the conversion the zoo tests make from
    the JAX package's ``load_state``: every tensor to the bit, every count.
(d) Loads that must raise: an unknown ext code, truncated and trailing
    bytes, a dtype numpy cannot name, a missing file, and a converted tree
    whose shapes or dtypes differ from the template's.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agent import CheckpointMismatchError, restore_saved, to_saved
from pfrl_tpu_torch.experiments import zoo
from pfrl_tpu_torch.utils import flax_msgpack

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(ROOT, "zoo")
FILES = sorted(os.path.relpath(p, ZOO) for p in glob.glob(os.path.join(ZOO, "*", "*", "best", "*.msgpack")))


def assert_same_tree(got, want, path="tree"):
    """``got`` (the port's reader) against ``want`` (flax's): the same
    structure, types, dtypes, shapes and bytes; a bfloat16 leaf (a torch
    tensor here, an ``ml_dtypes`` array in flax) by its bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    elif getattr(want, "dtype", None) is not None and str(want.dtype) == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).view(np.int16).tobytes(), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype and np.shape(got) == np.shape(want), path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), (path, got, want)


# ------------------------------------------------------------- (a) the zoo
def test_the_zoo_holds_26_checkpoints():
    assert len(FILES) == 26 and set(f.rsplit("/best/", 1)[0] for f in FILES) == set(zoo.ENTRIES)


@pytest.mark.parametrize("name", FILES)
def test_zoo_file_reads_as_flax_reads_it(name):
    data = open(os.path.join(ZOO, name), "rb").read()
    assert_same_tree(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))


# --------------------------------------------- (b) chunks and random trees
def test_chunked_arrays_are_joined(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(0)
    tree = {"big": rs.normal(size=(7, 13)).astype(np.float32), "ints": np.arange(100, dtype=np.int32),
            "small": np.ones(3, np.float32), "nested": {"u8": rs.randint(0, 256, 300).astype(np.uint8)}}
    data = serialization.msgpack_serialize(tree)
    raw = serialization.msgpack_restore.__globals__["msgpack"].unpackb(data, raw=False, strict_map_key=False)
    assert "__msgpack_chunked_array__" in raw["big"] and len(raw["big"]["chunks"]) > 1  # flax did chunk it
    got = flax_msgpack.msgpack_restore(data)
    assert_same_tree(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])


_DTYPES = (np.float32, np.int32, np.uint8, np.bool_)


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 4), min_size=0, max_size=3)))
    n = int(np.prod(shape, dtype=np.int64))
    seed = draw(st.integers(0, 2**31 - 1))
    values = np.random.RandomState(seed).normal(size=n) * 100
    return values.astype(dtype).reshape(shape)


_leaves = st.one_of(
    _arrays(),
    _arrays().map(lambda a: a.reshape(-1)[:1].reshape(()) if a.size else np.zeros((), a.dtype)),
    st.sampled_from(_DTYPES).map(lambda t: t(3)),  # numpy scalars (flax's ext 3)
    st.integers(-(2**63), 2**64 - 1),
    st.floats(allow_nan=True, allow_infinity=True),
    st.booleans(),
    st.none(),
    st.text(max_size=8),
    st.complex_numbers(allow_nan=False),
)
_trees = st.recursive(_leaves, lambda kids: st.dictionaries(st.text(min_size=1, max_size=6), kids, max_size=4),
                      max_leaves=12)


@settings(max_examples=60, deadline=None, database=None)
@given(tree=st.dictionaries(st.text(min_size=1, max_size=6), _trees, max_size=5), bf16_seed=st.integers(0, 100))
def test_random_trees_read_as_flax_reads_them(tree, bf16_seed):
    tree = dict(tree, empty={}, bf16=jnp.asarray(np.random.RandomState(bf16_seed).normal(size=(2, 3)), jnp.bfloat16))
    data = serialization.msgpack_serialize(tree)
    got, want = flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data)
    assert got["empty"] == {}
    assert_same_tree(got, want)


def test_an_empty_optax_state_survives_as_an_empty_node():
    import optax

    params = {"w": jnp.ones((2, 3))}
    opt_state = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)).init(params)
    tree = flax_msgpack.FlaxTree(flax_msgpack.msgpack_restore(serialization.to_bytes({"opt_state": opt_state})))
    assert dict(tree.opt_state[0]) == {}
    adam = tree.opt_state[1][0]
    assert int(adam.count) == 0 and adam.mu["w"].shape == (2, 3)


# ------------------------------------------- (c) conversion, all 26 entries
def _zoo_test_conversion(name):
    """``(core, train state)`` as the zoo tests convert ``name``: restored by
    ``pfrl_tpu.replay.persistent.load_state`` into the JAX core's template,
    then handed to the port's converter as a numpy tree."""
    alg, env = name.split("/")
    if name in ("dqn/cartpole", "c51/cartpole", "al/cartpole", "iqn/cartpole", "rainbow/cartpole"):
        from test_torch_zoo_value import checkpoint

        _, _, core, tstate = checkpoint(alg)
        return core, tstate
    if name in ("dqn_bf16/cartpole", "sac_bf16/pendulum"):
        from test_torch_zoo_precision import checkpoint

        _, _, core, tstate = checkpoint(name)
        return core, tstate
    if env == "pendulum" and alg in ("sac", "td3", "ddpg"):
        from test_torch_zoo_actor_critic import _jax_core, _port

        from pfrl_tpu.replay.persistent import load_state

        template = _jax_core(alg).init(jax.random.PRNGKey(0), jnp.zeros((1, 3)), jnp.zeros((1, 1)))
        runner, tstate = _port(alg, load_state(template, os.path.join(ZOO, name, "best", "train_state.msgpack")))
        return runner.core, tstate
    if name in ("ppo/pendulum", "trpo/pendulum", "a2c/cartpole", "ppo/hopper_real"):
        from test_torch_zoo_onpolicy import checkpoint

        out = checkpoint("hopper" if env == "hopper_real" else alg)
        return out[5], out[4]
    if env in ("po_abc", "delayed_cue"):
        from test_torch_zoo_recurrent import checkpoint

        out = checkpoint(name)
        return out[3], out[4]
    if alg.startswith("acer"):
        from test_torch_zoo_acer import checkpoint

        out = checkpoint(name)
        return out[3].core, out[5]
    from test_torch_zoo_host import actor_critic_checkpoint, checkpoint

    _, tagent = (actor_critic_checkpoint if name in ("sac/hopper_real", "td3/halfcheetah_real") else checkpoint)(name)
    return tagent.core, tagent.train_state


def _flat(tree, path="state"):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    return {path: tree}


@pytest.mark.parametrize("name", sorted(zoo.ENTRIES))
def test_zoo_entry_converts_through_the_ports_reader_as_through_jax(name):
    core, want = _zoo_test_conversion(name)
    got = convert.load_flax_checkpoint(core, zoo.checkpoint_path(name, ZOO), device="cpu")
    assert type(got) is type(want)
    g, w = _flat(to_saved(got)), _flat(to_saved(want))
    assert list(g) == list(w)
    tensors = 0
    for k in w:
        if isinstance(w[k], torch.Tensor):
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
            tensors += 1
        else:
            assert g[k] == w[k], k
    assert tensors >= 4 and got.n_updates == want.n_updates > 1
    # The registry's own core, built by the zoo module, takes the same state.
    core2, state2 = zoo.load(name, device="cpu", root=ZOO)
    assert type(core2) is type(core)
    for k, v in _flat(to_saved(state2)).items():
        assert (torch.equal(v, g[k]) if isinstance(v, torch.Tensor) else v == g[k]), k


@pytest.mark.parametrize("name", sorted(n for n, e in zoo.ENTRIES.items() if e.discrete))
def test_zoo_scores_are_what_the_greedy_actions_maximise(name):
    """``zoo.action_scores`` (the card check's tie margins) against
    ``zoo.greedy_actions`` on the entry's observations, the noisy Rainbow
    on the same draws."""
    from pfrl_tpu_torch.utils.draws import Draws

    core, state = zoo.load(name, device="cpu", root=ZOO)
    obs = torch.from_numpy(zoo.observations(name, 256, 26))
    actions = zoo.greedy_actions(core, state, obs, Draws(torch.Generator().manual_seed(3)))
    scores = zoo.action_scores(core, state, obs, Draws(torch.Generator().manual_seed(3)))
    assert scores.shape[0] == 256 and torch.equal(scores.argmax(-1), actions.long())
    top2 = torch.topk(scores.float(), 2, dim=-1).values
    assert int((top2[:, 0] - top2[:, 1] > 1e-3).sum()) >= 128  # most rows away from ties


# ------------------------------------------------------ (d) what must raise
def test_an_unknown_ext_code_raises():
    import msgpack

    data = msgpack.packb({"x": msgpack.ExtType(7, b"\x00\x01")}, use_bin_type=True)
    with pytest.raises(flax_msgpack.FlaxMsgpackError, match="ext type code 7"):
        flax_msgpack.msgpack_restore(data)


def test_truncated_and_trailing_bytes_raise():
    data = serialization.msgpack_serialize({"w": np.arange(10, dtype=np.float32)})
    with pytest.raises(flax_msgpack.FlaxMsgpackError, match="truncated"):
        flax_msgpack.msgpack_restore(data[:-3])
    with pytest.raises(flax_msgpack.FlaxMsgpackError, match="trailing"):
        flax_msgpack.msgpack_restore(data + b"\x00")


def test_a_dtype_numpy_cannot_name_raises():
    import msgpack

    payload = msgpack.packb(((2,), "float7_unknown", b"\x00\x00"), use_bin_type=True)
    data = msgpack.packb({"x": msgpack.ExtType(1, payload)}, use_bin_type=True)
    with pytest.raises(flax_msgpack.FlaxMsgpackError, match="float7_unknown"):
        flax_msgpack.msgpack_restore(data)


def test_a_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        flax_msgpack.load(str(tmp_path / "train_state.msgpack"))
    core = zoo.ENTRIES["dqn/cartpole"].build("cpu")
    with pytest.raises(FileNotFoundError):
        convert.load_flax_checkpoint(core, str(tmp_path / "none.msgpack"), device="cpu")


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_a_converted_state_that_does_not_fit_the_template_raises(change):
    core, state = zoo.load("dqn/cartpole", device="cpu", root=ZOO)
    saved = to_saved(state)
    w = saved["model"]["state_dict"]["mlp.layers.0.weight"]
    saved["model"]["state_dict"]["mlp.layers.0.weight"] = w[:, :-1] if change == "shape" else w.double()
    template = core.init(torch.Generator().manual_seed(0), torch.zeros(1, 4))
    before = template.model.mlp.layers[0].weight.detach().clone()
    with pytest.raises(CheckpointMismatchError, match="mlp.layers.0.weight"):
        restore_saved(template, saved)
    assert torch.equal(template.model.mlp.layers[0].weight, before)


def test_the_wrong_core_for_a_checkpoint_raises():
    core = zoo.ENTRIES["sac/pendulum"].build("cpu")
    with pytest.raises((AttributeError, KeyError, ValueError)):
        convert.load_flax_checkpoint(core, zoo.checkpoint_path("dqn/cartpole", ZOO), device="cpu")
