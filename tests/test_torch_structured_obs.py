"""Structured observations in the port against the JAX package: the upload
dtypes of every host shell (fault F3: ``jnp.asarray`` with x64 off makes
int64 -> int32 and float64 -> float32, the port kept both), ``batch_states``,
the uniform and prioritized rings over ``(image, steps)`` leaves (across a
wrap, with 3-step folding and without a stored ``next_obs``), strict
save/load of nested storage, and the bf16 cast of a structured ``obs``.

Inputs come from numpy seeds and go through both packages. Tolerances:
dtypes, ring contents, slots and the n-step fold exactly (the same float32
ops in the same order); priorities, the trees over them and IS weights
within ``rtol 1e-6`` (``pow`` may differ by an ulp, as in
``test_torch_replay.py``); the greedy actions exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict

from pfrl_tpu import explorers as jexplorers
from pfrl_tpu.agents import DQN as JaxDQN
from pfrl_tpu.agents.dqn import _collate_obs as jax_collate
from pfrl_tpu.q_functions import FCStateQFunctionWithDiscreteAction as JaxFCQ
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.utils import batch_states as jax_batch_states
from pfrl_tpu.utils.precision import cast_floating as jax_cast_floating
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import explorers as texplorers
from pfrl_tpu_torch.agent import CheckpointMismatchError
from pfrl_tpu_torch.agents import DQN
from pfrl_tpu_torch.agents.dqn import _collate_obs
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer, Transition
from pfrl_tpu_torch.replay.persistent import PersistentReplayBuffer, load_state, save_state
from pfrl_tpu_torch.utils.batch_states import batch_states, leaves, to_device_like_jax
from pfrl_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

IMAGE = (8, 8, 3)  # 192 float32 values: padded to 256 in both rings
TORCH_OF = {np.dtype(k): v for k, v in ((np.float32, torch.float32), (np.int32, torch.int32),
                                         (np.uint32, torch.uint32), (np.uint8, torch.uint8), (np.bool_, torch.bool),
                                         (np.float16, torch.float16), (np.int16, torch.int16))}


# ------------------------------------------------------------------- F3
@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.uint64, np.float32, np.int32, np.uint8, np.bool_,
                                   np.float16, np.int16])
def test_upload_gives_jnp_asarrays_dtype(dtype):
    x = (np.random.RandomState(0).uniform(0, 9, (3, 2))).astype(dtype)
    got = to_device_like_jax(x, "cpu")
    want = np.asarray(jnp.asarray(x))
    assert got.dtype == TORCH_OF[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_collated_image_and_steps_batch_uploads_as_jax():
    """The grasping example's observations: a float32 image and a python
    int, collated by both shells, uploaded by both."""
    rs = np.random.RandomState(1)
    batch = [(rs.uniform(size=IMAGE).astype(np.float32), int(rs.randint(9))) for _ in range(4)]
    got = to_device_like_jax(_collate_obs(batch), "cpu")
    want = jax.tree.map(jnp.asarray, jax_collate(batch))
    assert isinstance(got, tuple) and len(got) == 2
    assert [x.dtype for x in got] == [torch.float32, torch.int32]
    assert [np.asarray(x).dtype for x in want] == [np.float32, np.int32]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    f64 = rs.normal(size=(5, 4))
    assert to_device_like_jax(_collate_obs(f64), "cpu").dtype == torch.float32 == TORCH_OF[jnp.asarray(f64).dtype]


def test_dqn_acts_on_a_float64_env_as_the_jax_shell_does():
    """One greedy act on float64 observations: JAX uploads them as float32;
    the port's shell must too (before the repair it computed the forward in
    float64, the layers promoting to the input's dtype, and stored float64
    rows in the ring)."""
    jagent = JaxDQN(JaxFCQ(n_actions=3, n_hidden_channels=16, n_hidden_layers=1), optax.adam(1e-3),
                    JaxReplay(64), 0.9, jexplorers.ConstantEpsilonGreedy(0.0, 3), replay_start_size=16)
    jagent._ensure_init(np.zeros((1, 4), np.float32))
    tagent = DQN(FCStateQFunctionWithDiscreteAction(4, 3, 1, 16), Adam(1e-3), ReplayBuffer(64, device="cpu"), 0.9,
                 texplorers.ConstantEpsilonGreedy(0.0, 3), replay_start_size=16, device="cpu")
    convert.dqn_shell_from_flax(tagent, jax.tree.map(np.asarray, jagent.train_state))
    obs = np.random.RandomState(2).normal(size=(6, 4))  # float64, as a numpy env hands it
    assert obs.dtype == np.float64
    with jagent.eval_mode(), tagent.eval_mode():
        np.testing.assert_array_equal(tagent.batch_act(obs), np.asarray(jagent.batch_act(obs)))
    # Training: the act and the observe store float32 in the ring, as JAX does.
    tagent.batch_act(obs)
    tagent.batch_observe(obs, np.zeros(6), np.zeros(6, bool), np.zeros(6, bool))
    assert tagent.replay_state.storage["obs"].dtype == torch.float32
    assert tagent.replay_state.storage["next_obs"].dtype == torch.float32


def test_every_shell_uploads_through_the_jax_dtypes(monkeypatch):
    """The DQN shell (and its actor-learner half), REINFORCE, the
    actor-critic and on-policy shells upload through ``to_device_like_jax``."""
    import importlib

    calls = []
    for name in ("dqn", "reinforce", "ddpg", "ppo"):
        module = importlib.import_module(f"pfrl_tpu_torch.agents.{name}")
        real = module.to_device_like_jax
        monkeypatch.setattr(module, "to_device_like_jax",
                            lambda x, dev, real=real, name=name: calls.append(name) or real(x, dev))
        assert not hasattr(module, "to_device") and not hasattr(module, "host_batch")
    from pfrl_tpu_torch import agents, spaces
    from pfrl_tpu_torch.experiments.mujoco_actor_critic import MLPPolicy
    from pfrl_tpu_torch.experiments.onpolicy import GaussianPiV
    from pfrl_tpu_torch.experiments.reinforce_gym import make_reinforce_agent
    from pfrl_tpu_torch.explorers import AdditiveGaussian
    from pfrl_tpu_torch.policies import DeterministicHead
    from pfrl_tpu_torch.q_functions import FCSAQFunction

    obs = np.random.RandomState(3).normal(size=(2, 4))
    shells = {
        "dqn": DQN(FCStateQFunctionWithDiscreteAction(4, 2, 1, 8), Adam(1e-3), ReplayBuffer(16, device="cpu"), 0.9,
                   texplorers.ConstantEpsilonGreedy(0.0, 2), device="cpu"),
        "reinforce": make_reinforce_agent(obs_size=4, n_actions=2, device="cpu"),
        "ddpg": agents.DDPG(MLPPolicy(4, 1, (8,), DeterministicHead(), squash=torch.tanh), FCSAQFunction(4, 1, 8, 1),
                            Adam(1e-3), Adam(1e-3), ReplayBuffer(16, device="cpu"), 0.9, AdditiveGaussian(0.1),
                            action_space=spaces.box(-1.0, 1.0, (1,)), device="cpu"),
        "ppo": agents.PPO(GaussianPiV(4, 1, 8), Adam(1e-3), update_interval=4, minibatch_size=2, device="cpu"),
    }
    for name, shell in shells.items():
        calls.clear()
        actions = shell.batch_act(obs)
        shell.batch_observe(obs, np.zeros(2), np.zeros(2, bool), np.zeros(2, bool))
        assert np.isfinite(np.asarray(actions, np.float64)).all()
        assert name in calls, name


# --------------------------------------------------------------- batch_states
@pytest.mark.parametrize("kind", ["array", "tuple", "dict", "list"])
def test_batch_states_matches_jax(kind):
    rs = np.random.RandomState(4)

    def one():
        img = rs.uniform(size=IMAGE).astype(np.float32)
        if kind == "array":
            return img
        if kind == "tuple":
            return (img, int(rs.randint(9)))
        if kind == "dict":
            return {"image": img, "steps": int(rs.randint(9)), "x": float(rs.normal())}
        return [img, np.int64(rs.randint(9))]

    states = [one() for _ in range(5)]
    phi = lambda s: s if kind == "array" else s  # noqa: E731
    got, want = batch_states(states, phi), jax_batch_states(states, phi)
    got_leaves, want_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(got_leaves, want_leaves):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    scaled = batch_states(states[:2], lambda s: s * 2 if kind == "array" else s)
    assert np.asarray(jax.tree.leaves(scaled)[0]).shape[0] == 2


# -------------------------------------------------------------------- rings
def _steps(seed, lanes, n, p_done=0.25):
    """``n`` per-lane transitions with ``(image, steps)`` observations."""
    rs = np.random.RandomState(seed)
    out = []
    t = np.zeros(lanes, np.int64)
    for _ in range(n):
        done = rs.uniform(size=lanes) < p_done
        obs = (rs.uniform(size=(lanes, *IMAGE)).astype(np.float32), t.astype(np.int32))
        t = np.where(done, 0, t + 1)
        out.append(dict(
            obs=obs,
            action=rs.randint(0, 10, lanes).astype(np.int32),
            reward=rs.normal(size=lanes).astype(np.float32),
            next_obs=(rs.uniform(size=(lanes, *IMAGE)).astype(np.float32), t.astype(np.int32)),
            terminated=done & (rs.uniform(size=lanes) < 0.5),
            done=done,
        ))
    return out


def _jax_tr(d):
    return JaxTransition(**{k: jax.tree.map(jnp.asarray, v) for k, v in d.items()}, extras=FrozenDict())


def _torch_tr(d):
    return Transition(**{k: jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), v) for k, v in d.items()})


def _example(d):
    return jax.tree.map(lambda x: x[0], d)


def _fill(jbuf, tbuf, steps):
    js = jbuf.init(_jax_tr(_example(steps[0])))
    ts = tbuf.init(_torch_tr(_example(steps[0])))
    for d in steps:
        js = jbuf.add(js, _jax_tr(d))
        ts = tbuf.add(ts, _torch_tr(d))
    return js, ts


def _assert_storage_equal(ts, js):
    for name, s in ts.storage.items():
        want = jax.tree.leaves(getattr(js.storage, name))
        got = leaves(s)
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            assert a.shape == b.shape and str(a.dtype).split(".")[-1] == str(b.dtype), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _assert_batches_equal(tb, jb):
    for name in ("obs", "action", "reward", "next_obs", "discount", "is_terminal"):
        got, want = jax.tree.leaves(getattr(tb, name)), jax.tree.leaves(getattr(jb, name))
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("num_steps", [1, 3])
@pytest.mark.parametrize("store_next_obs", [True, False])
def test_uniform_ring_of_image_and_steps_leaves_matches_jax(num_steps, store_next_obs):
    lanes, cap = 3, 24
    kw = dict(num_steps=num_steps, gamma=0.9, num_lanes=lanes, store_next_obs=store_next_obs)
    jbuf, tbuf = JaxReplay(cap, **kw), ReplayBuffer(cap, device="cpu", **kw)
    js, ts = _fill(jbuf, tbuf, _steps(num_steps, lanes, 13))  # wraps the ring
    image, steps = ts.storage["obs"]
    assert image.shape == (cap, 256) and image.dtype == torch.float32  # 192 padded to 256
    assert steps.shape == (cap,) and steps.dtype == torch.int32
    assert ("next_obs" in ts.storage) == store_next_obs
    assert ts.item_shapes["obs"] == (IMAGE, ())
    _assert_storage_equal(ts, js)
    lo, hi = (int(x) for x in tbuf._sampleable_range(ts))
    ids = np.arange(lo, hi, dtype=np.int32)  # every sampleable item
    tb, jb = tbuf.gather(ts, torch.from_numpy(ids)), jbuf.gather(js, jnp.asarray(ids))
    assert isinstance(tb.obs, tuple) and tb.obs[0].shape == (len(ids), *IMAGE) and tb.obs[1].dtype == torch.int32
    _assert_batches_equal(tb, jb)


def test_a_dict_observation_is_stored_leaf_by_leaf():
    rs = np.random.RandomState(5)
    buf = ReplayBuffer(8, num_lanes=2, device="cpu")

    def tr():
        return Transition(obs={"a": torch.from_numpy(rs.normal(size=(2, 130)).astype(np.float32)),
                               "b": torch.from_numpy(rs.randint(0, 5, (2, 2)).astype(np.int32))},
                          action=torch.zeros(2, dtype=torch.int32), reward=torch.zeros(2),
                          next_obs={"a": torch.zeros(2, 130), "b": torch.zeros(2, 2, dtype=torch.int32)},
                          terminated=torch.zeros(2, dtype=torch.bool), done=torch.zeros(2, dtype=torch.bool))

    first = tr()
    state = buf.init(Transition(**{k: jax.tree.map(lambda x: x[0], v) for k, v in vars(first).items()
                                   if k != "extras"}))
    assert state.storage["obs"]["a"].shape == (8, 256) and state.storage["obs"]["b"].shape == (8, 2)
    buf.add(state, first)
    got = buf.gather(state, torch.tensor([0, 1], dtype=torch.int32))
    for k in ("a", "b"):
        assert torch.equal(got.obs[k], first.obs[k])


@pytest.mark.parametrize("num_steps,store_next_obs", [(1, True), (3, False)])
def test_per_over_image_and_steps_leaves_matches_jax(num_steps, store_next_obs):
    """PER counts its lanes from the first leaf; the add through the aging
    window, the sampled slots, IS weights and the gathered leaves match the
    JAX buffer's (its XLA tree descent) across a wrap."""
    from test_torch_replay import FixedDraws

    lanes, cap, batch = 2, 16, 8
    kw = dict(alpha=0.6, beta0=0.4, betasteps=50, num_steps=num_steps, gamma=0.99, num_lanes=lanes,
              store_next_obs=store_next_obs)
    jbuf, tbuf = JaxPER(cap, **kw), PrioritizedReplayBuffer(cap, device="cpu", **kw)
    steps = _steps(7, lanes, 26, p_done=0.35)
    js, ts = _fill(jbuf, tbuf, steps[:12])
    rs = np.random.RandomState(8)
    for k, d in enumerate(steps[12:]):  # wraps the ring
        key = jax.random.PRNGKey(30 + k)
        jb, js = jbuf.sample(js, key, batch)
        tb, ts = tbuf.sample(ts, FixedDraws(np.asarray(jax.random.uniform(key, (batch,)))), batch)
        np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
        np.testing.assert_allclose(tb.weight.numpy(), np.asarray(jb.weight), rtol=1e-6)
        _assert_batches_equal(tb, jb)
        fb = rs.uniform(0.0, 1.2, batch).astype(np.float32)
        uniq = np.unique(np.asarray(jb.indices), return_index=True)[1]  # C6
        js = jbuf.update_priorities(js, jb.indices[uniq], jnp.asarray(fb[uniq]))
        ts = tbuf.update_priorities(ts, tb.indices[uniq], torch.from_numpy(fb[uniq]))
        js, ts = jbuf.add(js, _jax_tr(d)), tbuf.add(ts, _torch_tr(d))
        np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js.tree), rtol=1e-6)
        np.testing.assert_allclose(ts.min_tree.numpy(), np.asarray(js.min_tree), rtol=1e-6)
        assert int(ts.cursor) == int(js.cursor)
    _assert_storage_equal(ts.base, js.base)


# -------------------------------------------------------------- persistence
def _nested_state(cap=16):
    buf = PrioritizedReplayBuffer(cap, num_lanes=2, num_steps=3, device="cpu")
    steps = _steps(9, 2, 11)
    state = buf.init(_torch_tr(_example(steps[0])))
    for d in steps:
        buf.add(state, _torch_tr(d))
    return buf, state, steps


def test_nested_storage_comes_back_bit_for_bit(tmp_path):
    buf, state, steps = _nested_state()
    path = str(tmp_path / "per.pt")
    save_state(state, path)
    template = buf.init(_torch_tr(_example(steps[0])))
    restored = load_state(template, path)
    assert restored is template
    for a, b in zip(leaves(restored.base.storage), leaves(state.base.storage)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert restored.base.item_shapes == state.base.item_shapes
    assert torch.equal(restored.tree, state.tree) and int(restored.base.cursor) == int(state.base.cursor)


@pytest.mark.parametrize("change", ["steps dtype", "image shape", "leaves swapped", "one leaf"])
def test_nested_storage_is_strict_against_its_template(tmp_path, change):
    """A leaf of another dtype, shape or position raises
    ``CheckpointMismatchError`` naming it."""
    buf, state, steps = _nested_state()
    path = str(tmp_path / "per.pt")
    save_state(state, path)
    ex = _example(steps[0])
    if change == "steps dtype":
        ex["obs"] = (ex["obs"][0], ex["obs"][1].astype(np.int64))
        where = "['obs'][1]"
    elif change == "image shape":
        ex["obs"] = (np.zeros((8, 8, 4), np.float32), ex["obs"][1])
        where = "['obs'][0]"
    elif change == "leaves swapped":
        ex["obs"] = (ex["obs"][1], ex["obs"][0])
        where = "['obs'][0]"
    else:
        ex["obs"] = (ex["obs"][0],)
        where = "['obs']"
    template = buf.init(_torch_tr(ex))
    with pytest.raises(CheckpointMismatchError, match=__import__("re").escape(where)):
        load_state(template, path)


def test_a_persistent_buffer_restores_nested_storage(tmp_path):
    buf = PersistentReplayBuffer(str(tmp_path / "replay"), 16, snapshot_interval=5, num_lanes=2, device="cpu")
    steps = _steps(10, 2, 5)
    state = buf.init(_torch_tr(_example(steps[0])))
    for d in steps:
        state = buf.add(state, _torch_tr(d))
    restored = buf.restore(_torch_tr(_example(steps[0])))
    for a, b in zip(leaves(restored.storage), leaves(state.storage)):
        assert torch.equal(a, b)
    assert int(restored.cursor) == 10


# --------------------------------------------------------------------- bf16
def test_bf16_casts_only_the_floating_leaves_of_a_structured_obs():
    rs = np.random.RandomState(11)
    obs = (rs.uniform(size=(2, *IMAGE)).astype(np.float32), np.array([3, 7], np.int32))
    got = cast_floating(to_device_like_jax(obs, "cpu"), torch.bfloat16)
    want = jax_cast_floating(jax.tree.map(jnp.asarray, obs), jnp.bfloat16)
    assert [x.dtype for x in got] == [torch.bfloat16, torch.int32]
    assert [str(x.dtype) for x in want] == ["bfloat16", "int32"]
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
