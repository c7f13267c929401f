"""Replay of the port against the JAX package: the uniform ring (insert,
n-step gather, dequantize), the sum and min trees, and prioritized replay
(aging window, priority feedback, sampling and IS weights).

Inputs come from numpy seeds and go through both packages. Tolerances:
ring contents, slots, the trees' own arithmetic and the n-step fold are
exact (the same float32 ops in the same order); priorities, the trees over
them and IS weights ``rtol 1e-6`` (``pow`` may differ by an ulp between the
two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict

from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.replay import sum_tree as jax_tree
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer, Transition
from pfrl_tpu_torch.replay import sum_tree

torch.set_num_threads(1)

OBS = (8, 8, 3)  # 192 uint8 values: padded to 256 in both rings


class FixedDraws:
    """A draw source that returns given uniforms, as ``Draws`` would."""

    def __init__(self, *uniforms):
        self.queue = list(uniforms)

    def uniform(self, n):
        u = self.queue.pop(0)
        assert u.shape == (n,)
        return torch.from_numpy(np.array(u, np.float32))


def _steps(seed, lanes, n, p_done=0.2):
    """``n`` per-lane transitions as numpy dicts, with random boundaries."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        done = rs.uniform(size=lanes) < p_done
        out.append(dict(
            obs=rs.randint(0, 256, (lanes, *OBS)).astype(np.uint8),
            action=rs.randint(0, 6, lanes).astype(np.int32),
            reward=rs.normal(size=lanes).astype(np.float32),
            next_obs=rs.randint(0, 256, (lanes, *OBS)).astype(np.uint8),
            terminated=done & (rs.uniform(size=lanes) < 0.5),
            done=done,
        ))
    return out


def _jax_tr(d):
    return JaxTransition(**{k: jnp.asarray(v) for k, v in d.items()}, extras=FrozenDict())


def _torch_tr(d):
    return Transition(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})


def _example(d):
    return {k: v[0] for k, v in d.items()}


def _fill(jbuf, tbuf, steps):
    js = jbuf.init(_jax_tr(_example(steps[0])))
    ts = tbuf.init(_torch_tr(_example(steps[0])))
    for d in steps:
        js = jbuf.add(js, _jax_tr(d))
        ts = tbuf.add(ts, _torch_tr(d))
    return js, ts


def _assert_batches_equal(tb, jb):
    for name in ("obs", "action", "reward", "next_obs", "discount", "is_terminal"):
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert got.shape == want.shape, name
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# --------------------------------------------------------------------- uniform
@pytest.mark.parametrize("num_steps", [1, 3])
@pytest.mark.parametrize("store_next_obs", [True, False])
def test_uniform_add_and_gather_match_jax(num_steps, store_next_obs):
    lanes, cap = 3, 24
    kw = dict(num_steps=num_steps, gamma=0.9, num_lanes=lanes,
              store_next_obs=store_next_obs, fused_dequant_scale=1.0 / 255.0)
    jbuf, tbuf = JaxReplay(cap, **kw), ReplayBuffer(cap, device="cpu", **kw)
    js, ts = _fill(jbuf, tbuf, _steps(num_steps, lanes, 13))  # wraps the ring

    assert ts.cursor.dtype == torch.int32
    assert int(ts.cursor) == int(js.cursor) == 39
    for name, s in ts.storage.items():
        np.testing.assert_array_equal(s.numpy(), np.asarray(getattr(js.storage, name)))

    lo, hi = (int(x) for x in tbuf._sampleable_range(ts))
    assert (lo, hi) == tuple(int(x) for x in jbuf._sampleable_range(js))
    ids = np.arange(lo, hi, dtype=np.int32)  # every sampleable item
    tb = tbuf.gather(ts, torch.from_numpy(ids))
    jb = jbuf.gather(js, jnp.asarray(ids))
    assert tb.obs.dtype == torch.float32  # dequantized in the gather
    _assert_batches_equal(tb, jb)


def test_uniform_gather_without_dequant_keeps_uint8():
    kw = dict(num_lanes=2, store_next_obs=False)
    jbuf, tbuf = JaxReplay(8, **kw), ReplayBuffer(8, device="cpu", **kw)
    js, ts = _fill(jbuf, tbuf, _steps(5, 2, 3))
    ids = np.array([0, 1, 3], np.int32)
    tb, jb = tbuf.gather(ts, torch.from_numpy(ids)), jbuf.gather(js, jnp.asarray(ids))
    assert tb.obs.dtype == torch.uint8
    _assert_batches_equal(tb, jb)


# ------------------------------------------------------------------- sum tree
def test_sum_and_min_tree_updates_match_jax():
    rs = np.random.RandomState(0)
    cap = 64
    jt, jm = jax_tree.init_tree(cap), jax_tree.init_min_tree(cap)
    tt, tm = sum_tree.init_tree(cap), sum_tree.init_min_tree(cap)
    for _ in range(5):
        idx = rs.choice(cap, 17, replace=False).astype(np.int32)  # unique (C6)
        val = rs.uniform(0.0, 2.0, 17).astype(np.float32)
        jt = jax_tree.update(jt, jnp.asarray(idx), jnp.asarray(val))
        jm = jax_tree.update_min(jm, jnp.asarray(idx), jnp.asarray(val))
        sum_tree.update(tt, torch.from_numpy(idx), torch.from_numpy(val))
        sum_tree.update_min(tm, torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert float(sum_tree.total(tt)) == float(jax_tree.total(jt))
    assert float(sum_tree.min_value(tm)) == float(jax_tree.min_value(jm))

    targets = rs.uniform(0.0, float(jax_tree.total(jt)), 40).astype(np.float32)
    np.testing.assert_array_equal(
        sum_tree.sample_from_prefix(tt, torch.from_numpy(targets)).numpy(),
        np.asarray(jax_tree.sample_from_prefix(jt, jnp.asarray(targets))),
    )


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_stratified_targets_match_jax_with_the_same_u(batch):
    key = jax.random.PRNGKey(batch)
    total = jnp.float32(37.25)
    want = jax_tree.stratified_targets(total, key, batch)
    u = np.array(jax.random.uniform(key, (batch,)))  # the JAX function's draw
    got = sum_tree.stratified_targets(torch.tensor(37.25), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # u == 1 is guarded below the total, as in the JAX function.
    edge = sum_tree.stratified_targets(torch.tensor(5.0), torch.ones(batch))
    assert float(edge.max()) < 5.0


# ---------------------------------------------------------------- prioritized
def _per_pair(cap, lanes, num_steps, normalize_by_max, store_next_obs=False):
    kw = dict(alpha=0.6, beta0=0.4, betasteps=50, normalize_by_max=normalize_by_max,
              num_steps=num_steps, gamma=0.99, num_lanes=lanes,
              store_next_obs=store_next_obs, fused_dequant_scale=1.0 / 255.0)
    # use_pallas=True: the JAX buffer finds slots with its Pallas kernel
    # (interpret mode here) where the tree is a multiple of 8192 leaves,
    # with the tree descent elsewhere.
    return JaxPER(cap, use_pallas=True, **kw), PrioritizedReplayBuffer(cap, device="cpu", **kw)


def _assert_per_states_equal(ts, js):
    # Priorities are (e + eps) ** alpha: pow may differ by an ulp.
    np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js.tree), rtol=1e-6)
    np.testing.assert_allclose(ts.min_tree.numpy(), np.asarray(js.min_tree), rtol=1e-6)
    np.testing.assert_allclose(float(ts.max_priority), float(js.max_priority), rtol=1e-6)
    assert float(ts.beta) == float(js.beta)
    assert int(ts.cursor) == int(js.cursor)


@pytest.mark.parametrize("num_steps,store_next_obs", [(1, False), (3, False), (1, True)])
def test_per_add_through_aging_window_matches_jax(num_steps, store_next_obs):
    lanes, cap = 2, 16
    jbuf, tbuf = _per_pair(cap, lanes, num_steps, "batch", store_next_obs)
    js = jbuf.init(_jax_tr(_example(_steps(0, lanes, 1)[0])))
    ts = tbuf.init(_torch_tr(_example(_steps(0, lanes, 1)[0])))
    rs = np.random.RandomState(1)
    for i, d in enumerate(_steps(num_steps, lanes, 14)):  # wraps the ring
        js, ts = jbuf.add(js, _jax_tr(d)), tbuf.add(ts, _torch_tr(d))
        _assert_per_states_equal(ts, js)
        if i % 3 == 2:  # feedback on unique written slots raises max_priority
            slots = rs.choice(min(2 * (i + 1), cap), 3, replace=False).astype(np.int32)
            err = rs.uniform(0.0, 1.5, 3).astype(np.float32)
            js = jbuf.update_priorities(js, jnp.asarray(slots), jnp.asarray(err))
            ts = tbuf.update_priorities(ts, torch.from_numpy(slots), torch.from_numpy(err))
            _assert_per_states_equal(ts, js)


@pytest.mark.parametrize("normalize_by_max", ["batch", "memory", False])
@pytest.mark.parametrize("cap", [16, 4100])  # tree of 16 leaves / of 8192 (Pallas)
def test_per_sample_matches_jax(normalize_by_max, cap):
    lanes, batch = 2, 8
    jbuf, tbuf = _per_pair(cap, lanes, 1, normalize_by_max)
    js, ts = _fill(jbuf, tbuf, _steps(2, lanes, 12))
    rs = np.random.RandomState(3)
    cursor = int(ts.cursor)  # the newest stride of lanes is held out
    slots = (np.arange(max(0, cursor - cap), cursor - lanes) % cap).astype(np.int32)
    err = rs.uniform(0.0, 1.2, slots.shape[0]).astype(np.float32)
    js = jbuf.update_priorities(js, jnp.asarray(slots), jnp.asarray(err))
    ts = tbuf.update_priorities(ts, torch.from_numpy(slots), torch.from_numpy(err))

    for k in range(3):
        key = jax.random.PRNGKey(10 + k)
        u = np.array(jax.random.uniform(key, (batch,)))  # what JAX sample draws
        jb, js = jbuf.sample(js, key, batch)
        tb, ts = tbuf.sample(ts, FixedDraws(u), batch)
        np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
        np.testing.assert_allclose(tb.weight.numpy(), np.asarray(jb.weight), rtol=1e-6)
        _assert_batches_equal(tb, jb)
        np.testing.assert_allclose(float(ts.beta), float(js.beta), rtol=1e-7)
        fb = rs.uniform(0.0, 1.2, batch).astype(np.float32)
        uniq = np.unique(np.asarray(jb.indices), return_index=True)[1]  # C6
        js = jbuf.update_priorities(js, jb.indices[uniq], jnp.asarray(fb[uniq]))
        ts = tbuf.update_priorities(ts, tb.indices[uniq], torch.from_numpy(fb[uniq]))
        _assert_per_states_equal(ts, js)


def test_per_sample_after_wrap_maps_slots_to_live_ids():
    lanes, cap, batch = 2, 16, 16
    jbuf, tbuf = _per_pair(cap, lanes, 3, "memory")
    js, ts = _fill(jbuf, tbuf, _steps(4, lanes, 19))  # cursor 38: wrapped twice
    key = jax.random.PRNGKey(0)
    jb, js = jbuf.sample(js, key, batch)
    tb, ts = tbuf.sample(ts, FixedDraws(np.asarray(jax.random.uniform(key, (batch,)))), batch)
    np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
    np.testing.assert_allclose(tb.weight.numpy(), np.asarray(jb.weight), rtol=1e-6)
    _assert_batches_equal(tb, jb)


@pytest.mark.parametrize("cap", [24, 4100])  # tree of 32 leaves / of 8192 (Pallas)
def test_per_three_step_sampling_matches_jax_across_episode_ends(cap):
    """3-step returns read by adjacency under PER, as Rainbow runs it:
    episodes end inside the window, adds age slots in between samples."""
    lanes, batch, gamma = 2, 16, 0.99
    jbuf, tbuf = _per_pair(cap, lanes, 3, "batch")
    assert not tbuf.store_next_obs and tbuf.num_steps == 3
    steps = _steps(6, lanes, 30, p_done=0.35)
    js, ts = _fill(jbuf, tbuf, steps[:14])
    rs = np.random.RandomState(7)
    seen = {"cut": 0, "full": 0, "terminal": 0}
    for k, d in enumerate(steps[14:]):
        key = jax.random.PRNGKey(20 + k)
        jb, js = jbuf.sample(js, key, batch)
        tb, ts = tbuf.sample(ts, FixedDraws(np.asarray(jax.random.uniform(key, (batch,)))), batch)
        np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
        np.testing.assert_allclose(tb.weight.numpy(), np.asarray(jb.weight), rtol=1e-6)
        _assert_batches_equal(tb, jb)
        full = np.isclose(tb.discount.numpy(), gamma**3)
        seen["full"] += int(full.sum())
        seen["cut"] += int((~full).sum())
        seen["terminal"] += int(tb.is_terminal.sum())
        fb = rs.uniform(0.0, 1.2, batch).astype(np.float32)
        uniq = np.unique(np.asarray(jb.indices), return_index=True)[1]  # C6
        js = jbuf.update_priorities(js, jb.indices[uniq], jnp.asarray(fb[uniq]))
        ts = tbuf.update_priorities(ts, tb.indices[uniq], torch.from_numpy(fb[uniq]))
        js, ts = jbuf.add(js, _jax_tr(d)), tbuf.add(ts, _torch_tr(d))
        _assert_per_states_equal(ts, js)
    assert min(seen.values()) > 0, seen  # windows cut short, whole, and terminal ones


def test_priority_from_errors_matches_jax():
    jbuf, tbuf = _per_pair(16, 2, 1, "batch")
    e = np.array([-1.0, 0.0, 0.3, 1.0, 4.0], np.float32)
    np.testing.assert_allclose(
        tbuf.priority_from_errors(torch.from_numpy(e)).numpy(),
        np.asarray(jbuf.priority_from_errors(jnp.asarray(e))),
        rtol=1e-6,
    )


def test_per_rejects_bad_normalize_by_max():
    with pytest.raises(ValueError):
        PrioritizedReplayBuffer(16, normalize_by_max="bogus", device="cpu")
