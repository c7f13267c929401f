"""The port's Atari pipeline's device functions against the JAX package's
(``pfrl_tpu/parallel/atari_pipeline.py``), on a JAX pipeline built with
``_build_jits()`` and ``_init_device_state()`` and never started.

Two cores: the JAX pipeline test's ``TinyQ`` with Adam(1e-3), and
``train_dqn_pipeline_ale.py``'s own ``NatureQ`` with RMSprop(2.5e-4, decay
0.95, eps 1e-2) and a summed loss (the port's
``experiments/atari_pipeline.make_pipeline_core``); both start from the
same weights (the JAX state, converted). 2 workers x 2 lanes, a ring of 256
rows, batch 8, target syncs every 12 transitions of updates.

- ``act_stage``: the stack rolls and resets exactly, the staged planes and
  actions are exact; the explorer's draws are the port's, handed to JAX by
  value (``install_tape`` under ``jax.disable_jit``), and the greedy actions
  are also compared at ``training=False``.
- ``commit``: exact, across a wrap of the ring.
- ``sample``: given JAX's ids, obs, next_obs, actions, rewards, terminals,
  discounts and weights are exact; the JAX window tests are repeated for
  the port's own id draw.
- ``learner_burst`` with n = 4: JAX's per-iteration ids, replayed from its
  ``split(r, 3)`` chain, handed to the port by value; every parameter and
  target parameter within 3e-6 (ROADMAP C22: three Adam or RMSprop steps
  amplify rounding to that) or, where more, 4x what an ulp nudge of the
  port's own weights moves it (:func:`assert_within_nudges`; only the tiny
  net's Adam steps need it), optimizer moments within 1e-5 of their
  largest, the losses within 1e-5 relative, and the target sync on the
  same crossing.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from test_torch_pipeline_run import TinyQ, make_core
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu.agents import DQNCore as JaxDQNCore
from pfrl_tpu.explorers import LinearDecayEpsilonGreedy as JaxLinearDecay
from pfrl_tpu.models import LargeAtariCNN as JaxLargeAtariCNN
from pfrl_tpu.parallel.atari_pipeline import AtariActorLearnerPipeline as JaxPipeline
from pfrl_tpu.q_functions import DiscreteActionValueHead as JaxHead
from pfrl_tpu.utils import atari_phi as jax_atari_phi
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.experiments.atari_pipeline import make_pipeline_core
from pfrl_tpu_torch.parallel.atari_pipeline import AtariActorLearnerPipeline
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

SIZES = dict(n_workers=2, lanes_per_worker=2, capacity=256, minibatch_size=8, update_interval=4,
             target_update_interval=12, replay_start_size=64, burst=4, slot_ring=3, seed=0)
HW = 84 * 84


class JaxTinyQ(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = x.reshape(x.shape[0], -1)
        h = nn.relu(nn.Dense(32)(x))
        return JaxHead()(nn.Dense(4)(h))


class JaxNatureQ(nn.Module):
    """``train_dqn_pipeline_ale.py``'s ``NatureQ``."""

    @nn.compact
    def __call__(self, x):
        return JaxHead()(nn.Dense(6)(JaxLargeAtariCNN()(x)))


def _cores(kind):
    if kind == "tiny-adam":
        jcore = JaxDQNCore(model=JaxTinyQ(), optimizer=optax.adam(1e-3),
                           explorer=JaxLinearDecay(1.0, 0.1, 10_000, 4), gamma=0.9, phi=jax_atari_phi)
        return jcore, make_core(), 3_000
    jcore = JaxDQNCore(model=JaxNatureQ(), optimizer=optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2),
                       explorer=JaxLinearDecay(1.0, 0.1, 10**6, 6), gamma=0.99, batch_accumulator="sum",
                       phi=jax_atari_phi)
    return jcore, make_pipeline_core(6), 600_000


@pytest.fixture(scope="module", params=["tiny-adam", "nature-rmsprop"])
def pipelines(request):
    """(JAX pipeline, port pipeline, kind, t for the explorer), the port's
    train state the JAX one converted; the target apart from the online net."""
    jcore, tcore, t = _cores(request.param)
    jp = JaxPipeline(core=jcore, env_factory=None, **SIZES)
    jp._build_jits()
    jp._init_device_state(jax.random.PRNGKey(0))
    example = jnp.zeros((1, 84, 84, 4), jnp.uint8)
    jp.train_state = jp.train_state.replace(target_params=jcore.init(jax.random.PRNGKey(1), example).params)
    tp = AtariActorLearnerPipeline(core=tcore, env_factory=None, device="cpu", **SIZES)
    tp._init_device_state(0)
    ts = jp.train_state
    tp.set_train_state(convert.dqn_state_from_flax(tcore, np_tree(ts.params), np_tree(ts.target_params),
                                                   np_tree(ts.opt_state), device="cpu"))
    return jp, tp, request.param, t


class Given:
    """A draw source that hands out given integers: ``randint(high, n)``
    checks the bound and returns the next ``n``."""

    def __init__(self, values, high):
        self.values, self.high = np.asarray(values, np.int32), high

    def randint(self, high, n):
        assert high == self.high, (high, self.high)
        out, self.values = self.values[:n], self.values[n:]
        return torch.from_numpy(out.copy())


def _t(x):
    return torch.from_numpy(np.array(x))


NUDGES = (1.0 + 2.0**-23, 1.0 - 2.0**-23)


def assert_within_nudges(module, flax_tree, nudged_modules, what):
    """Each tensor within 3e-6 (C22), or within 4x the larger of what
    1 + 2**-23 and 1 - 2**-23 nudges of the port's own starting weights
    move it where that is more: Adam's first steps divide each gradient by
    its own root mean square, so where a gradient is a near-cancelling sum
    its rounding moves the step by up to the learning rate (C48's rule; in
    the tiny net's 28,224-input layer a few elements move by 2e-5 under a
    nudge and by 7e-5 between the packages)."""
    want = convert.torch_arrays(module, np_tree(flax_tree))
    others = [dict(m.named_parameters()) for m in nudged_modules]
    for name, x in module.named_parameters():
        got = x.detach().numpy()
        nudge = max(float(np.abs(got - o[name].detach().numpy()).max()) for o in others)
        bound = max(3e-6, 4 * nudge)
        diff = float(np.abs(got - want[name]).max())
        assert diff <= bound, f"{what} {name}: {diff} > {bound} (nudges move it {nudge})"


def _window(p, cursor):
    L, k = p.L, p.stack_k
    lo = max((k - 1) * L, cursor - p.capacity + (p.R + k + 1) * L)
    return lo, cursor - L


# ------------------------------------------------------------------ act stage
def test_act_stage_rolls_resets_stages_and_acts_like_jax(pipelines):
    jp, tp, kind, t0 = pipelines
    K, L = tp.K, tp.L
    rs = np.random.RandomState(1)
    stack, ring = jp.stack, jp.ring
    tstack, tring = tp.stack.clone(), tp.ring
    for step in range(6):
        for worker in range(tp.n_workers):
            planes = rs.randint(0, 256, (K, HW)).astype(np.uint8)
            prev_done = np.ones(K, bool) if step == 0 else rs.uniform(size=K) < 0.3
            lane_off, row_base, t = worker * K, step * L + worker * K, t0 + step * L
            tape = Tape(100 * step + worker)
            got = tp.act_stage(tp._acting, tstack, tring, _t(planes), _t(prev_done), lane_off, row_base, t, tape)
            assert [k for k, _ in tape.log] == ["uniform", "randint"]
            with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
                install_tape(mp, tape)
                want, stack, ring = jp._jit_act_stage(
                    jp.train_state, stack, ring, jnp.asarray(planes), jnp.asarray(prev_done), np.int32(lane_off),
                    np.int32(row_base), np.int32(t), np.int32(row_base))
            assert not tape.log
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(tstack.numpy(), np.asarray(stack))
            # Greedy actions at training=False, from the same stacks.
            sub = slice(lane_off, lane_off + K)
            greedy = tp.core.select_action(tp._acting, None, tstack[sub], t, False)
            jgreedy = jp.core.select_action(jp.train_state, jax.random.PRNGKey(0), stack[sub], jnp.int32(t), False)
            np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    np.testing.assert_array_equal(tring.planes.numpy(), np.asarray(ring.planes))
    np.testing.assert_array_equal(tring.action.numpy(), np.asarray(ring.action))
    # A reset lane is its plane four times; a rolled one holds the last four.
    assert tstack.dtype == torch.uint8 and tstack.shape == (L, 84, 84, 4)
    assert tring.commit_cursor == 0  # staging never commits


# -------------------------------------------------------------------- commit
def test_commit_matches_jax_across_a_wrap(pipelines):
    jp, tp, _, _ = pipelines
    L = tp.L
    rs = np.random.RandomState(2)
    ring = jp.ring
    tring = type(tp.ring)(**{k: (v.clone() if torch.is_tensor(v) else 0) for k, v in vars(tp.ring).items()})
    for _ in range(tp.capacity // L + 6):  # wraps the ring
        rew = rs.normal(size=L).astype(np.float32)
        term = rs.uniform(size=L) < 0.2
        done = term | (rs.uniform(size=L) < 0.1)
        tp.commit(tring, _t(rew), _t(term), _t(done))
        ring = jp._jit_commit(ring, jnp.asarray(rew), jnp.asarray(term), jnp.asarray(done))
    assert tring.commit_cursor == int(ring.commit_cursor) == tp.capacity + 6 * L
    for name in ("reward", "terminated", "done"):
        np.testing.assert_array_equal(getattr(tring, name).numpy(), np.asarray(getattr(ring, name)), err_msg=name)


# -------------------------------------------------------------------- sample
def _filled(jp, tp, cursor, seed):
    """The JAX test's ring (random planes, episode boundaries), as a JAX ring
    and as the port's."""
    L, cap = tp.L, tp.capacity
    rs = np.random.RandomState(seed)
    planes = rs.randint(0, 255, (cap, HW)).astype(np.uint8)
    done = np.zeros(cap, bool)
    for lane, step in [(0, 5), (0, 12), (1, 7), (1, 8), (2, 9), (3, 30), (0, 30), (1, 31), (2, 50), (3, 51)]:
        done[step * L + lane] = True
    term = done & (np.arange(cap) % 3 == 0)
    reward = rs.normal(size=cap).astype(np.float32)
    action = rs.randint(0, 4, cap).astype(np.int32)
    ring = jp.ring.replace(planes=jnp.asarray(planes), done=jnp.asarray(done), terminated=jnp.asarray(term),
                           reward=jnp.asarray(reward), action=jnp.asarray(action),
                           commit_cursor=jnp.asarray(cursor, jnp.int32))
    tring = type(tp.ring)(planes=_t(planes), action=_t(action), reward=_t(reward), terminated=_t(term),
                          done=_t(done), commit_cursor=cursor)
    return ring, tring


@pytest.mark.parametrize("cursor_rows", [40, 64 * 3 + 10])
def test_sample_given_jax_ids_is_exact(pipelines, cursor_rows):
    jp, tp, _, _ = pipelines
    cursor = cursor_rows * tp.L
    ring, tring = _filled(jp, tp, cursor, seed=cursor_rows)
    lo, hi = _window(tp, cursor)
    for s in range(4):
        want = jp._jit_sample(ring, jax.random.PRNGKey(s))
        ids = np.asarray(want.indices)
        got = tp.sample(tring, Given(ids - lo, max(hi - lo, 1)))
        for name in ("obs", "next_obs", "action", "reward", "is_terminal", "discount", "weight", "indices"):
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert got.obs.shape == (tp.minibatch_size, 84, 84, 4) and got.obs.dtype == torch.uint8


def test_sample_window_respects_wraparound_and_staging_margin_for_the_ports_draw(pipelines):
    _, tp, _, _ = pipelines
    cursor = tp.capacity * 3 + 10 * tp.L
    lo, hi = _window(tp, cursor)
    assert lo == cursor - tp.capacity + (tp.R + tp.stack_k + 1) * tp.L
    draws = Draws(torch.Generator().manual_seed(0))
    ids = torch.cat([tp.sample_ids(cursor, draws, tp.minibatch_size) for _ in range(64)]).numpy()
    assert ids.dtype == np.int32 and (ids >= lo).all() and (ids < hi).all(), (ids.min(), ids.max())
    assert ids.min() == lo and ids.max() == hi - 1  # the whole window is drawn from


def test_sample_window_respects_stack_history_at_start_for_the_ports_draw(pipelines):
    _, tp, _, _ = pipelines
    L, k = tp.L, tp.stack_k
    cursor = 30 * L
    draws = Draws(torch.Generator().manual_seed(1))
    ids = torch.cat([tp.sample_ids(cursor, draws, tp.minibatch_size) for _ in range(32)]).numpy()
    assert (ids >= (k - 1) * L).all() and (ids < cursor - L).all()


# --------------------------------------------------------------------- burst
def test_learner_burst_of_four_matches_jax(pipelines):
    jp, tp, kind, _ = pipelines
    cursor = 40 * tp.L
    ring, tring = _filled(jp, tp, cursor, seed=7)
    lo, hi = _window(tp, cursor)
    rng = jax.random.PRNGKey(11)
    # JAX's ids, iteration by iteration, from its own split chain.
    ids, r = [], rng
    for _ in range(4):
        r, r_s, _ = jax.random.split(r, 3)
        ids.append(np.asarray(jp._jit_sample(ring, r_s).indices))
    ts0 = jp.train_state
    jts, jloss, jq = jp._jit_burst(ts0, ring, rng, n=4)
    state = tp.train_state
    given = lambda: Given(np.concatenate(ids) - lo, max(hi - lo, 1))  # noqa: E731
    nudged = []
    for factor in NUDGES:  # the port's own sensitivity, from weights an ulp apart
        other = copy.deepcopy(state)
        with torch.no_grad():
            for x in other.model.parameters():
                x.mul_(factor)
        tp.learner_burst(other, tring, given(), 4)
        nudged.append(other)
    loss, q, syncs = tp.learner_burst(state, tring, given(), 4)
    # The sync fires on the crossing of (u * 4) // 12 at u = 2, as in JAX.
    assert syncs == 1 and state.n_updates == int(jts.n_updates) == 4
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(q), float(jq), rtol=1e-5, atol=1e-7)
    assert_within_nudges(state.model, jts.params, [o.model for o in nudged], kind)
    assert_within_nudges(state.target_model, jts.target_params, [o.target_model for o in nudged], kind + " target")
    # The target was synced to the weights after the third update: not the
    # initial target, not the final weights.
    with torch.no_grad():
        moved = [float((a - b).abs().max()) for a, b in zip(state.target_model.parameters(), state.model.parameters())]
    assert max(moved) > 0
    opt = state.opt_state
    if kind == "tiny-adam":
        adam = jts.opt_state[0]
        assert opt.count == int(adam.count) == 4
        pairs = ((opt.mu, adam.mu), (opt.nu, adam.nu))
    else:
        pairs = ((opt, jts.opt_state[0].nu),)
    names = [n for n, _ in state.model.named_parameters()]
    for moments, tree in pairs:
        want = convert.torch_arrays(state.model, np_tree(tree))
        for name, m in zip(names, moments):
            atol = 1e-5 * float(np.abs(want[name]).max()) + 1e-12
            np.testing.assert_allclose(m.numpy(), want[name], rtol=1e-4, atol=atol, err_msg=f"{kind} {name}")
