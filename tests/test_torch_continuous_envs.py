"""The continuous-control envs of the port against the JAX package's:
``MujocoSim`` (given the JAX env's mixing matrices), ``Pendulum``, the
four wrappers, and auto-reset through ``TimeLimit``'s nested state against
``VectorJaxEnv``.

The port's draws are logged (:class:`LoggedDraws`) and handed to the JAX
envs by value: :class:`ValueKeys` replaces ``jax.random.split``, ``normal``
and ``uniform`` so that a "key" *is* the array of values to be drawn, one
row per lane, which lets ``VectorJaxEnv``'s own vmapped reset and step run
on the port's numbers. ``uniform``'s range arithmetic is held against the
real ``jax.random.uniform`` on real keys in a test of its own.

Tolerances: MujocoSim 1e-6 absolute per step (dots over 17 and 6 terms,
summed in another order); Pendulum 1e-5 over 20 steps from given states
(``sin``/``cos`` differ by an ulp and the pendulum integrates it); flags,
step counters and which lanes reset are exact.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfrl_tpu import envs as jenvs
from pfrl_tpu.envs import wrappers as jwrappers
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.envs.vector_env import VectorTorchEnv
from pfrl_tpu_torch.utils.draws import uniform_between

torch.set_num_threads(1)


class LoggedDraws:
    """Seeded numpy draws, logged as ``(kind, values)``."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.log = []

    def _record(self, kind, values):
        self.log.append((kind, values))
        return torch.from_numpy(values.copy())

    def uniform(self, n):
        return self._record("uniform", (self.rs.randint(0, 1 << 24, n) / float(1 << 24)).astype(np.float32))

    def normal(self, n):
        return self._record("normal", self.rs.standard_normal(n).astype(np.float32))

    def randint_below(self, high, n):
        return self._record("randint_below", self.rs.randint(0, int(high), n).astype(np.int32))

    def take(self, *kinds):
        """Pop the oldest entries, which must be of these kinds."""
        out = []
        for kind in kinds:
            got, values = self.log.pop(0)
            assert got == kind, (got, kind)
            out.append(values)
        return out


class ValueKeys:
    """While installed, a JAX "key" is the array of the values to draw:
    ``split(key, n)`` gives its ``n`` rows, ``normal`` and ``uniform``
    return the key itself (``uniform`` mapped onto its range with
    ``jax.random.uniform``'s arithmetic)."""

    def __init__(self, monkeypatch):
        monkeypatch.setattr(jax.random, "split", self.split)
        monkeypatch.setattr(jax.random, "normal", self.normal)
        monkeypatch.setattr(jax.random, "uniform", self.uniform)

    @staticmethod
    def split(key, num=2):
        assert key.shape[0] == num, (key.shape, num)
        return key

    @staticmethod
    def normal(key, shape=(), dtype=jnp.float32):
        assert key.shape == tuple(shape), (key.shape, shape)
        return key.astype(dtype)

    @staticmethod
    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        assert key.shape == tuple(shape), (key.shape, shape)
        lo, hi = jnp.asarray(minval, dtype), jnp.asarray(maxval, dtype)
        return jnp.maximum(lo, key.astype(dtype) * (hi - lo) + lo)


def pendulum_keys(draws, lanes):
    """One reset's two logged uniform draws as per-lane keys ``[L, 2]``."""
    th, thdot = draws.take("uniform", "uniform")
    assert th.shape == thdot.shape == (lanes,)
    return jnp.stack([jnp.asarray(th), jnp.asarray(thdot)], axis=1)


def mujoco_keys(draws, lanes, obs_dim):
    (eps,) = draws.take("normal")
    return jnp.asarray(eps.reshape(lanes, obs_dim))


def step_keys(reset_keys):
    """``VectorJaxEnv.step`` splits its key into L step keys, which the
    envs ignore, and L reset keys."""
    return jnp.concatenate([jnp.zeros_like(reset_keys), reset_keys])


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_mujoco_pair(**kw):
    """The JAX env and the port's with the JAX env's matrices."""
    jenv = jenvs.MujocoSim(**kw)
    tenv = tenvs.MujocoSim(A=np.asarray(jenv._A), B=np.asarray(jenv._B), device="cpu", **kw)
    return jenv, tenv


# ------------------------------------------------------------------ MujocoSim
def test_mujoco_sim_matches_jax_per_step_given_its_matrices(monkeypatch):
    lanes = 5
    jenv, tenv = jax_mujoco_pair(episode_len=7)
    draws = LoggedDraws(0)
    tstate, tobs = tenv.reset(draws, lanes)
    keys = mujoco_keys(draws, lanes, 17)
    ValueKeys(monkeypatch)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert tobs.dtype == torch.float32 and tobs.shape == (lanes, 17)
    assert tstate.t.dtype == torch.int32
    rs = np.random.RandomState(1)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0)))
    for i in range(9):
        actions = rs.uniform(-1.5, 1.5, (lanes, 6)).astype(np.float32)  # some beyond the clip
        tstate, ts = tenv.step(tstate, _t(actions))
        jstate, jts = vstep(None, jstate, jnp.asarray(actions))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), atol=1e-6, rtol=0)
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(ts.truncated.numpy(), np.asarray(jts.truncated))
        np.testing.assert_array_equal(ts.terminated.numpy(), np.asarray(jts.terminated))
        np.testing.assert_array_equal(tstate.t.numpy(), np.asarray(jstate.t))
        assert bool(ts.truncated.all()) == (i + 1 >= 7) and not ts.terminated.any()
        # Keep the two on one trajectory: the comparison is per step.
        tstate = dataclasses.replace(tstate, x=_t(np.asarray(jstate.x)))
    for space in ("observation_space", "action_space"):
        j, t = getattr(jenv, space), getattr(tenv, space)
        assert (t.shape, t.dtype) == (j.shape, j.dtype)
        np.testing.assert_array_equal(t.low, j.low)
        np.testing.assert_array_equal(t.high, j.high)


def test_mujoco_sim_draws_its_own_matrices_at_the_jax_scales():
    jenv = jenvs.MujocoSim(obs_dim=200, action_dim=100)
    tenv = tenvs.MujocoSim(obs_dim=200, action_dim=100, device="cpu")
    again = tenvs.MujocoSim(obs_dim=200, action_dim=100, device="cpu")
    assert torch.equal(tenv._A, again._A) and torch.equal(tenv._B, again._B)  # fixed, not per instance
    for mine, theirs, nominal in ((tenv._A, jenv._A, 0.9 / 200**0.5), (tenv._B, jenv._B, 0.4)):
        assert mine.shape == theirs.shape
        for sample in (mine.numpy(), np.asarray(theirs)):
            assert abs(sample.std() / nominal - 1.0) < 0.03
    with pytest.raises(ValueError):
        tenvs.MujocoSim(A=np.zeros((3, 3)), device="cpu")


# ------------------------------------------------------------------- Pendulum
@pytest.mark.parametrize("low,high", [(-math.pi, math.pi), (-1.0, 1.0), (0.0, 1.0)])
def test_uniform_between_is_jax_random_uniform_on_the_same_key(low, high):
    """The port maps its own ``[0, 1)`` draws onto a range; fed JAX's draws
    for a key it gives ``jax.random.uniform(key, minval, maxval)``:
    exactly the float32 arithmetic ``max(low, u * (high - low) + low)``
    with each op rounded, as the stand-in the other tests hand the JAX envs
    computes it, and within an ulp of the range's bound of the jitted
    original, in which XLA fuses the product into the add."""
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (1000,)))

    class Given:
        def uniform(self, n):
            return torch.from_numpy(u.copy())

    f32 = np.float32
    want = np.maximum(f32(low), u * (f32(high) - f32(low)) + f32(low))
    assert want.dtype == np.float32
    got = uniform_between(Given(), low, high, (1000,)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(ValueKeys.uniform(jnp.asarray(u), (1000,), jnp.float32, low, high)), want)
    jitted = np.asarray(jax.random.uniform(key, (1000,), jnp.float32, low, high))
    np.testing.assert_allclose(got, jitted, atol=float(np.spacing(f32(max(abs(low), abs(high))))), rtol=0)
    assert got.min() >= low and got.max() <= high
    assert uniform_between(Given(), low, high, (250, 4)).shape == (250, 4)


def test_pendulum_reset_and_short_horizons_match_jax(monkeypatch):
    lanes, horizon = 6, 20
    jenv, tenv = jenvs.Pendulum(), tenvs.Pendulum(device="cpu")
    draws = LoggedDraws(2)
    tstate, tobs = tenv.reset(draws, lanes)
    keys = pendulum_keys(draws, lanes)
    ValueKeys(monkeypatch)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    np.testing.assert_array_equal(tstate.th.numpy(), np.asarray(jstate.th))
    np.testing.assert_array_equal(tstate.thdot.numpy(), np.asarray(jstate.thdot))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
    assert tobs.shape == (lanes, 3) and tobs.dtype == torch.float32
    assert float(tstate.th.abs().max()) <= math.pi and float(tstate.thdot.abs().max()) <= 1.0
    # Given states that cover the speed clip and angles beyond one turn.
    th0 = np.array([0.1, -3.0, 3.1, 7.0, -9.5, 0.0], np.float32)
    thdot0 = np.array([0.0, 7.9, -7.9, 1.0, -1.0, 8.0], np.float32)
    tstate = tenvs.PendulumState(th=_t(th0), thdot=_t(thdot0))
    jstate = jenvs.pendulum.PendulumState(th=jnp.asarray(th0), thdot=jnp.asarray(thdot0))
    rs = np.random.RandomState(3)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0)))
    for _ in range(horizon):
        actions = rs.uniform(-3.0, 3.0, (lanes, 1)).astype(np.float32)  # beyond the torque clip
        tstate, ts = tenv.step(tstate, _t(actions))
        jstate, jts = vstep(None, jstate, jnp.asarray(actions))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), atol=1e-5, rtol=0)
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), atol=1e-5, rtol=1e-6)
        assert not ts.terminated.any() and not ts.truncated.any()
        assert ts.reward.dtype == torch.float32 and (ts.reward <= 0).all()
    np.testing.assert_allclose(tstate.th.numpy(), np.asarray(jstate.th), atol=1e-5, rtol=0)
    assert float(tstate.thdot.abs().max()) <= 8.0
    assert tenv.max_episode_steps == jenv.max_episode_steps == 200
    for space in ("observation_space", "action_space"):
        np.testing.assert_array_equal(getattr(tenv, space).high, getattr(jenv, space).high)


# ------------------------------------------------------------------- wrappers
def _wrapped(kind):
    jbase, tbase = jenvs.Pendulum(), tenvs.Pendulum(device="cpu")
    if kind == "time_limit":
        return jenvs.TimeLimit(jbase, 3), tenvs.TimeLimit(tbase, 3)
    if kind == "time_limit_default":
        return jenvs.TimeLimit(jbase), tenvs.TimeLimit(tbase)
    if kind == "scale_reward":
        return jwrappers.ScaleReward(jbase, 0.01), tenvs.ScaleReward(tbase, 0.01)
    if kind == "cast_float32":
        return jwrappers.CastObservationToFloat32(jbase), tenvs.CastObservationToFloat32(tbase)
    if kind == "normalize_action":
        return jenvs.NormalizeActionSpace(jbase), tenvs.NormalizeActionSpace(tbase)
    return (jenvs.NormalizeActionSpace(jenvs.TimeLimit(jbase, 3)),
            tenvs.NormalizeActionSpace(tenvs.TimeLimit(tbase, 3)))


@pytest.mark.parametrize(
    "kind", ["time_limit", "time_limit_default", "scale_reward", "cast_float32", "normalize_action", "stacked"]
)
def test_each_wrapper_matches_jax(monkeypatch, kind):
    lanes = 4
    jenv, tenv = _wrapped(kind)
    draws = LoggedDraws(4)
    tstate, tobs = tenv.reset(draws, lanes)
    keys = pendulum_keys(draws, lanes)
    ValueKeys(monkeypatch)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
    assert tenv.max_episode_steps == jenv.max_episode_steps
    assert tenv.action_space.shape == jenv.action_space.shape
    np.testing.assert_array_equal(tenv.action_space.high, jenv.action_space.high)
    np.testing.assert_array_equal(tenv.observation_space.high, jenv.observation_space.high)
    rs = np.random.RandomState(5)
    vstep = jax.vmap(jenv.step, in_axes=(None, 0, 0))
    for i in range(5):
        actions = rs.uniform(-1.5, 1.5, (lanes, 1)).astype(np.float32)
        tstate, ts = tenv.step(tstate, _t(actions))
        jstate, jts = vstep(None, jstate, jnp.asarray(actions))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), atol=1e-6, rtol=0)
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(ts.truncated.numpy(), np.asarray(jts.truncated))
        np.testing.assert_array_equal(ts.terminated.numpy(), np.asarray(jts.terminated))
        assert ts.obs.dtype == torch.float32
        if kind in ("time_limit", "stacked"):
            assert bool(ts.truncated.all()) == (i + 1 >= 3)
            np.testing.assert_array_equal(tstate.t.numpy(), np.asarray(jstate.t))
            assert tstate.t.dtype == torch.int32


def test_time_limit_needs_a_limit():
    with pytest.raises(ValueError):
        tenvs.TimeLimit(tenvs.MujocoSim(device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            raise RuntimeError("device='cpu'")  # a card: the default device exists
        tenvs.Pendulum()


def test_time_limit_does_not_truncate_a_terminated_step():
    class Terminating(tenvs.Pendulum):
        def step(self, state, actions):
            state, ts = super().step(state, actions)
            lane0 = torch.arange(actions.shape[0]) == 0
            return state, dataclasses.replace(ts, terminated=lane0)

    env = tenvs.TimeLimit(Terminating(device="cpu"), 1)
    state, _ = env.reset(LoggedDraws(0), 3)
    _, ts = env.step(state, torch.zeros(3, 1))
    assert ts.terminated.tolist() == [True, False, False]
    assert ts.truncated.tolist() == [False, True, True]
    assert ts.done.all()


# ------------------------------------------------------------------ auto-reset
def test_auto_reset_through_time_limit_matches_vector_jax_env_over_two_episodes(monkeypatch):
    """2 x 200 steps of the DDPG configuration's env: at steps 200 and 400
    every lane is truncated, never terminated; ``ts.obs`` is the pre-reset
    observation and ``obs`` the fresh episode's; the nested state's inner
    fields and step counter are selected lane by lane."""
    lanes, limit = 3, 200
    jvec = VectorJaxEnv(jenvs.NormalizeActionSpace(jenvs.TimeLimit(jenvs.Pendulum(), limit)), lanes)
    tvec = VectorTorchEnv(tenvs.NormalizeActionSpace(tenvs.TimeLimit(tenvs.Pendulum(device="cpu"), limit)), lanes)
    draws = LoggedDraws(6)
    tstates, tobs = tvec.reset(draws)
    keys = pendulum_keys(draws, lanes)
    ValueKeys(monkeypatch)
    jstates, jobs = jvec.reset(keys)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
    jstep = jax.jit(jvec.step)
    rs = np.random.RandomState(7)
    truncations = 0
    for i in range(1, 2 * limit + 1):
        actions = rs.uniform(-1.0, 1.0, (lanes, 1)).astype(np.float32)
        tstates, tvs = tvec.step(draws, tstates, _t(actions))
        jstates, jvs = jstep(step_keys(pendulum_keys(draws, lanes)), jstates, jnp.asarray(actions))
        boundary = i % limit == 0
        assert not tvs.ts.terminated.any() and not np.asarray(jvs.ts.terminated).any()
        assert bool(tvs.ts.truncated.all()) == bool(tvs.ts.done.all()) == boundary
        np.testing.assert_array_equal(tvs.ts.done.numpy(), np.asarray(jvs.ts.done))
        # The pendulum is chaotic over 200 steps: hold the port to the JAX
        # env per step, then continue both from the JAX state.
        np.testing.assert_allclose(tvs.ts.obs.numpy(), np.asarray(jvs.ts.obs), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tvs.obs.numpy(), np.asarray(jvs.obs), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tstates.t.numpy(), np.asarray(jstates.t))
        np.testing.assert_allclose(tstates.inner.th.numpy(), np.asarray(jstates.inner.th), atol=1e-5, rtol=0)
        if boundary:
            truncations += 1
            assert (tstates.t == 0).all()
            assert not np.allclose(tvs.obs.numpy(), tvs.ts.obs.numpy())  # obs is the fresh episode's
            # The reset state; jitted, XLA fuses the range product into the add.
            np.testing.assert_allclose(tstates.inner.th.numpy(), np.asarray(jstates.inner.th), atol=5e-7, rtol=0)
        else:
            assert torch.equal(tvs.obs, tvs.ts.obs)
        tstates = tenvs.TimeLimitState(
            inner=tenvs.PendulumState(th=_t(np.asarray(jstates.inner.th)), thdot=_t(np.asarray(jstates.inner.thdot))),
            t=tstates.t,
        )
    assert truncations == 2 and not draws.log
    assert isinstance(tstates.inner, tenvs.PendulumState)


def test_auto_reset_selects_mujoco_sim_lanes_like_vector_jax_env(monkeypatch):
    lanes, episode_len = 4, 5
    jenv, tenv = jax_mujoco_pair(episode_len=episode_len)
    jvec, tvec = VectorJaxEnv(jenv, lanes), VectorTorchEnv(tenv, lanes)
    draws = LoggedDraws(8)
    tstates, tobs = tvec.reset(draws)
    ValueKeys(monkeypatch)
    jstates, _ = jvec.reset(mujoco_keys(draws, lanes, 17))
    # Lanes out of phase: lane k has already taken k steps.
    tstates = dataclasses.replace(tstates, t=torch.arange(lanes, dtype=torch.int32))
    jstates = jstates.replace(t=jnp.arange(lanes, dtype=jnp.int32))
    rs = np.random.RandomState(9)
    resets = 0
    for _ in range(8):
        actions = rs.uniform(-1.0, 1.0, (lanes, 6)).astype(np.float32)
        tstates, tvs = tvec.step(draws, tstates, _t(actions))
        jstates, jvs = jvec.step(step_keys(mujoco_keys(draws, lanes, 17)), jstates, jnp.asarray(actions))
        np.testing.assert_array_equal(tvs.ts.done.numpy(), np.asarray(jvs.ts.done))
        np.testing.assert_allclose(tvs.ts.obs.numpy(), np.asarray(jvs.ts.obs), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tvs.obs.numpy(), np.asarray(jvs.obs), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tstates.t.numpy(), np.asarray(jstates.t))
        resets += int(tvs.ts.done.sum())
        assert 0 <= int(tvs.ts.done.sum()) < lanes  # never all lanes at once
        tstates = dataclasses.replace(tstates, x=_t(np.asarray(jstates.x)))
    assert resets >= lanes and not draws.log
