"""``CartPole`` of the port against the JAX package's: reset by value, the
dynamics per step from given states (both actions, both termination
bounds), and ``TimeLimit(CartPole(), 500)`` through ``VectorTorchEnv``
against ``VectorJaxEnv`` with auto-reset, on the port's logged draws
(``ValueKeys``, ``test_torch_continuous_envs.py``).

Tolerances: 1e-6 absolute per step from the same state (``sin``/``cos`` and
the force's products round an ulp apart); flags, step counters and which
lanes reset exact. Over many steps the pole diverges chaotically, so the
auto-reset run continues both envs from the JAX state after each step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_continuous_envs import LoggedDraws, ValueKeys, step_keys

from pfrl_tpu import envs as jenvs
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.envs.vector_env import VectorTorchEnv

torch.set_num_threads(1)


def cartpole_keys(draws, lanes):
    """One reset's logged uniform draw as per-lane keys ``[L, 4]``."""
    (u,) = draws.take("uniform")
    return jnp.asarray(u.reshape(lanes, 4))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_reset_matches_jax_by_value(monkeypatch):
    lanes = 7
    jenv, tenv = jenvs.CartPole(), tenvs.CartPole(device="cpu")
    draws = LoggedDraws(0)
    tstate, tobs = tenv.reset(draws, lanes)
    keys = cartpole_keys(draws, lanes)
    ValueKeys(monkeypatch)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(tstate.x.numpy(), np.asarray(jstate.x))
    assert tobs.shape == (lanes, 4) and tobs.dtype == torch.float32
    assert float(tobs.abs().max()) <= 0.05
    for space in ("observation_space",):
        np.testing.assert_array_equal(getattr(tenv, space).high, getattr(jenv, space).high)
    assert tenv.action_space.n == jenv.action_space.n == 2
    assert tenv.max_episode_steps == jenv.max_episode_steps == 500


@pytest.mark.parametrize("action_dtype", [torch.int64, torch.int32])
def test_step_matches_jax_from_given_states(action_dtype):
    """States near and beyond both bounds; each step from the JAX state."""
    jenv, tenv = jenvs.CartPole(), tenvs.CartPole(device="cpu")
    x0 = np.array([
        [0.0, 0.0, 0.0, 0.0],
        [2.39, 1.0, 0.01, 0.0],      # crosses |x| > 2.4
        [-2.39, -1.0, -0.01, 0.0],
        [0.1, 0.0, 0.205, 0.5],      # crosses |theta| > 12 degrees
        [0.0, 0.3, -0.205, -0.5],
        [1.0, -2.0, 0.1, 1.5],
    ], np.float32)
    jstate = jenvs.cartpole.CartPoleState(x=jnp.asarray(x0))
    tstate = tenvs.CartPoleState(x=_t(x0))
    rs = np.random.RandomState(1)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0)))
    terminated = 0
    for _ in range(6):
        actions = rs.randint(0, 2, len(x0))
        tstate, ts = tenv.step(tstate, torch.from_numpy(actions).to(action_dtype))
        jstate, jts = vstep(None, jstate, jnp.asarray(actions, jnp.int32))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(jts.obs), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(ts.terminated.numpy(), np.asarray(jts.terminated))
        np.testing.assert_array_equal(ts.truncated.numpy(), np.asarray(jts.truncated))
        np.testing.assert_array_equal(ts.reward.numpy(), np.asarray(jts.reward))
        assert ts.reward.dtype == torch.float32 and ts.obs.dtype == torch.float32
        terminated += int(ts.terminated.sum())
        tstate = tenvs.CartPoleState(x=_t(np.asarray(jstate.x)))
    assert terminated >= 4


def test_time_limited_cartpole_auto_resets_like_vector_jax_env(monkeypatch):
    """Random actions over 60 steps with a 25-step limit: lanes terminate
    (the pole falls) and are truncated, at different steps; ``ts.obs`` is
    the pre-reset observation and ``obs`` the fresh episode's."""
    lanes, limit, steps = 6, 25, 60
    jvec = VectorJaxEnv(jenvs.TimeLimit(jenvs.CartPole(), limit), lanes)
    tvec = VectorTorchEnv(tenvs.TimeLimit(tenvs.CartPole(device="cpu"), limit), lanes)
    draws = LoggedDraws(2)
    tstates, tobs = tvec.reset(draws)
    keys = cartpole_keys(draws, lanes)
    ValueKeys(monkeypatch)
    jstates, jobs = jvec.reset(keys)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    jstep = jax.jit(jvec.step)
    rs = np.random.RandomState(3)
    terminations = truncations = 0
    for _ in range(steps):
        actions = rs.randint(0, 2, lanes)
        tstates, tvs = tvec.step(draws, tstates, torch.from_numpy(actions))
        jstates, jvs = jstep(step_keys(cartpole_keys(draws, lanes)), jstates, jnp.asarray(actions, jnp.int32))
        for name in ("terminated", "truncated", "done"):
            np.testing.assert_array_equal(getattr(tvs.ts, name).numpy(), np.asarray(getattr(jvs.ts, name)), err_msg=name)
        np.testing.assert_allclose(tvs.ts.obs.numpy(), np.asarray(jvs.ts.obs), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tvs.obs.numpy(), np.asarray(jvs.obs), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tstates.t.numpy(), np.asarray(jstates.t))
        terminations += int(tvs.ts.terminated.sum())
        truncations += int(tvs.ts.truncated.sum())
        done = tvs.ts.done
        assert (tstates.t[done] == 0).all() and not (tvs.ts.terminated & tvs.ts.truncated).any()
        tstates = dataclasses.replace(tstates, inner=tenvs.CartPoleState(x=_t(np.asarray(jstates.inner.x))))
    assert terminations > 0 and truncations > 0 and not draws.log
