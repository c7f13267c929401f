"""The port's host envs against the JAX package's: ``SerialVectorEnv``,
``MultiprocessVectorEnv`` (spawned workers that import no torch; factories
shipped with pickle), ``GymnasiumEnv`` and ``make_gymnasium_env`` on
gymnasium's ``CartPole-v1``, ``spaces.from_gym_space``, the wrappers of
``wrappers/misc.py``, ``HostTorchEnv`` against ``HostJaxEnv``, and the
``VectorEnv`` protocol.

Held exactly: observations, rewards, flags and infos of the numpy envs,
step by step. ``HostTorchEnv`` is held to ``HostJaxEnv`` over the same
draws (the port's draws logged, replayed into JAX by value): ABC exactly,
CartPole's observations within 1e-6 (XLA's and torch's float32 ``sin`` and
``cos`` round apart, ``test_torch_cartpole.py``'s bound).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu import spaces as jspaces
from pfrl_tpu import wrappers as jwrappers
from pfrl_tpu.env import VectorEnv as JaxVectorEnv
from pfrl_tpu.envs import ABC as JaxABC
from pfrl_tpu.envs import CartPole as JaxCartPole
from pfrl_tpu.envs import HostJaxEnv
from pfrl_tpu.envs import SerialVectorEnv as JaxSerialVectorEnv
from pfrl_tpu.envs import TimeLimit as JaxTimeLimit
from pfrl_tpu.envs.gymnasium_env import make_gymnasium_env as jax_make_gymnasium_env
from pfrl_tpu_torch import env as port_env
from pfrl_tpu_torch import spaces, wrappers
from pfrl_tpu_torch.envs import ABC, CartPole, HostTorchEnv, MultiprocessVectorEnv, SerialVectorEnv
from pfrl_tpu_torch.envs.gymnasium_env import GymnasiumEnv, make_gymnasium_env
from pfrl_tpu_torch.envs.wrappers import TimeLimit

REPO = Path(__file__).resolve().parent.parent
gymnasium = pytest.importorskip("gymnasium")


def _rollout(env, actions, reset_every=None):
    """Observations, rewards, flags and infos of ``env`` over ``actions``,
    resetting after each episode end."""
    out = [("reset", np.asarray(env.reset()).tolist())]
    for i, a in enumerate(actions):
        obs, r, done, info = env.step(a)
        out.append((np.asarray(obs).tolist(), float(r), bool(done), dict(info)))
        if done or info.get("needs_reset") or (reset_every and (i + 1) % reset_every == 0):
            out.append(("reset", np.asarray(env.reset()).tolist()))
    return out


# ------------------------------------------------------------ gymnasium
def test_gymnasium_env_matches_jax_on_cartpole():
    """Seeding through ``seed=`` and ``seed()``, termination as ``done``,
    the 500-step truncation as ``needs_reset``."""
    actions = np.random.RandomState(0).randint(0, 2, 700)
    tenv, jenv = make_gymnasium_env("CartPole-v1", seed=3), jax_make_gymnasium_env("CartPole-v1", seed=3)
    assert _rollout(tenv, actions) == _rollout(jenv, actions)
    tenv.seed(11), jenv.seed(11)
    assert _rollout(tenv, actions[:50]) == _rollout(jenv, actions[:50])
    # Always pushing right never balances; alternating does for a while.
    long = make_gymnasium_env("CartPole-v1", seed=0, max_episode_steps=30)
    steps = _rollout(long, [i % 2 for i in range(30)])
    assert steps[-2][3] == {"needs_reset": True} and not steps[-2][2]
    assert isinstance(tenv.unwrapped, gymnasium.Env) and tenv.spec.id == "CartPole-v1"  # delegated
    tenv.close(), jenv.close(), long.close()


def test_make_gymnasium_env_names_what_is_missing():
    with pytest.raises(RuntimeError, match="NoSuchEnv-v0"):
        make_gymnasium_env("NoSuchEnv-v0")


def test_legacy_four_tuple_env_maps_like_jax():
    class Legacy:
        def __init__(self):
            self.observation_space = self.action_space = None
            self.t, self.seeded = 0, None

        def seed(self, seed=None):
            self.seeded = seed

        def reset(self):
            self.t = 0
            return np.zeros(2, np.float32)

        def step(self, action):
            self.t += 1
            info = {"TimeLimit.truncated": True} if self.t == 3 else {}
            return np.full(2, self.t, np.float32), 1.0, self.t == 3, info

    got = []
    for env_cls in (GymnasiumEnv, __import__("pfrl_tpu.envs.gymnasium_env", fromlist=["x"]).GymnasiumEnv):
        env = env_cls(Legacy(), seed=5)
        got.append((_rollout(env, [0, 1, 0]), env.env.seeded))
    assert got[0] == got[1] and got[0][1] == 5
    assert got[0][0][3][2] is False and got[0][0][3][3] == {"TimeLimit.truncated": True, "needs_reset": True}


@pytest.mark.parametrize("space", [gymnasium.spaces.Discrete(5),
                                   gymnasium.spaces.Box(-1.0, 2.0, (3,), np.float32)])
def test_from_gym_space_matches_jax(space):
    got, want = spaces.from_gym_space(space), jspaces.from_gym_space(space)
    assert type(got).__name__ == type(want).__name__ and got.shape == want.shape
    if hasattr(want, "n"):
        assert got.n == want.n
    else:
        np.testing.assert_array_equal(got.low, want.low)
        np.testing.assert_array_equal(got.high, want.high)
    with pytest.raises(NotImplementedError):
        spaces.from_gym_space(gymnasium.spaces.MultiBinary(3))


# ------------------------------------------------------------- wrappers
def _wrapped(module, env_factory):
    return {
        "cast": module.CastObservation(env_factory(), np.float64),
        "cast32": module.CastObservationToFloat32(env_factory()),
        "scale": module.ScaleReward(env_factory(), 0.1),
        "randomize": module.RandomizeAction(env_factory(), 0.5),
    }


def test_misc_wrappers_match_jax():
    actions = np.random.RandomState(1).randint(0, 2, 120)
    tw = _wrapped(wrappers, lambda: make_gymnasium_env("CartPole-v1", seed=2))
    jw = _wrapped(jwrappers, lambda: jax_make_gymnasium_env("CartPole-v1", seed=2))
    tw["randomize"].seed(4), jw["randomize"].seed(4)
    for name in tw:
        got, want = _rollout(tw[name], actions), _rollout(jw[name], actions)
        assert got == want, name
    assert tw["cast"].reset().dtype == np.float64 and tw["cast32"].reset().dtype == np.float32
    assert tw["scale"].spec.id == "CartPole-v1"  # attributes reach the inner env


def test_normalize_action_space_matches_jax():
    def pendulum():
        return make_gymnasium_env("Pendulum-v1", seed=0)

    tenv, jenv = wrappers.NormalizeActionSpace(pendulum()), jwrappers.NormalizeActionSpace(pendulum())
    actions = np.random.RandomState(2).uniform(-1, 1, (30, 1)).astype(np.float32)
    assert _rollout(tenv, actions) == _rollout(jenv, actions)


def test_wrappers_and_host_envs_import_no_torch():
    code = (
        "import sys\n"
        "from pfrl_tpu_torch import wrappers\n"
        "from pfrl_tpu_torch.envs import MultiprocessVectorEnv, SerialVectorEnv, GymnasiumEnv, make_gymnasium_env\n"
        "from pfrl_tpu_torch.envs.synthetic_ale import make_ale_env\n"
        "from pfrl_tpu_torch.env import VectorEnv\n"
        "assert 'torch' not in sys.modules, 'torch was imported'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ------------------------------------------------------ the vector envs
def test_serial_vector_env_matches_jax_with_masked_resets():
    tvec, jvec = SerialVectorEnv([make_gymnasium_env("CartPole-v1", seed=i) for i in range(3)]), \
        JaxSerialVectorEnv([jax_make_gymnasium_env("CartPole-v1", seed=i) for i in range(3)])
    assert isinstance(tvec, port_env.VectorEnv) and isinstance(jvec, JaxVectorEnv)
    assert tvec.num_envs == jvec.num_envs == 3 and tvec.unwrapped is tvec
    rs = np.random.RandomState(3)
    np.testing.assert_array_equal(np.asarray(tvec.reset()), np.asarray(jvec.reset()))
    for _ in range(60):
        actions = rs.randint(0, 2, 3)
        tout, jout = tvec.step(actions), jvec.step(actions)
        np.testing.assert_array_equal(np.asarray(tout[0]), np.asarray(jout[0]))
        for a, b in zip(tout[1:3], jout[1:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert tout[3] == jout[3]
        mask = ~(tout[2] | np.array([i.get("needs_reset", False) for i in tout[3]]))
        np.testing.assert_array_equal(np.asarray(tvec.reset(mask)), np.asarray(jvec.reset(mask)))
    tvec.seed([5, 6, 7]), jvec.seed([5, 6, 7])
    np.testing.assert_array_equal(np.asarray(tvec.reset()), np.asarray(jvec.reset()))
    tvec.close(), jvec.close()


def test_multiprocess_vector_env_matches_the_serial_one():
    """Spawned workers, factories shipped by pickle (``functools.partial``
    of a module-level function): the same steps, masked resets and seeds as
    ``SerialVectorEnv`` over the same factories."""
    fns = [functools.partial(make_gymnasium_env, "CartPole-v1", seed=i) for i in range(3)]
    mp_env = MultiprocessVectorEnv(fns)
    try:
        serial = SerialVectorEnv([fn() for fn in fns])
        assert mp_env.num_envs == 3 and mp_env.startup_s > 0
        assert mp_env.action_space.n == 2 and mp_env.observation_space.shape == (4,)
        rs = np.random.RandomState(4)
        np.testing.assert_array_equal(np.asarray(mp_env.reset()), np.asarray(serial.reset()))
        for _ in range(40):
            actions = rs.randint(0, 2, 3)
            a, b = mp_env.step(actions), serial.step(actions)
            np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
            assert a[3] == b[3]
            mask = ~(a[2] | np.array([i.get("needs_reset", False) for i in a[3]]))
            np.testing.assert_array_equal(np.asarray(mp_env.reset(mask)), np.asarray(serial.reset(mask)))
        assert mp_env.seed([8, 9, 10]) == [None] * 3
        serial.seed([8, 9, 10])
        np.testing.assert_array_equal(np.asarray(mp_env.reset()), np.asarray(serial.reset()))
    finally:
        mp_env.close()
    assert mp_env.closed and all(p.exitcode is not None for p in mp_env.ps)


def test_multiprocess_vector_env_refuses_a_lambda_by_name():
    with pytest.raises(TypeError, match="functools.partial"):
        MultiprocessVectorEnv([lambda: make_gymnasium_env("CartPole-v1")])


def test_multiprocess_vector_env_workers_import_no_torch(tmp_path):
    """A parent that has loaded torch spawns its workers; each worker
    reports whether torch is in its ``sys.modules``: it is not."""
    (tmp_path / "probe_env.py").write_text(
        "import sys\n"
        "from pfrl_tpu_torch.envs.synthetic_ale import make_ale_env\n"
        "class Probe:\n"
        "    def __init__(self, i):\n"
        "        self.env = make_ale_env(0, i, False)\n"
        "        self.observation_space = self.env.observation_space\n"
        "        self.action_space = self.env.action_space\n"
        "    def reset(self):\n"
        "        return self.env.reset()\n"
        "    def step(self, a):\n"
        "        return self.env.step(a)\n"
        "    def seed(self, s):\n"
        "        return sorted(m for m in sys.modules if m.split('.')[0] == 'torch')\n"
        "    def close(self):\n"
        "        pass\n"
    )
    code = (
        "import functools, sys\n"
        "import numpy as np\n"
        "import torch\n"
        "from pfrl_tpu_torch import runtime\n"
        "from pfrl_tpu_torch.envs import MultiprocessVectorEnv\n"
        "import probe_env\n"
        "runtime.build()\n"
        "env = MultiprocessVectorEnv([functools.partial(probe_env.Probe, i) for i in range(2)])\n"
        "obs = env.reset(); obs, r, d, _ = env.step([1, 2])\n"
        "assert np.asarray(obs[0]).shape == (84, 84, 4) and np.asarray(obs[0]).dtype == np.uint8\n"
        "assert env.seed([0, 0]) == [[], []], env.seed([0, 0])\n"
        "env.close()\n"
        "print('workers without torch')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(REPO)])})
    assert out.returncode == 0 and "workers without torch" in out.stdout, out.stderr


def test_a_worker_that_fails_to_build_its_env_raises_in_the_parent():
    fns = [functools.partial(make_gymnasium_env, "CartPole-v1"), functools.partial(make_gymnasium_env, "NoSuch-v0")]
    with pytest.raises(RuntimeError, match="worker 1 of MultiprocessVectorEnv ended"):
        MultiprocessVectorEnv(fns)


# ---------------------------------------------------------- HostTorchEnv
@pytest.mark.parametrize("name", ["abc", "cartpole"])
def test_host_torch_env_matches_host_jax_env(name):
    """One lane of the port's device env behind the host protocol, on the
    same draws as ``HostJaxEnv``: resets, steps, rewards, ``done`` and the
    truncation's ``needs_reset`` (CartPole cut at 10 steps)."""
    if name == "abc":
        tenv_fn, jenv_fn, actions = (lambda: ABC(size=3, deterministic=True, device="cpu"),
                                     lambda: JaxABC(size=3, deterministic=True), [0, 1, 2, 0, 2, 0, 1, 1] * 5)
    else:
        tenv_fn, jenv_fn, actions = (lambda: TimeLimit(CartPole(device="cpu"), 10), lambda: JaxTimeLimit(JaxCartPole(), 10),
                                     [i % 2 for i in range(120)])
    tape = Tape(2)
    tenv = HostTorchEnv(tenv_fn(), draws=tape)
    got = _rollout(tenv, actions)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        want = _rollout(HostJaxEnv(jenv_fn()), actions)
        assert not tape.log
    assert len(got) == len(want) > len(actions)
    for g, w in zip(got, want):
        assert g[0] == "reset" or g[1:] == w[1:], (g, w)
        np.testing.assert_allclose(np.asarray(g[1] if g[0] == "reset" else g[0], np.float32),
                                   np.asarray(w[1] if w[0] == "reset" else w[0], np.float32), atol=1e-6, rtol=0)
    assert any(s[3].get("needs_reset") for s in got if s[0] != "reset") == (name == "cartpole")
    assert isinstance(got[1][0], list) and isinstance(tenv.reset(), np.ndarray)
    assert tenv.observation_space == tenv.env.observation_space


def test_host_torch_env_seeds_its_own_draws():
    a, b = HostTorchEnv(CartPole(device="cpu"), seed=3), HostTorchEnv(CartPole(device="cpu"), seed=3)
    np.testing.assert_array_equal(a.reset(), b.reset())
    a.seed(4)
    assert not np.array_equal(a.reset(), b.reset())
    assert isinstance(a.draws.generator, torch.Generator)
