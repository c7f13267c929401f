"""The port's ``make_atari`` and ``ContinuingTimeLimit``
(``pfrl_tpu_torch/wrappers/atari_wrappers.py``,
``continuing_time_limit.py``) against the JAX package's, over the ALE
stand-in (``torch_ale_standin.py``, built by gymnasium's ``"module:Id"``
form).

- ``make_atari`` + ``wrap_deepmind`` in the examples' training settings
  (lives end episodes, rewards clipped) and evaluation settings (neither,
  5% random actions), each env seeded through ``env.seed`` on the outer
  stack: observations, rewards, dones and infos equal to the bit over a
  fixed action sequence with resets at game overs and at the time limit;
  ``make_atari_deepmind`` and ``make_ale_plane_env`` (the pipeline
  example's) against the examples' own factories.
- ``ContinuingTimeLimit``: ``needs_reset`` at the limit and never ``done``,
  the counter restarted only by ``reset``, attributes delegated, and a
  half-built object (``copy``, unpickling) raising ``AttributeError``.
- A real id raises ``RuntimeError`` naming gymnasium's error, as the JAX
  factory does.
- The stand-in's chain without gymnasium (``make_standin_atari``, through
  ``make_atari``'s helper) equals ``make_atari``'s, and builds in a fresh
  process that loads neither gymnasium nor torch; ``make_atari``'s chain in
  a spawned ``MultiprocessVectorEnv`` worker equals the one built here.

Frames go through each package's own C++ frame ops, as in
``test_torch_atari_wrappers.py``. Everything is compared exactly.
"""

import copy
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from torch_ale_standin import ENV_ID, make_standin_atari

from pfrl_tpu.wrappers import RandomizeAction as JaxRandomizeAction
from pfrl_tpu.wrappers import atari_wrappers as jwrappers
from pfrl_tpu.wrappers.continuing_time_limit import ContinuingTimeLimit as JaxContinuingTimeLimit
from pfrl_tpu_torch.envs.gymnasium_env import GymnasiumEnv
from pfrl_tpu_torch.envs.multiprocess_vector_env import MultiprocessVectorEnv
from pfrl_tpu_torch.wrappers import ContinuingTimeLimit, RandomizeAction
from pfrl_tpu_torch.wrappers import atari_wrappers as twrappers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def _rollout(env, steps, seed):
    """Observations, rewards, dones and infos of ``steps`` random actions,
    resetting at a game over or at the time limit."""
    rs = np.random.RandomState(seed)
    out = [("reset", np.asarray(env.reset()))]
    for _ in range(steps):
        obs, reward, done, info = env.step(int(rs.randint(0, 4)))
        out.append((np.asarray(obs), reward, done, info))
        if done or info.get("needs_reset", False):
            out.append(("reset", np.asarray(env.reset())))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b and type(a) is type(b), (a, b)


def _deepmind(w, test, max_frames, seed):
    env = w.wrap_deepmind(w.make_atari(ENV_ID, max_frames=max_frames), episode_life=not test,
                          clip_rewards=not test, channel_order="hwc")
    env.seed(seed)
    return env


@pytest.mark.parametrize("test", [False, True], ids=["train", "test"])
def test_make_atari_deepmind_stack_matches_the_jax_package(test):
    port, jax_env = (_deepmind(w, test, 400, 7) for w in (twrappers, jwrappers))
    if test:  # the examples' evaluation protocol, seeded alike
        port, jax_env = RandomizeAction(port, 0.05), JaxRandomizeAction(jax_env, 0.05)
        port.seed(7)
        jax_env.seed(7)
    got, want = _rollout(port, 300, 1), _rollout(jax_env, 300, 1)
    _assert_same(got, want)
    assert got[0][1].shape == (84, 84, 4) and got[0][1].dtype == np.uint8
    dones = sum(1 for g in got if not isinstance(g[0], str) and g[2])
    timeouts = sum(1 for g in got if not isinstance(g[0], str) and g[3].get("needs_reset"))
    assert timeouts >= 1 and dones >= (0 if test else 3)  # lives end training episodes
    assert {g[1] for g in got if not isinstance(g[0], str)} <= {-1.0, 0.0, 1.0, 2.0} - ({2.0} if not test else set())


def test_make_atari_chain_counts_raw_frames():
    env = twrappers.make_atari(ENV_ID, max_frames=40)
    assert type(env) is twrappers.MaxAndSkipEnv and type(env.env) is twrappers.NoopResetEnv
    limit = env.env.env
    assert type(limit) is ContinuingTimeLimit and type(limit.env) is GymnasiumEnv
    assert env.env.noop_max == 30 and env._skip == 4
    env.seed(0)
    env.reset()
    noops = limit._elapsed_steps
    steps = 0
    while True:
        _, _, done, info = env.step(0)
        steps += 1
        if info.get("needs_reset"):
            break
    # The limit is on raw frames, the no-ops after the reset counted.
    assert 1 <= noops <= 30 and steps == -(-(40 - noops) // 4) and limit._elapsed_steps == noops + 4 * steps
    assert env.unwrapped.get_action_meanings()[:2] == ["NOOP", "FIRE"]


def test_example_factories_match_the_jax_examples():
    import importlib.util

    def example(rel):
        spec = importlib.util.spec_from_file_location(rel.replace("/", "_")[:-3], os.path.join(REPO, rel))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    plane = example("examples/atari/train_dqn_pipeline_ale.py").make_ale_plane_env
    _assert_same(_rollout(twrappers.make_ale_plane_env(ENV_ID, 3), 120, 2),
                 _rollout(plane(ENV_ID, 3), 120, 2))
    batch = example("examples/atari/train_dqn_batch_ale.py")
    args = type("Args", (), {"env": ENV_ID, "seed": 4})()
    for idx, test in ((1, False), (2, True)):
        port = twrappers.make_atari_deepmind(ENV_ID, test, args.seed + idx + (10**6 if test else 0),
                                            randomize_action=0.05)
        jax_env = batch.make_ale_env(args, idx, test)
        assert type(port).__name__ == type(jax_env).__name__ == ("RandomizeAction" if test else "FrameStack")
        if test:
            port._rng, jax_env._rng = np.random.RandomState(9), np.random.RandomState(9)
        _assert_same(_rollout(port, 150, 3), _rollout(jax_env, 150, 3))


def _time_limited(cls, limit):
    inner = twrappers.make_atari(ENV_ID, max_frames=0).env.env  # no limit: the GymnasiumEnv under the no-ops
    return cls(inner, max_episode_steps=limit)


def test_continuing_time_limit_matches_the_jax_package():
    port, jax_env = _time_limited(ContinuingTimeLimit, 7), _time_limited(JaxContinuingTimeLimit, 7)
    with pytest.raises(AssertionError, match="reset"):
        port.step(0)
    infos = []
    for env in (port, jax_env):
        env.reset()
        infos.append([env.step(1)[3].get("needs_reset", False) for _ in range(9)])
    assert infos[0] == infos[1] == [False] * 6 + [True] * 3
    assert port._elapsed_steps == 9  # never restarts by itself
    port.reset()
    assert port._elapsed_steps == 0 and not port.step(1)[2]
    assert port.unwrapped.get_action_meanings() == jax_env.unwrapped.get_action_meanings()  # delegated
    port.seed(11)
    assert port.env._pending_seed == 11


def test_half_built_continuing_time_limit_raises_attribute_error():
    env = _time_limited(ContinuingTimeLimit, 5)
    blank = ContinuingTimeLimit.__new__(ContinuingTimeLimit)
    with pytest.raises(AttributeError):
        blank.seed  # noqa: B018
    clone = copy.copy(env)
    assert clone.env is env.env and clone._max_episode_steps == 5
    limit = pickle.loads(pickle.dumps(ContinuingTimeLimit(_SeedOnly(), 3)))
    assert limit._max_episode_steps == 3 and limit.seed() == "seeded"


class _SeedOnly:
    observation_space = action_space = None

    def seed(self):
        return "seeded"


def test_a_real_id_raises_naming_gymnasiums_error():
    for w in (twrappers, jwrappers):
        with pytest.raises(RuntimeError, match=r"gymnasium\.make\('BreakoutNoFrameskip-v4'\)") as info:
            w.make_atari("BreakoutNoFrameskip-v4")
        assert "BreakoutNoFrameskip-v4" in str(info.value)


def test_standin_chain_without_gymnasium_equals_make_atari(tmp_path):
    """``make_standin_atari`` (what ``chip_smoke.py`` runs where gymnasium
    is not installed) in a fresh process where gymnasium cannot be imported:
    the same rollout as ``make_atari``'s chain here, no torch loaded."""
    code = (
        "import sys, pickle\n"
        f"sys.path[:0] = [{REPO!r}, {TESTS!r}]\n"
        "sys.modules['gymnasium'] = None\n"
        "import numpy as np, torch_ale_standin as s\n"
        "from pfrl_tpu_torch.wrappers import atari_wrappers as w\n"
        "assert s.gymnasium is None\n"
        "try:\n"
        "    w.make_atari(s.ENV_ID)\n"
        "except RuntimeError as e:\n"
        "    assert 'gymnasium' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('make_atari built an env without gymnasium')\n"
        "env = w.wrap_deepmind(s.make_standin_atari(s.ENV_ID, 500), channel_order='hwc')\n"
        "env.seed(5)\n"
        "rs = np.random.RandomState(0)\n"
        "out = [np.asarray(env.reset())]\n"
        "for _ in range(150):\n"
        "    o, r, d, i = env.step(int(rs.randint(0, 4)))\n"
        "    out.append((np.asarray(o), r, d, i.get('needs_reset', False)))\n"
        "    if d or i.get('needs_reset', False):\n"
        "        out.append(np.asarray(env.reset()))\n"
        "assert 'torch' not in sys.modules, 'torch was imported'\n"
        f"pickle.dump(out, open({str(tmp_path / 'out.pkl')!r}, 'wb'))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    got = pickle.load(open(tmp_path / "out.pkl", "rb"))
    env = twrappers.wrap_deepmind(twrappers.make_atari(ENV_ID, 500), channel_order="hwc")
    env.seed(5)
    rs = np.random.RandomState(0)
    want = [np.asarray(env.reset())]
    for _ in range(150):
        o, r, d, i = env.step(int(rs.randint(0, 4)))
        want.append((np.asarray(o), r, d, i.get("needs_reset", False)))
        if d or i.get("needs_reset", False):
            want.append(np.asarray(env.reset()))
    assert len(got) == len(want) > 151
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]
        else:
            np.testing.assert_array_equal(g, w)
    direct = twrappers.wrap_deepmind(make_standin_atari(ENV_ID, 500), channel_order="hwc")
    direct.seed(5)
    np.testing.assert_array_equal(np.asarray(direct.reset()), want[0])


def test_make_atari_chain_builds_in_a_spawned_worker():
    factory = functools.partial(twrappers.make_atari_deepmind, ENV_ID, False, 3)
    venv = MultiprocessVectorEnv([factory, functools.partial(twrappers.make_atari_deepmind, ENV_ID, True, 4,
                                                             randomize_action=0.05)])
    try:
        here = factory()
        obs = venv.reset()
        np.testing.assert_array_equal(np.asarray(obs[0]), np.asarray(here.reset()))
        for a in (1, 2, 3, 0, 2):
            obs, rewards, dones, _ = venv.step([a, 0])
            o, r, d, _ = here.step(a)
            np.testing.assert_array_equal(np.asarray(obs[0]), np.asarray(o))
            assert (rewards[0], dones[0]) == (r, d)
        assert venv.action_space.n == 4 and np.asarray(obs[1]).shape == (84, 84, 4)
    finally:
        venv.close()
