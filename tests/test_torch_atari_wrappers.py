"""The port's Atari wrappers (``pfrl_tpu_torch/wrappers/atari_wrappers.py``)
and ``SyntheticALE`` (``pfrl_tpu_torch/envs/synthetic_ale.py``) against the
JAX package's: each wrapper over two copies of one deterministic fake ALE,
and ``SyntheticALE``, ``make_warped`` and ``make_warped_stacked`` over 200
steps with resets. Observations, rewards, dones and infos are exact.
"""

import numpy as np
import pytest

from pfrl_tpu.envs import synthetic_ale as jsynthetic
from pfrl_tpu.wrappers import atari_wrappers as jwrappers
from pfrl_tpu_torch.envs import synthetic_ale as tsynthetic
from pfrl_tpu_torch.wrappers import atari_wrappers as twrappers

STEPS = 200


class FakeALE:
    """An ALE-shaped host env: 210x160x3 frames from a seed, a reward every
    few frames, lives lost on a schedule, game over at the last life; the
    ``unwrapped`` surface the wrappers read (``get_action_meanings``,
    ``np_random``, ``ale.lives``)."""

    class _Space:
        def __init__(self, shape=(210, 160, 3), n=6):
            self.shape, self.n = shape, n

    def __init__(self, seed, lives=3, life_len=11, meanings=("NOOP", "FIRE", "RIGHT", "LEFT")):
        self._seed = seed
        self._base = np.random.RandomState(seed).randint(0, 256, (210, 160, 3), dtype=np.uint8)
        self._lives0, self._life_len = lives, life_len
        self._meanings = list(meanings)
        self.observation_space = self._Space()
        self.action_space = self._Space(n=len(meanings))
        self.np_random = np.random.default_rng(seed)
        self.ale = self
        self._t = 0
        self._lives = lives

    @property
    def unwrapped(self):
        return self

    def get_action_meanings(self):
        return self._meanings

    def lives(self):
        return self._lives

    def _frame(self):
        return self._base + np.uint8((self._t * 7) & 0xFF)

    def reset(self, **kwargs):
        self._t = 0
        self._lives = self._lives0
        return self._frame()

    def step(self, action):
        self._t += 1
        if self._t % self._life_len == 0:
            self._lives -= 1
        reward = float((self._t % 5 == 0) * (action - 1.5) * 3)
        done = self._lives == 0
        return self._frame(), reward, done, {"t": self._t}

    def close(self):
        pass


def _stacks(kind, seed):
    """(port wrapper, JAX wrapper) of one kind over two copies of a fake."""
    def build(w):
        env = FakeALE(seed)
        if kind == "noop":
            return w.NoopResetEnv(env, noop_max=7)
        if kind == "fire":
            return w.FireResetEnv(env)
        if kind == "episodic_life":
            return w.EpisodicLifeEnv(env)
        if kind == "max_and_skip":
            return w.MaxAndSkipEnv(env, skip=4)
        if kind == "clip_reward":
            return w.ClipRewardEnv(env)
        if kind == "warp_hwc":
            return w.WarpFrame(env, channel_order="hwc")
        if kind == "warp_chw":
            return w.WarpFrame(env, channel_order="chw")
        if kind == "frame_stack":
            return w.FrameStack(w.WarpFrame(env, channel_order="chw"), 4, channel_order="chw")
        if kind == "scaled_float":
            return w.ScaledFloatFrame(w.WarpFrame(env))
        if kind == "deepmind":
            return w.wrap_deepmind(w.MaxAndSkipEnv(env), fire_reset=True, channel_order="hwc")
        raise ValueError(kind)

    return build(twrappers), build(jwrappers)


def _rollout(env, steps, seed):
    rs = np.random.RandomState(seed)
    out = [("reset", np.asarray(env.reset()))]
    for _ in range(steps):
        obs, reward, done, info = env.step(int(rs.randint(0, 4)))
        out.append((np.asarray(obs), reward, done, info))
        if done:
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


KINDS = ["noop", "fire", "episodic_life", "max_and_skip", "clip_reward", "warp_hwc", "warp_chw", "frame_stack",
         "scaled_float", "deepmind"]


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_matches_the_jax_package(kind):
    port, jax_env = _stacks(kind, seed=3)
    got, want = _rollout(port, 60, 0), _rollout(jax_env, 60, 0)
    _assert_same(got, want)
    assert any(isinstance(g[0], str) for g in got[1:]), "no reset inside the run"
    assert port.observation_space.shape == jax_env.observation_space.shape
    if kind == "episodic_life":  # a life lost ends the episode, game over resets
        assert sum(1 for g in got if isinstance(g[0], str)) > 3


def test_flicker_frame_blanks_like_the_jax_package():
    port, jax_env = (w.FlickerFrame(FakeALE(1)) for w in (twrappers, jwrappers))
    port._rng = np.random.RandomState(5)
    jax_env._rng = np.random.RandomState(5)
    got, want = _rollout(port, 40, 1), _rollout(jax_env, 40, 1)
    _assert_same(got, want)
    blank = [g for g in got if not isinstance(g[0], str) and not g[0].any()]
    assert 0 < len(blank) < 40


def test_lazy_frames_concatenate_along_the_stack_axis():
    frames = [np.full((84, 84, 1), i, np.uint8) for i in range(4)]
    stacked = np.asarray(twrappers.LazyFrames(frames, stack_axis=2))
    assert stacked.shape == (84, 84, 4) and (stacked[0, 0] == [0, 1, 2, 3]).all()
    assert np.asarray(twrappers.LazyFrames(frames, stack_axis=2), dtype=np.float32).dtype == np.float32


@pytest.mark.parametrize("factory", ["make_raw", "make_warped", "make_warped_stacked"])
def test_synthetic_ale_factories_match_the_jax_package(factory):
    port, jax_env = getattr(tsynthetic, factory)(7), getattr(jsynthetic, factory)(7)
    assert port.action_space.n == jax_env.action_space.n == 6
    resets = 0
    rs = np.random.RandomState(2)
    got, want = np.asarray(port.reset()), np.asarray(jax_env.reset())
    np.testing.assert_array_equal(got, want)
    for i in range(STEPS):
        action = int(rs.randint(0, 6))
        (o1, r1, d1, _), (o2, r2, d2, _) = port.step(action), jax_env.step(action)
        np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
        assert (r1, d1) == (r2, d2)
        if d1 or i % 60 == 59:  # the episodes average 1,000 frames: reset some on the way
            resets += 1
            np.testing.assert_array_equal(np.asarray(port.reset()), np.asarray(jax_env.reset()))
    assert resets >= 3
    shape = {"make_raw": (210, 160, 3), "make_warped": (84, 84, 1), "make_warped_stacked": (84, 84, 4)}[factory]
    assert np.asarray(o1).shape == shape and np.asarray(o1).dtype == np.uint8


def test_synthetic_ale_episodes_end_like_the_jax_package():
    port, jax_env = tsynthetic.SyntheticALE(4, mean_len=9), jsynthetic.SyntheticALE(4, mean_len=9)
    _assert_same(_rollout(port, STEPS, 3), _rollout(jax_env, STEPS, 3))
