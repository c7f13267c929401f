"""Atari preprocessing wrappers (counterpart of
``pfrl_tpu/wrappers/atari_wrappers.py``; reference parity:
pfrl/wrappers/atari_wrappers.py:23-325).

Fork-of-Baselines stack: NoopReset, FireReset, EpisodicLife, MaxAndSkip,
ClipReward, WarpFrame (84x84 grayscale), FrameStack with LazyFrames,
ScaledFloatFrame, FlickerFrame, and the ``make_atari``/``wrap_deepmind``
factories. They wrap a *host* env with the gym 4-tuple step API: an ALE
game through gymnasium (``make_atari``), or ``SyntheticALE``. WarpFrame and
MaxAndSkip run on the native C++ frame ops (:mod:`pfrl_tpu_torch.runtime`),
which raise when they cannot be built: no numpy fallback on this path.

The module imports no torch: the Atari pipeline's actor processes and the
workers of ``MultiprocessVectorEnv`` run it. The examples' env factories
(:func:`make_atari_deepmind`, :func:`make_ale_plane_env`) live here, at
module level, so that they pickle into spawned workers.
"""

from collections import deque

import numpy as np

from pfrl_tpu_torch import runtime, spaces
from pfrl_tpu_torch.env import Env


class LazyFrames:
    """Hold references to frames; concatenate only when materialized
    (``pfrl_tpu/wrappers/vector_frame_stack.py:17``; reference:
    pfrl/wrappers/atari_wrappers.py:251-272)."""

    def __init__(self, frames, stack_axis=0):
        self._frames = list(frames)
        self.stack_axis = stack_axis

    def __array__(self, dtype=None, copy=None):
        # Concatenate, not stack: WarpFrame emits frames with a singleton
        # channel axis ((84,84,1) hwc / (1,84,84) chw), so k frames join
        # along that axis into (84,84,k) / (k,84,84).
        out = np.concatenate(self._frames, axis=self.stack_axis)
        if dtype is not None:
            out = out.astype(dtype)
        return out


class _GymWrapper(Env):
    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)

    def close(self):
        self.env.close()

    def __getattr__(self, name):
        return getattr(self.env, name)


class NoopResetEnv(_GymWrapper):
    """Random number of no-ops after reset (:23-52)."""

    def __init__(self, env, noop_max=30):
        super().__init__(env)
        self.noop_max = noop_max
        self.override_num_noops = None
        self.noop_action = 0
        assert env.unwrapped.get_action_meanings()[0] == "NOOP"

    def reset(self, **kwargs):
        obs = self.env.reset(**kwargs)
        noops = (
            self.override_num_noops
            if self.override_num_noops is not None
            else self.env.unwrapped.np_random.integers(1, self.noop_max + 1)
        )
        for _ in range(noops):
            obs, _, done, _ = self.env.step(self.noop_action)
            if done:
                obs = self.env.reset(**kwargs)
        return obs


class FireResetEnv(_GymWrapper):
    """Press FIRE after reset for envs that need it (:55-70)."""

    def __init__(self, env):
        super().__init__(env)
        assert env.unwrapped.get_action_meanings()[1] == "FIRE"
        assert len(env.unwrapped.get_action_meanings()) >= 3

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        obs, _, done, _ = self.env.step(1)
        if done:
            self.env.reset(**kwargs)
        obs, _, done, _ = self.env.step(2)
        if done:
            self.env.reset(**kwargs)
        return obs


class EpisodicLifeEnv(_GymWrapper):
    """End episodes on life loss, reset only on true game over (:73-113)."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.needs_real_reset = True

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self.needs_real_reset = done or info.get("needs_reset", False)
        lives = self.env.unwrapped.ale.lives()
        if 0 < lives < self.lives:
            done = True
        self.lives = lives
        return obs, reward, done, info

    def reset(self, **kwargs):
        if self.needs_real_reset:
            obs = self.env.reset(**kwargs)
        else:
            obs, _, _, _ = self.env.step(0)
        self.lives = self.env.unwrapped.ale.lives()
        return obs


class MaxAndSkipEnv(_GymWrapper):
    """Repeat action 4x, max over last two frames (:116-145)."""

    def __init__(self, env, skip=4):
        super().__init__(env)
        self._obs_buffer = np.zeros(
            (2,) + env.observation_space.shape, dtype=np.uint8
        )
        self._skip = skip

    def step(self, action):
        total_reward = 0.0
        done = False
        info = {}
        for i in range(self._skip):
            obs, reward, done, info = self.env.step(action)
            if i == self._skip - 2:
                self._obs_buffer[0] = obs
            if i == self._skip - 1:
                self._obs_buffer[1] = obs
            total_reward += reward
            if done:
                break
        max_frame = runtime.frame_max(self._obs_buffer[0], self._obs_buffer[1])
        return max_frame, total_reward, done, info


class ClipRewardEnv(_GymWrapper):
    """Reward -> sign(reward) (:148-156)."""

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return obs, np.sign(reward), done, info


class WarpFrame(_GymWrapper):
    """Grayscale + resize to 84x84 (:159-183)."""

    width = 84
    height = 84

    def __init__(self, env, channel_order="hwc"):
        super().__init__(env)
        self.channel_order = channel_order
        shape = {
            "hwc": (self.height, self.width, 1),
            "chw": (1, self.height, self.width),
        }[channel_order]
        self.observation_space = spaces.box(0, 255, shape)

    def _observation(self, frame):
        frame = runtime.warp_frames(
            np.asarray(frame)[None], self.height, self.width
        )[0]
        if self.channel_order == "hwc":
            return frame[:, :, None]
        return frame[None, :, :]

    def reset(self, **kwargs):
        return self._observation(self.env.reset(**kwargs))

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return self._observation(obs), reward, done, info


class FrameStack(_GymWrapper):
    """Stack the last k frames as LazyFrames (:186-221)."""

    def __init__(self, env, k, channel_order="hwc"):
        super().__init__(env)
        self.k = k
        self.frames = deque([], maxlen=k)
        self.stack_axis = {"hwc": 2, "chw": 0}[channel_order]

    def reset(self, **kwargs):
        ob = self.env.reset(**kwargs)
        for _ in range(self.k):
            self.frames.append(ob)
        return self._get_ob()

    def step(self, action):
        ob, reward, done, info = self.env.step(action)
        self.frames.append(ob)
        return self._get_ob(), reward, done, info

    def _get_ob(self):
        assert len(self.frames) == self.k
        return LazyFrames(list(self.frames), stack_axis=self.stack_axis)


class ScaledFloatFrame(_GymWrapper):
    """uint8 -> float32 in [0, 1] (:224-242). Prefer doing this in the
    agent's phi: scaling in the wrapper multiplies replay memory by 4."""

    def _observation(self, obs):
        return np.asarray(obs, dtype=np.float32) / 255.0

    def reset(self, **kwargs):
        return self._observation(self.env.reset(**kwargs))

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return self._observation(obs), reward, done, info


class FlickerFrame(_GymWrapper):
    """Randomly black out frames (DRQN's flickering Atari, :245-258)."""

    def __init__(self, env):
        super().__init__(env)
        self._rng = np.random.RandomState()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if self._rng.rand() < 0.5:
            obs = np.zeros_like(obs)
        return obs, reward, done, info


MAX_FRAMES = 30 * 60 * 60  # 108,000 raw frames: 30 minutes at 60 frames per second


def _atari_chain(env, max_frames=MAX_FRAMES):
    """``make_atari``'s wrappers around an ALE-shaped host env (a
    ``GymnasiumEnv`` from ``make_gymnasium_env``, or any env with its
    surface: ``unwrapped.get_action_meanings()``, ``unwrapped.np_random``,
    ``seed``): the time limit on raw frames (before the skip), 1 to 30
    no-ops after each reset, each action repeated 4 times and the last two
    frames maxed."""
    from pfrl_tpu_torch.wrappers.continuing_time_limit import ContinuingTimeLimit

    if max_frames:
        env = ContinuingTimeLimit(env, max_episode_steps=max_frames)
    env = NoopResetEnv(env, noop_max=30)
    return MaxAndSkipEnv(env, skip=4)


def make_atari(env_id, max_frames=MAX_FRAMES):
    """``pfrl_tpu/wrappers/atari_wrappers.py:234-248`` (reference:
    pfrl/wrappers/atari_wrappers.py:288-301): the ALE game ``env_id``
    through gymnasium (no frame skip, no sticky actions, the minimal action
    set) under :func:`_atari_chain`. Without ``ale_py`` and its ROMs (or
    without gymnasium) it raises the ``RuntimeError`` of
    ``make_gymnasium_env``, which names gymnasium's error; it never stands
    in a simulator of its own."""
    from pfrl_tpu_torch.envs.gymnasium_env import make_gymnasium_env

    env = make_gymnasium_env(
        env_id, obs_type="image", frameskip=1,
        repeat_action_probability=0.0, full_action_space=False,
    )
    return _atari_chain(env, max_frames)


def wrap_deepmind(
    env,
    episode_life=True,
    clip_rewards=True,
    frame_stack=True,
    scale=False,
    fire_reset=False,
    channel_order="chw",
    flicker=False,
):
    """DeepMind-style wrapper stack (:304-325)."""
    if episode_life:
        env = EpisodicLifeEnv(env)
    if fire_reset and "FIRE" in env.unwrapped.get_action_meanings():
        env = FireResetEnv(env)
    env = WarpFrame(env, channel_order=channel_order)
    if scale:
        env = ScaledFloatFrame(env)
    if clip_rewards:
        env = ClipRewardEnv(env)
    if flicker:
        env = FlickerFrame(env)
    if frame_stack:
        env = FrameStack(env, 4, channel_order=channel_order)
    return env


def make_atari_deepmind(env_id, test=False, seed=None, max_frames=MAX_FRAMES, randomize_action=0.0,
                        make=make_atari):
    """The Atari examples' env: ``wrap_deepmind(make(env_id, max_frames),
    episode_life=not test, clip_rewards=not test, channel_order="hwc")``
    (84x84x4 uint8 stacks), seeded with ``seed`` where one is given (it
    reaches ``GymnasiumEnv.seed`` and takes effect at the next reset), and,
    for an evaluation env with ``randomize_action`` > 0, a random action
    that often (``RandomizeAction``, unseeded as in the examples).
    ``make`` builds the chain (``make_atari``, or one over another
    ALE-shaped env). Module level, so that a ``functools.partial`` of it
    pickles into a spawned worker."""
    env = wrap_deepmind(make(env_id, max_frames=max_frames), episode_life=not test, clip_rewards=not test,
                        channel_order="hwc")
    if seed is not None:
        env.seed(seed)
    if test and randomize_action:
        from pfrl_tpu_torch.wrappers.misc import RandomizeAction

        env = RandomizeAction(env, randomize_action)
    return env


def make_ale_plane_env(env_id, seed=0):
    """``examples/atari/train_dqn_pipeline_ale.py``'s ``make_ale_plane_env``
    (``:27-43``): ``make_atari(env_id)`` seeded with ``seed``, then
    MaxAndSkip -> ClipReward -> WarpFrame: [84, 84, 1] uint8 planes (the
    pipeline stacks frames on the device). As in the example, the second
    ``MaxAndSkipEnv`` sits over the one ``make_atari`` already ends in, so
    each action spans 16 raw frames."""
    env = make_atari(env_id)
    env.seed(seed)
    env = MaxAndSkipEnv(env, skip=4)
    env = ClipRewardEnv(env)
    return WarpFrame(env, channel_order="hwc")
