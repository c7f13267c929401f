"""Raw-Atari-shaped synthetic host env for pipeline benchmarks and tests
(counterpart of ``pfrl_tpu/envs/synthetic_ale.py``).

Stands in for ALE (a host-CPU workload in every framework) so pipeline
measurements isolate the framework's host<->device path, not the emulator.
Produces 210x160x3 uint8 frames via a cheap numpy pattern, geometric
episode lengths, and the gym 4-tuple step API the Atari wrapper stack
expects (reference workload shape: pfrl/wrappers/atari_wrappers.py:23-325).

Top-level factories (``make_raw``, ``make_warped``, ``make_warped_stacked``,
``make_ale_env``) are spawn-picklable so actor processes can build their own envs. Neither
this module nor the wrappers it builds import torch, so unpickling a
factory in an actor process loads none.
"""

import numpy as np


class _Space:
    def __init__(self, n=6, shape=(210, 160, 3)):
        self.n = n
        self.shape = shape
        self.low = None
        self.high = None


class SyntheticALE:
    """210x160x3 uint8 frames; episode lengths ~ Geometric(1/mean_len)."""

    def __init__(self, seed=0, n_actions=6, mean_len=1000):
        self._rng = np.random.RandomState(seed)
        self._base = self._rng.randint(0, 256, (210, 160, 3), dtype=np.uint8)
        self._mean_len = mean_len
        self.observation_space = _Space(n_actions)
        self.action_space = _Space(n_actions)
        self._t = 0
        self._ep_len = 0

    def _frame(self):
        # Add-with-wraparound: content changes every step, costs one pass.
        return self._base + np.uint8(self._t & 0xFF)

    def reset(self, **kwargs):
        self._t = 0
        self._ep_len = int(self._rng.geometric(1.0 / self._mean_len))
        return self._frame()

    def step(self, action):
        self._t += 1
        reward = 1.0 if (self._t % 37) == 0 else 0.0
        done = self._t >= self._ep_len
        return self._frame(), reward, done, {}

    def close(self):
        pass


def make_raw(seed=0):
    return SyntheticALE(seed)


def make_warped(seed=0):
    """SyntheticALE -> MaxAndSkip -> WarpFrame (the C++ frame ops): emits
    [84, 84, 1] uint8 planes — the per-step upload unit of the device
    pipeline (frame stacking happens on the device)."""
    from pfrl_tpu_torch.wrappers import atari_wrappers

    env = atari_wrappers.MaxAndSkipEnv(SyntheticALE(seed), skip=4)
    env = atari_wrappers.ClipRewardEnv(env)
    return atari_wrappers.WarpFrame(env, channel_order="hwc")


def make_warped_stacked(seed=0):
    """Full classic host stack incl. host-side FrameStack ([84,84,4]) —
    for the threads-path pipeline and A/B comparisons."""
    from pfrl_tpu_torch.wrappers import atari_wrappers

    env = atari_wrappers.MaxAndSkipEnv(SyntheticALE(seed), skip=4)
    return atari_wrappers.wrap_deepmind(
        env, episode_life=False, channel_order="hwc"
    )


def make_ale_env(seed=0, idx=0, test=False):
    """``examples/atari/train_dqn_batch_ale.py``'s ``make_ale_env`` with
    ``MaxAndSkipEnv(SyntheticALE(...), skip=4)`` in place of
    ``make_atari(args.env)``: ``wrap_deepmind`` (84x84x4 uint8 stacks, hwc;
    rewards clipped in training), seeded ``seed + idx`` (``+ 10**6`` for an
    evaluation env), and an evaluation env takes a random action 5% of the
    time (``RandomizeAction``, unseeded as in the example). SyntheticALE has
    no lives, so ``EpisodicLifeEnv`` cannot wrap it: training runs with
    ``episode_life=False``, the one change from the example."""
    from pfrl_tpu_torch.wrappers import RandomizeAction, atari_wrappers

    env = atari_wrappers.MaxAndSkipEnv(SyntheticALE(seed + idx + (10**6 if test else 0)), skip=4)
    env = atari_wrappers.wrap_deepmind(env, episode_life=False, clip_rewards=not test, channel_order="hwc")
    if test:
        env = RandomizeAction(env, 0.05)
    return env
