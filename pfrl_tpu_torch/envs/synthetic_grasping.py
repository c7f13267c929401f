"""The grasping example's host envs (``examples/grasping/
train_dqn_batch_grasping.py:56-158``): :class:`SyntheticGraspingEnv`, and
:func:`make_grasping_env`, the script's ``make_env``.

Observations are ``(image, elapsed_steps)`` tuples: an 84x84x3 float32
image and a python int. The module imports numpy only, never torch: the
spawned workers of ``MultiprocessVectorEnv`` unpickle
``functools.partial(make_grasping_env, ...)`` and import it (ROADMAP C52).
"""

import numpy as np


class SyntheticGraspingEnv:
    """The grasping observation and action structure without pybullet.

    A graspable object occupies one of ``n_actions`` bins; picking its bin
    within the episode yields +1 and ends it. The bin is a bright column of
    the image, with uniform noise in [0, 0.1) over every pixel drawn from
    the env's own ``RandomState``, in the script's order, so that one seed
    gives the very same episodes here and in the JAX script.
    """

    class _Discrete:
        def __init__(self, n):
            self.n = n

        def sample(self):
            return np.random.randint(self.n)

    def __init__(self, n_actions=10, max_episode_steps=8, seed=0):
        self.action_space = self._Discrete(n_actions)
        self.observation_space = None  # a structured (image, steps) tuple
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.RandomState(seed)
        self._target = 0
        self._t = 0

    def _obs(self):
        img = np.zeros((84, 84, 3), np.float32)
        w = 84 // self.action_space.n
        img[:, self._target * w: (self._target + 1) * w, :] = 1.0
        img += self._rng.uniform(0, 0.1, img.shape).astype(np.float32)
        return (img, self._t)

    def reset(self):
        self._target = int(self._rng.randint(self.action_space.n))
        self._t = 0
        return self._obs()

    def step(self, action):
        self._t += 1
        success = int(action) == self._target
        done = success or self._t >= self.max_episode_steps
        return self._obs(), float(success), done, {}

    def seed(self, seed=None):
        self._rng = np.random.RandomState(seed)

    def close(self):
        pass


class _KukaObservations:
    """The script's wrapper of ``KukaDiverseObjectEnv``: int actions, HWC
    float32 images, the elapsed steps appended."""

    def __init__(self, env, max_steps):
        self.env = env
        self.action_space = env.action_space
        self.observation_space = None
        self._max_steps = max_steps
        self._t = 0

    def reset(self):
        self._t = 0
        return (np.asarray(self.env.reset(), np.float32), self._t)

    def step(self, action):
        obs, r, done, info = self.env.step(int(action))
        self._t += 1
        return (np.asarray(obs, np.float32), self._t), r, done, info

    def close(self):
        self.env.close()

    def seed(self, seed=None):
        return self.env.seed(seed)


def make_grasping_env(jax_env: bool, max_episode_steps: int, seed: int, test: bool, render: bool = False,
                      demo: bool = False):
    """The script's ``make_env``: :class:`SyntheticGraspingEnv` with
    ``jax_env`` (the script's ``--jax-env``, the in-repo simulator), else
    pybullet's ``KukaDiverseObjectEnv`` (84x84, discrete). Without pybullet
    it raises ``RuntimeError`` naming it and the flag, never falling back."""
    if jax_env:
        return SyntheticGraspingEnv(max_episode_steps=max_episode_steps, seed=int(seed))
    try:
        import gym  # noqa: F401
        from pybullet_envs.bullet.kuka_diverse_object_gym_env import KukaDiverseObjectEnv
    except ImportError as e:
        raise RuntimeError(
            f"pybullet grasping env unavailable ({e}); pass --jax-env to train the in-repo synthetic "
            "grasping simulator explicitly"
        ) from e
    env = KukaDiverseObjectEnv(isDiscrete=True, renders=render and (demo or not test), height=84, width=84,
                               maxSteps=max_episode_steps, isTest=test)
    # Disable file caching to avoid a pybullet multiprocessing bug.
    env.cid = env._p.connect(env._p.DIRECT if not env.cid else env.cid)
    env.seed(int(seed))
    return _KukaObservations(env, max_episode_steps)
