"""An ALE-shaped stand-in game for ``make_atari``, shared by the port's tests
and ``chip_smoke.py``: a test double, not a part of either package.

``ALEStandIn`` has the surface that ``make_atari`` and ``wrap_deepmind``
read from an ALE game built by gymnasium: 210x160x3 uint8 RGB frames,
``Discrete(4)`` actions whose meanings start ``NOOP, FIRE``, ``ale.lives()``
that drop on a schedule (game over at the last life), ``np_random`` seeded by
``reset(seed=...)`` (and from ``seed=0`` at construction, so that an unseeded
env repeats itself), the keyword arguments ``make_atari`` passes
(``obs_type``, ``frameskip``, ``repeat_action_probability``,
``full_action_space``), and gymnasium's 5-tuple ``step``. Frames and rewards
follow from the seed, the step count and the action; ``render()`` returns the
frame.

On import it registers ``ALEStandIn-v0`` with gymnasium, where gymnasium is
installed. Build it as ``make_atari(ENV_ID)``, ``"torch_ale_standin:ALEStandIn-v0"``:
gymnasium's ``"module:Id"`` form imports this module first, and so
registers the id in any process, the spawned workers of
``MultiprocessVectorEnv`` included (gymnasium's registry is per process).
The module must be importable as ``torch_ale_standin``: pytest puts
``tests/`` on ``sys.path``, a spawned worker inherits its parent's path,
and ``chip_smoke.py`` adds ``tests/`` itself. Where gymnasium is not installed the class is a
plain object with the same surface, and :func:`make_atari_chain` builds
``make_atari``'s chain over it. The module imports neither torch nor JAX.
"""

import numpy as np

try:
    import gymnasium
    from gymnasium import spaces as _spaces
except ImportError:
    gymnasium = None

ENV_NAME = "ALEStandIn-v0"
ENV_ID = f"torch_ale_standin:{ENV_NAME}"
MEANINGS = ("NOOP", "FIRE", "RIGHT", "LEFT")


class _Box:
    def __init__(self, shape):
        self.shape, self.dtype, self.low, self.high = shape, np.dtype(np.uint8), 0, 255


class _Discrete:
    def __init__(self, n):
        self.n, self.shape, self.dtype = n, (), np.dtype(np.int64)


class _ALE:
    def __init__(self, game):
        self._game = game

    def lives(self):
        return self._game._lives


class ALEStandIn(gymnasium.Env if gymnasium is not None else object):
    """The stand-in game: ``lives`` lives of ``life_len`` frames each."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, obs_type="image", frameskip=1, repeat_action_probability=0.0, full_action_space=False,
                 lives=3, life_len=157, render_mode=None):
        if obs_type != "image" or frameskip != 1 or repeat_action_probability != 0.0 or full_action_space:
            raise ValueError("the stand-in models make_atari's settings only")
        shape = (210, 160, 3)
        if gymnasium is not None:
            self.observation_space = _spaces.Box(0, 255, shape, np.uint8)
            self.action_space = _spaces.Discrete(len(MEANINGS))
        else:
            self.observation_space, self.action_space = _Box(shape), _Discrete(len(MEANINGS))
        self.render_mode = render_mode
        self.ale = _ALE(self)
        self._lives0, self._life_len = lives, life_len
        self._seed(0)
        self._t, self._lives = 0, lives

    def _seed(self, seed):
        self._np_random = np.random.default_rng(seed)
        self._base = np.random.RandomState(seed).randint(0, 256, (210, 160, 3), dtype=np.uint8)

    @property
    def np_random(self):
        return self._np_random

    @property
    def unwrapped(self):
        return self

    def get_action_meanings(self):
        return list(MEANINGS)

    def _frame(self):
        return self._base + np.uint8((self._t * 3) & 0xFF)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._seed(seed)
        self._t, self._lives = 0, self._lives0
        return self._frame(), {"lives": self._lives}

    def step(self, action):
        self._t += 1
        if self._t % self._life_len == 0:
            self._lives -= 1
        reward = float((self._t % 7 == 0) * (int(action) - 1))
        return self._frame(), reward, self._lives == 0, False, {"lives": self._lives}

    def render(self):
        return self._frame()

    def close(self):
        pass


def make_atari_chain(max_frames=None, **kwargs):
    """``make_atari``'s chain over a stand-in built directly, behind the
    port's ``GymnasiumEnv`` adapter (through ``atari_wrappers._atari_chain``,
    the helper ``make_atari`` calls): where gymnasium is not installed."""
    from pfrl_tpu_torch.envs.gymnasium_env import GymnasiumEnv
    from pfrl_tpu_torch.wrappers import atari_wrappers

    env = GymnasiumEnv(ALEStandIn(**kwargs))
    return atari_wrappers._atari_chain(env, atari_wrappers.MAX_FRAMES if max_frames is None else max_frames)


def make_standin_atari(env_id, max_frames=None):
    """A stand-in for ``atari_wrappers.make_atari(env_id, max_frames)``
    where gymnasium is not installed: :func:`make_atari_chain`, for
    ``env_id`` the stand-in's only."""
    if env_id not in (ENV_ID, ENV_NAME):
        raise ValueError(f"the stand-in is {ENV_ID!r}, not {env_id!r}")
    return make_atari_chain(max_frames)


if gymnasium is not None and ENV_NAME not in gymnasium.registry:
    gymnasium.register(id=ENV_NAME, entry_point=ALEStandIn)
