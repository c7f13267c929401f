"""Gymnasium (and legacy gym) adapter onto the host ``Env`` protocol
(counterpart of ``pfrl_tpu/envs/gymnasium_env.py``).

The host contract is ``step() -> (obs, reward, done, info)`` with
``info["needs_reset"]`` for truncation, so the gymnasium API maps onto it:

* ``reset() -> (obs, info)``  ->  ``reset() -> obs``
* ``terminated``              ->  ``done`` (no bootstrap through it)
* ``truncated``               ->  ``info["needs_reset"] = True``
* ``reset(seed=...)``         ->  ``seed(s)`` stores the seed; the next
  ``reset()`` consumes it.

A legacy gym env (4-tuple ``step``) is detected by the arity of what it
returns, and its ``info["TimeLimit.truncated"]`` becomes ``needs_reset``.
gymnasium is imported when :func:`make_gymnasium_env` is called, never at
import: a machine without it can import the port. This module imports no
torch, so a ``MultiprocessVectorEnv`` worker can build these envs.
"""

from typing import Any, Optional

from pfrl_tpu_torch.env import Env


class GymnasiumEnv(Env):
    """An instantiated gymnasium (or legacy gym) env as a host ``Env``. The
    inner env's spaces are exposed as they are, and unknown attributes
    reach the inner env."""

    def __init__(self, env: Any, seed: Optional[int] = None):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._pending_seed = seed

    def seed(self, seed: Optional[int] = None):
        self._pending_seed = seed

    def reset(self):
        kwargs = {}
        if self._pending_seed is not None:
            kwargs["seed"] = self._pending_seed
            self._pending_seed = None
        try:
            out = self.env.reset(**kwargs)
        except TypeError:
            # Legacy gym: reset() takes no seed; it seeds through .seed().
            if "seed" in kwargs:
                self.env.seed(kwargs["seed"])
            out = self.env.reset()
        if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
            return out[0]
        return out

    def step(self, action):
        out = self.env.step(action)
        if len(out) == 5:
            obs, reward, terminated, truncated, info = out
            info = dict(info)
            if truncated:
                info["needs_reset"] = True
            return obs, float(reward), bool(terminated), info
        # Legacy 4-tuple: done conflates termination and truncation; gym's
        # TimeLimit marks the latter in info["TimeLimit.truncated"].
        obs, reward, done, info = out
        info = dict(info)
        if info.get("TimeLimit.truncated", False):
            info["needs_reset"] = True
            done = False
        return obs, float(reward), bool(done), info

    def render(self, *args, **kwargs):
        return self.env.render(*args, **kwargs)

    def close(self):
        self.env.close()

    def __getattr__(self, name):
        return getattr(self.env, name)


def make_gymnasium_env(env_id: str, seed: Optional[int] = None, **make_kwargs) -> GymnasiumEnv:
    """``gym.make`` for the host drivers: ``gymnasium.make`` first, then
    legacy ``gym.make``. Raises a RuntimeError naming what is missing when
    neither builds ``env_id``; it never stands in a simulator of its own."""
    errors = []
    try:
        import gymnasium

        return GymnasiumEnv(gymnasium.make(env_id, **make_kwargs), seed=seed)
    except ImportError as e:
        errors.append(f"gymnasium: {e}")
    except Exception as e:  # an unknown id, missing extras
        errors.append(f"gymnasium.make({env_id!r}): {type(e).__name__}: {e}")
    try:
        import gym

        return GymnasiumEnv(gym.make(env_id, **make_kwargs), seed=seed)
    except ImportError as e:
        errors.append(f"gym: {e}")
    except Exception as e:
        errors.append(f"gym.make({env_id!r}): {type(e).__name__}: {e}")
    raise RuntimeError(
        f"Could not build real environment {env_id!r}. Tried: " + "; ".join(errors)
        + ". Install gymnasium (plus any env extras), or run one of the port's device envs "
        "through envs.HostTorchEnv."
    )
