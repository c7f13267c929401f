"""In-place env patching helpers (counterpart of
``pfrl_tpu/utils/env_modifiers.py``; reference API:
pfrl/utils/env_modifiers.py).

The reference mutates ``env.step``/``env.reset`` in place; these helpers
keep that API for quick host-side experiments, as step transforms over one
patching helper. The wrapper classes of ``pfrl_tpu_torch/wrappers`` compose
and pickle; for the device envs use ``pfrl_tpu_torch/envs/wrappers.py``.
"""

import numpy as np


def _patch_step(env, transform):
    """Replace ``env.step`` with ``lambda a: transform(base_step, a)``."""
    base = env.step
    env.step = lambda action: transform(base, action)


def make_action_filtered(env, action_filter):
    """Pass every action through ``action_filter`` before stepping."""
    _patch_step(env, lambda base, a: base(action_filter(a)))


def make_reward_filtered(env, reward_filter):
    """Pass every reward through ``reward_filter``
    (see pfrl_tpu_torch.utils.reward_filter)."""

    def transform(base, a):
        obs, reward, done, info = base(a)
        return obs, reward_filter(reward), done, info

    _patch_step(env, transform)


def make_reward_clipped(env, low, high):
    """Clip rewards to ``[low, high]``."""
    make_reward_filtered(env, lambda r: float(np.clip(r, low, high)))


def make_action_repeated(env, n_times):
    """Repeat each received action up to ``n_times`` (stop early on done),
    accumulating rewards and returning the latest observation."""

    def transform(base, a):
        total = 0.0
        for _ in range(n_times):
            obs, reward, done, info = base(a)
            total += reward
            if done:
                break
        return obs, total, done, info

    _patch_step(env, transform)


def make_timestep_limited(env, timestep_limit):
    """Force ``done=True`` once ``timestep_limit`` steps have elapsed;
    the counter rewinds on reset."""
    box = {"t": 1}

    def transform(base, a):
        obs, reward, done, info = base(a)
        if box["t"] >= timestep_limit:
            done = True
        box["t"] += 1
        return obs, reward, done, info

    _patch_step(env, transform)
    base_reset = env.reset

    def reset(*args, **kwargs):
        box["t"] = 1
        return base_reset(*args, **kwargs)

    env.reset = reset


def make_rendered(env, *render_args, **render_kwargs):
    """Render after every step and once more (with close=True) at close."""

    def transform(base, a):
        out = base(a)
        env.render(*render_args, **render_kwargs)
        return out

    _patch_step(env, transform)
    base_close = env.close

    def close():
        try:
            env.render(*render_args, close=True, **render_kwargs)
        except TypeError:
            pass  # newer gym renderers take no close kwarg
        base_close()

    env.close = close
