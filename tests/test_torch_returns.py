"""``pfrl_tpu_torch/ops/returns.py`` against ``pfrl_tpu/ops/returns.py`` on
the same numpy inputs: discounted returns (with and without ``done``, with a
``[B]`` and a per-step ``[T, B]`` bootstrap), GAE, TD(lambda) returns and the
n-step window fold.

The rollouts hold terminations, truncations (``done`` without
``terminated``) and episode ends in the middle and at the last step.
Tolerances: 1e-6 relative and 1e-6 absolute (float32 recursions over 16
steps; XLA may fuse a product into an add where torch rounds it);
flags and step counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfrl_tpu.ops import returns as jreturns
from pfrl_tpu_torch.ops import returns

torch.set_num_threads(1)

T, B = 16, 5
RTOL, ATOL = 1e-6, 1e-6


def rollout(seed):
    rs = np.random.RandomState(seed)
    terminated = rs.uniform(size=(T, B)) < 0.1
    truncated = (rs.uniform(size=(T, B)) < 0.1) & ~terminated
    terminated[T // 2, 0] = True   # an end in the middle
    truncated[T // 2, 1] = True    # a truncation in the middle
    truncated[-1, 2] = True        # an episode end at the last step
    return dict(
        rewards=rs.normal(size=(T, B)).astype(np.float32),
        values=rs.normal(size=(T, B)).astype(np.float32),
        next_values=rs.normal(size=(T, B)).astype(np.float32),
        terminated=terminated,
        done=terminated | truncated,
    )


def _both(d, *names):
    return [jnp.asarray(d[n]) for n in names], [torch.from_numpy(d[n]) for n in names]


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_done", [False, True])
@pytest.mark.parametrize("per_step_bootstrap", [False, True])
def test_discounted_returns_matches_jax(seed, with_done, per_step_bootstrap):
    d = rollout(seed)
    boot = d["next_values"] if per_step_bootstrap else d["next_values"][-1]
    (jr, jt, jd), (tr, tt, td) = _both(d, "rewards", "terminated", "done")
    want = jreturns.discounted_returns(jr, jt, jnp.asarray(boot), 0.99, done=jd if with_done else None)
    got = returns.discounted_returns(tr, tt, torch.from_numpy(boot), 0.99, done=td if with_done else None)
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gamma,lambd", [(0.99, 0.95), (0.995, 0.97), (0.9, 1.0)])
def test_gae_advantages_match_jax(seed, gamma, lambd):
    d = rollout(seed)
    names = ("rewards", "values", "next_values", "terminated", "done")
    jin, tin = _both(d, *names)
    jadv, jvt = jreturns.gae_advantages(*jin, gamma, lambd)
    adv, vt = returns.gae_advantages(*tin, gamma, lambd)
    _close(adv, jadv)
    _close(vt, jvt)


def test_gae_accumulates_within_episodes_only():
    """Where ``done`` the advantage is the step's own TD error, with no
    bootstrap where ``terminated``: the recursion restarts."""
    d = rollout(3)
    adv, _ = returns.gae_advantages(*_both(d, "rewards", "values", "next_values", "terminated", "done")[1], 0.99, 0.95)
    nonterm = 1.0 - d["terminated"]
    delta = d["rewards"] + 0.99 * nonterm * d["next_values"] - d["values"]
    np.testing.assert_allclose(adv.numpy()[d["done"]], delta[d["done"]], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(adv.numpy()[-1], delta[-1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lambda_returns_match_jax(seed):
    d = rollout(seed)
    names = ("rewards", "next_values", "terminated", "done")
    jin, tin = _both(d, *names)
    _close(returns.lambda_returns(*tin, 0.99, 0.9), jreturns.lambda_returns(*jin, 0.99, 0.9))


@pytest.mark.parametrize("n", [1, 3, 5])
def test_n_step_returns_from_window_match_jax(n):
    rs = np.random.RandomState(n)
    rewards = rs.normal(size=(32, n)).astype(np.float32)
    terminals = rs.uniform(size=(32, n)) < 0.3
    jf, jdisc, jterm = jreturns.n_step_returns_from_window(jnp.asarray(rewards), jnp.asarray(terminals), 0.99)
    f, disc, term = returns.n_step_returns_from_window(torch.from_numpy(rewards), torch.from_numpy(terminals), 0.99)
    _close(f, jf)
    _close(disc, jdisc)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    assert term.any() and not term.all()
