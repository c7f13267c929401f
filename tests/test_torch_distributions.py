"""The port's distributions against the JAX package's on the same numpy
inputs: ``Normal``, ``Delta`` and ``SquashedNormal``.

Samples take given noise: the port draws from a source that hands out the
array the JAX side gets through a replaced ``jax.random.normal``.
Tolerance: 1e-5 absolute on log-probs, entropies and KL (float32 ``log``,
``tanh``, ``atanh`` and ``softplus`` differ by an ulp between the two
libraries); samples, modes and means 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfrl_tpu import distributions as jd
from pfrl_tpu_torch import distributions as td

torch.set_num_threads(1)

ATOL = 1e-5


class GivenNormal:
    """A draw source that hands out one given array of normal noise."""

    def __init__(self, eps):
        self.eps = np.asarray(eps, np.float32)

    def normal(self, n):
        assert n == self.eps.size
        return torch.from_numpy(self.eps.reshape(-1).copy())


def _give_jax(monkeypatch, eps):
    def normal(key, shape=(), dtype=jnp.float32):
        assert tuple(shape) == eps.shape
        return jnp.asarray(eps, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


def _params(seed, shape=(7, 3)):
    rs = np.random.RandomState(seed)
    loc = rs.normal(size=shape).astype(np.float32)
    scale = np.exp(rs.uniform(-3.0, 1.0, shape)).astype(np.float32)
    return rs, loc, scale


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_normal_matches_jax(monkeypatch):
    rs, loc, scale = _params(0)
    loc2, scale2 = _params(1)[1:]
    value = rs.normal(size=loc.shape).astype(np.float32)
    eps = rs.normal(size=loc.shape).astype(np.float32)
    j, t = jd.Normal(jnp.asarray(loc), jnp.asarray(scale)), td.Normal(_t(loc), _t(scale))
    np.testing.assert_allclose(t.log_prob(_t(value)).numpy(), np.asarray(j.log_prob(value)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t.entropy().numpy(), np.asarray(j.entropy()), atol=ATOL, rtol=0)
    other_j, other_t = jd.Normal(jnp.asarray(loc2), jnp.asarray(scale2)), td.Normal(_t(loc2), _t(scale2))
    np.testing.assert_allclose(t.kl(other_t).numpy(), np.asarray(j.kl(other_j)), atol=ATOL, rtol=1e-6)
    assert t.log_prob(_t(value)).shape == (7,)
    _give_jax(monkeypatch, eps)
    key = jax.random.PRNGKey(0)
    for method in ("sample", "rsample"):
        got = getattr(t, method)(GivenNormal(eps)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(j, method)(key)), atol=1e-6, rtol=0)
    x, lp = t.sample_and_log_prob(GivenNormal(eps))
    jx, jlp = j.sample_and_log_prob(key)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=ATOL, rtol=0)
    for method in ("mode", "mean"):
        np.testing.assert_array_equal(getattr(t, method)().numpy(), np.asarray(getattr(j, method)()))


def test_delta_matches_jax():
    rs, loc, _ = _params(2)
    value = loc.copy()
    value[::2, 0] += 1.0  # every other row differs in one event dim
    j, t = jd.Delta(jnp.asarray(loc)), td.Delta(_t(loc))
    got = t.log_prob(_t(value)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j.log_prob(jnp.asarray(value))))
    assert np.isneginf(got[::2]).all() and (got[1::2] == 0).all()
    np.testing.assert_array_equal(t.entropy().numpy(), np.asarray(j.entropy()))
    for method in ("mode", "mean"):
        np.testing.assert_array_equal(getattr(t, method)().numpy(), loc)
    for method in ("sample", "rsample"):
        np.testing.assert_array_equal(getattr(t, method)(None).numpy(), loc)  # draws nothing
    x, lp = t.sample_and_log_prob(None)
    assert (lp == 0).all() and torch.equal(x, _t(loc))


@pytest.mark.parametrize("extreme", [False, True], ids=["moderate", "u_up_to_15"])
def test_squashed_normal_sample_and_log_prob_matches_jax(monkeypatch, extreme):
    rs, loc, scale = _params(3)
    eps = rs.normal(size=loc.shape).astype(np.float32)
    if extreme:
        # Pre-squash values u = loc + scale * eps spread over [-15, 15]:
        # -2u crosses torch softplus's threshold of 20 on both sides.
        u = np.linspace(-15.0, 15.0, loc.size).reshape(loc.shape).astype(np.float32)
        eps = ((u - loc) / scale).astype(np.float32)
    j = jd.SquashedNormal(jnp.asarray(loc), jnp.asarray(scale))
    t = td.SquashedNormal(_t(loc), _t(scale))
    _give_jax(monkeypatch, eps)
    x, lp = t.sample_and_log_prob(GivenNormal(eps))
    jx, jlp = j.sample_and_log_prob(jax.random.PRNGKey(0))
    if extreme:
        assert float(np.abs(np.arctanh(np.clip(np.asarray(jx, np.float64), -1 + 1e-16, 1 - 1e-16))).max()) > 10
        assert bool((np.abs(x.numpy()) == 1.0).any())  # tanh saturates in float32
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=ATOL, rtol=1e-6)
    assert np.isfinite(lp.numpy()).all()
    for method in ("sample", "rsample"):
        got = getattr(t, method)(GivenNormal(eps)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(j, method)(jax.random.PRNGKey(0))), atol=1e-6, rtol=0)


def test_squashed_normal_log_prob_of_values_up_to_the_clip_matches_jax():
    rs, loc, scale = _params(4, (9, 2))
    value = np.tanh(rs.normal(size=loc.shape)).astype(np.float32)
    value[0] = [1.0 - 1e-6, -(1.0 - 1e-6)]  # at the clip
    value[1] = [1.0, -1.0]                  # past it: clipped to it
    value[2] = [0.0, 0.999]
    j = jd.SquashedNormal(jnp.asarray(loc), jnp.asarray(scale))
    t = td.SquashedNormal(_t(loc), _t(scale))
    got, want = t.log_prob(_t(value)).numpy(), np.asarray(j.log_prob(jnp.asarray(value)))
    assert np.isfinite(got).all()
    # atanh at 1 - 1e-6 has a slope of 5e5: an ulp of the clipped value moves
    # u by 3e-2 and the log-prob with it, identically in both libraries only
    # if both clip to the same float32; they do, so the bound holds there too.
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    for method in ("mode", "mean"):
        np.testing.assert_allclose(
            getattr(t, method)().numpy(), np.asarray(getattr(j, method)()), atol=1e-6, rtol=0
        )
    with pytest.raises(NotImplementedError):
        t.entropy()
    with pytest.raises(NotImplementedError):
        j.entropy()


def test_squashed_normal_gradients_reach_loc_and_scale_like_jax():
    """The reparameterized sample and its log-prob are differentiated in
    SAC's actor loss: d/d(loc, scale) of sum(log_pi + 0.5 * x) agrees."""
    rs, loc, scale = _params(5)
    eps = rs.normal(size=loc.shape).astype(np.float32)

    def jloss(loc_, scale_):
        u = loc_ + scale_ * eps
        d = jd.SquashedNormal(loc_, scale_)
        lp = d._base().log_prob(u) - jnp.sum(2.0 * (np.log(2.0) - u - jax.nn.softplus(-2.0 * u)), axis=-1)
        return jnp.sum(lp + 0.5 * jnp.sum(jnp.tanh(u), axis=-1))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(scale))
    tl, ts = _t(loc).requires_grad_(), _t(scale).requires_grad_()
    x, lp = td.SquashedNormal(tl, ts).sample_and_log_prob(GivenNormal(eps))
    got = torch.autograd.grad((lp + 0.5 * x.sum(-1)).sum(), (tl, ts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
