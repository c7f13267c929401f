"""``Categorical``, ``kl_divergence`` and ``SoftmaxCategoricalHead`` of the
port against the JAX package's, and the Gumbel-max draw by value.

``jax.random.categorical`` samples through ``jax.random.gumbel``, whose
uniform draw is internal: replacing ``jax.random.uniform`` does not reach
it. The port draws ``u`` from the draw source and takes
``argmax(logits - log(-log(max(u, tiny))))``; fed the very uniforms JAX
draws for a key (``jax.random.uniform`` on that key and shape: the same
bits), it must give the real ``jax.random.categorical``'s samples on that
key. :func:`value_categorical` is the stand-in the slice tests install for
``jax.random.categorical``; it is held to the original here too.

Tolerances: log-probabilities, probabilities, entropies and KLs 1e-6
absolute (float32 softmax over at most 7 classes), the Normal's KL also
1e-6 relative; samples and modes exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfrl_tpu.distributions import Categorical as JaxCategorical
from pfrl_tpu.distributions import Normal as JaxNormal
from pfrl_tpu.distributions.transforms import kl_divergence as jax_kl
from pfrl_tpu.policies import SoftmaxCategoricalHead as JaxSoftmaxHead
from pfrl_tpu_torch.distributions import Categorical, Normal, kl_divergence
from pfrl_tpu_torch.policies import SoftmaxCategoricalHead
from pfrl_tpu_torch.utils import draws as draw_fns

torch.set_num_threads(1)

ATOL = 1e-6


def value_categorical(key, logits, axis=-1, shape=None, replace=True, mode=None):
    """``jax.random.categorical`` where the key *is* the uniform draw
    ``[..., n]`` (mode "low": ``u`` over ``[tiny, 1)``)."""
    assert axis == -1 and shape is None and replace and key.shape == logits.shape, (key.shape, logits.shape)
    u = jnp.maximum(jnp.finfo(logits.dtype).tiny, key.astype(logits.dtype))
    return jnp.argmax(logits - jnp.log(-jnp.log(u)), axis=-1)


class GivenUniform:
    def __init__(self, *arrays):
        self.queue = [np.asarray(a, np.float32) for a in arrays]
        self.calls = 0

    def uniform(self, n):
        self.calls += 1
        a = self.queue.pop(0)
        assert a.size == n
        return torch.from_numpy(a.reshape(-1).copy())


def logits_pair(seed, shape):
    rs = np.random.RandomState(seed)
    x = (rs.normal(size=shape) * 2.0).astype(np.float32)
    return JaxCategorical(logits=jnp.asarray(x)), Categorical(logits=torch.from_numpy(x))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(8, 2), (5, 7), (3, 4, 3)])
def test_categorical_matches_jax(shape):
    jd, td = logits_pair(0, shape)
    _close(td.log_probs, jd.log_probs)
    _close(td.probs, jd.probs)
    _close(td.entropy(), jd.entropy())
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    np.testing.assert_array_equal(td.mean().numpy(), np.asarray(jd.mean()))
    actions = np.random.RandomState(1).randint(0, shape[-1], shape[:-1])
    _close(td.log_prob(torch.from_numpy(actions)), jd.log_prob(jnp.asarray(actions, jnp.int32)))
    _close(td.log_prob(torch.from_numpy(actions.astype(np.int32))), jd.log_prob(jnp.asarray(actions)))
    jq, tq = logits_pair(2, shape)
    _close(td.kl(tq), jd.kl(jq))
    _close(kl_divergence(td, tq), jax_kl(jd, jq))
    assert td.mode().dtype == torch.int64 and td.log_prob(torch.from_numpy(actions)).shape == shape[:-1]


def test_kl_divergence_covers_normal_and_refuses_mixed_families():
    rs = np.random.RandomState(3)
    a, b, c, d = (rs.normal(size=(6, 3)).astype(np.float32) for _ in range(4))
    jp, jq = JaxNormal(jnp.asarray(a), jnp.exp(jnp.asarray(b))), JaxNormal(jnp.asarray(c), jnp.exp(jnp.asarray(d)))
    tp = Normal(torch.from_numpy(a), torch.exp(torch.from_numpy(b)))
    tq = Normal(torch.from_numpy(c), torch.exp(torch.from_numpy(d)))
    np.testing.assert_allclose(kl_divergence(tp, tq).numpy(), np.asarray(jax_kl(jp, jq)), rtol=1e-6, atol=ATOL)
    with pytest.raises(NotImplementedError):
        kl_divergence(tp, Categorical(logits=torch.zeros(6, 3)))


def test_softmax_head_matches_jax():
    x = np.random.RandomState(4).normal(size=(9, 4)).astype(np.float32)
    jd = JaxSoftmaxHead().apply({}, jnp.asarray(x))
    td = SoftmaxCategoricalHead()(torch.from_numpy(x))
    assert isinstance(td, Categorical) and not list(SoftmaxCategoricalHead().parameters())
    _close(td.log_probs, jd.log_probs)
    np.testing.assert_array_equal(td.logits.numpy(), x)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(4096, 2), (1000, 6)])
def test_sample_is_jax_random_categorical_on_the_uniforms_of_its_key(seed, shape):
    jd, td = logits_pair(seed + 10, shape)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(key, jd.logits))
    u = np.asarray(jax.random.uniform(key, shape))  # the bits gumbel draws for this key and shape
    draws = GivenUniform(u)
    got = td.sample(draws).numpy()
    assert draws.calls == 1 and got.dtype == np.int64 and got.shape == shape[:-1]
    mismatches = int((got != want).sum())
    assert mismatches == 0, f"{mismatches} of {got.size} samples differ"
    np.testing.assert_array_equal(np.asarray(value_categorical(jnp.asarray(u), jd.logits)), want)
    assert np.unique(got).size == shape[-1]  # every class drawn


def test_a_zero_uniform_is_clamped_to_tiny_and_samples_follow_the_probabilities():
    logits = torch.tensor([[0.0, 0.0], [3.0, -3.0]])
    u = np.array([[0.0, 0.5], [0.5, 0.0]], np.float32)  # a zero draw: gumbel at tiny, finite
    got = draw_fns.categorical(GivenUniform(u), logits)
    assert got.tolist() == [1, 0]
    rs = np.random.RandomState(5)
    x = torch.from_numpy(np.array([[0.0, np.log(3.0)]] * 20000, np.float32))
    draws = GivenUniform((rs.randint(0, 1 << 24, x.shape) / float(1 << 24)).astype(np.float32))
    frac = float(draw_fns.categorical(draws, x).float().mean())
    assert abs(frac - 0.75) < 0.01
