"""DQN pieces of the port against the JAX package: the value losses, the
optax-semantics RMSprop, the epsilon-greedy explorer, one
``DQNCore.update`` from converted identical state, and target syncs.

Tolerances: elementwise float32 ops are exact; sums and the network's
convolutions and matmuls reduce in another order in the two libraries,
so losses, errors, updated parameters and second moments match within
``rtol 1e-5`` (with an absolute floor where a gradient cancels);
RMSprop's ``rsqrt`` may differ by an ulp (``rtol 1e-6``).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pfrl_tpu.agents import DQNCore as JaxDQNCore
from pfrl_tpu.explorers import LinearDecayEpsilonGreedy as JaxLinearDecay
from pfrl_tpu.models import LargeAtariCNN as JaxLargeAtariCNN
from pfrl_tpu.ops import value_loss as jax_vl
from pfrl_tpu.q_functions import DiscreteActionValueHead as JaxHead
from pfrl_tpu.replay import TransitionBatch as JaxBatch
from pfrl_tpu.utils import atari_phi as jax_atari_phi
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.ops import value_loss
from pfrl_tpu_torch.optimizers import RMSprop
from pfrl_tpu_torch.replay import TransitionBatch
from pfrl_tpu_torch.utils import atari_phi

torch.set_num_threads(1)

N_ACTIONS = 6


class JaxNatureQ(nn.Module):
    """bench.py's NatureQ."""

    @nn.compact
    def __call__(self, x):
        return JaxHead()(nn.Dense(N_ACTIONS)(JaxLargeAtariCNN()(x)))


class KeyDraws:
    """The draws a JAX explorer takes from ``rng``: the mask's uniforms
    from the first half of its split, the random actions from the second."""

    def __init__(self, rng):
        self.rng_mask, self.rng_rand = jax.random.split(rng)

    def uniform(self, n):
        return torch.from_numpy(np.array(jax.random.uniform(self.rng_mask, (n,))))

    def randint(self, high, n):
        return torch.from_numpy(
            np.array(jax.random.randint(self.rng_rand, (n,), 0, high, dtype=jnp.int32))
        )


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- value loss
def test_huber_loss_matches_jax():
    x = np.linspace(-3.0, 3.0, 61).astype(np.float32)
    np.testing.assert_array_equal(
        value_loss.huber_loss(_t(x)).numpy(), np.asarray(jax_vl.huber_loss(jnp.asarray(x)))
    )


@pytest.mark.parametrize("batch_accumulator", ["mean", "sum"])
@pytest.mark.parametrize("clip_delta", [True, False])
def test_value_losses_match_jax(batch_accumulator, clip_delta):
    rs = np.random.RandomState(0)
    y, t = (rs.normal(scale=2.0, size=32).astype(np.float32) for _ in range(2))
    w = rs.uniform(0.1, 1.0, 32).astype(np.float32)
    kw = dict(clip_delta=clip_delta, batch_accumulator=batch_accumulator)
    np.testing.assert_allclose(
        value_loss.compute_weighted_value_loss(_t(y), _t(t), _t(w), **kw).item(),
        float(jax_vl.compute_weighted_value_loss(jnp.asarray(y), jnp.asarray(t), jnp.asarray(w), **kw)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        value_loss.compute_value_loss(_t(y), _t(t), **kw).item(),
        float(jax_vl.compute_value_loss(jnp.asarray(y), jnp.asarray(t), **kw)),
        rtol=1e-6,
    )


def test_value_loss_rejects_unknown_accumulator():
    with pytest.raises(ValueError):
        value_loss.compute_value_loss(torch.zeros(2), torch.zeros(2), batch_accumulator="max")


# ------------------------------------------------------------------- RMSprop
def test_rmsprop_matches_optax_over_three_steps():
    rs = np.random.RandomState(1)
    params = {"w": rs.normal(size=(3, 4)).astype(np.float32), "b": rs.normal(size=4).astype(np.float32)}
    tx = optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    opt = RMSprop(2.5e-4, decay=0.95, eps=1e-2)
    tp = [_t(params["w"]), _t(params["b"])]
    nu = opt.init(tp)
    for _ in range(3):
        grads = {k: rs.normal(scale=0.1, size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, [_t(grads["w"]), _t(grads["b"])], nu)
    for got, name in zip(tp, ("w", "b")):
        np.testing.assert_allclose(got.numpy(), np.asarray(jp[name]), rtol=1e-6)
    for got, name in zip(nu, ("w", "b")):
        np.testing.assert_allclose(got.numpy(), np.asarray(jstate[0].nu[name]), rtol=1e-6)


def test_rmsprop_is_not_torch_rmsprop():
    # eps inside the square root, nu from zero: the first step is
    # lr * g / sqrt((1 - decay) * g**2 + eps), not lr * g / (sqrt(...) + eps).
    p, g = torch.zeros(1), torch.full((1,), 0.5)
    opt = RMSprop(1.0, decay=0.95, eps=1e-2)
    opt.update([p], [g], opt.init([p]))
    want = -0.5 / np.sqrt(0.05 * 0.25 + 1e-2)
    np.testing.assert_allclose(p.item(), want, rtol=1e-6)


# ------------------------------------------------------------------ explorer
def test_epsilon_schedule_and_draws_match_jax():
    jx = JaxLinearDecay(1.0, 0.1, 1_000, N_ACTIONS)
    tx = LinearDecayEpsilonGreedy(1.0, 0.1, 1_000, N_ACTIONS)
    greedy = np.arange(16, dtype=np.int32) % N_ACTIONS
    for t in (0, 1, 64, 333, 999, 1_000, 50_000):
        assert tx.epsilon_at(t) == float(jx.epsilon_at(jnp.int32(t)))
        rng = jax.random.PRNGKey(t)
        want = jx.select_action(rng, jnp.int32(t), jnp.asarray(greedy))
        got = tx.select_action(KeyDraws(rng), t, _t(greedy))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ DQNCore
def _cores():
    jcore = JaxDQNCore(
        model=JaxNatureQ(),
        optimizer=optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2),
        explorer=None,
        gamma=0.99,
        batch_accumulator="sum",
        phi=jax_atari_phi,
    )
    tcore = DQNCore(
        model=NatureQ(N_ACTIONS),
        optimizer=RMSprop(2.5e-4, decay=0.95, eps=1e-2),
        explorer=None,
        gamma=0.99,
        batch_accumulator="sum",
        phi=atari_phi,
    )
    return jcore, tcore


def _batch(seed, b=4):
    rs = np.random.RandomState(seed)
    frames = lambda: (rs.randint(0, 256, (b, 84, 84, 4)).astype(np.float32) * np.float32(1 / 255))  # noqa: E731
    return dict(
        obs=frames(),
        action=rs.randint(0, N_ACTIONS, b).astype(np.int32),
        reward=rs.normal(size=b).astype(np.float32),
        next_obs=frames(),
        discount=np.full(b, 0.99, np.float32),
        is_terminal=np.array([False, True] * (b // 2)),
        weight=rs.uniform(0.2, 1.0, b).astype(np.float32),
        indices=np.arange(b, dtype=np.int32),
    )


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params_close(module, flax_tree, rtol, atol):
    for name, want in convert.torch_arrays(module, _np_tree(flax_tree)).items():
        got = dict(module.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def test_dqn_update_matches_jax_from_converted_state():
    jcore, tcore = _cores()
    obs0 = jnp.zeros((1, 84, 84, 4), jnp.uint8)
    js = jcore.init(jax.random.PRNGKey(0), obs0)
    # A target that differs from the online net, and nonzero second moments.
    js = js.replace(target_params=jcore.init(jax.random.PRNGKey(1), obs0).params)
    js, _ = jcore.update(js, jax.random.PRNGKey(2), JaxBatch(**_batch(0)))
    ts = convert.dqn_state_from_flax(
        tcore, _np_tree(js.params), _np_tree(js.target_params), _np_tree(js.opt_state), device="cpu"
    )

    b = _batch(1)
    js, jaux = jcore.update(js, jax.random.PRNGKey(3), JaxBatch(**b))
    ts, taux = tcore.update(ts, TransitionBatch(**{k: _t(v) for k, v in b.items()}))
    assert ts.n_updates == 1
    np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(taux["errors"].numpy(), np.asarray(jaux["errors"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux["average_q"].item(), float(jaux["average_q"]), rtol=1e-5, atol=1e-6)
    _assert_params_close(ts.model, js.params, rtol=1e-5, atol=1e-7)
    _assert_params_close(ts.target_model, js.target_params, rtol=0, atol=0)
    nu = dict(zip((n for n, _ in ts.model.named_parameters()), ts.opt_state))
    for name, want in convert.torch_arrays(ts.model, _np_tree(js.opt_state[0].nu)).items():
        # nu holds squared gradients: where a gradient element cancels to
        # near zero its relative error grows, so the floor scales with the
        # tensor's largest moment.
        atol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(nu[name].numpy(), want, rtol=1e-5, atol=atol, err_msg=name)

    # Greedy actions on the updated net agree.
    frames = np.random.RandomState(5).randint(0, 256, (6, 84, 84, 4)).astype(np.uint8)
    want = jcore.select_action(js, jax.random.PRNGKey(0), jnp.asarray(frames), jnp.int32(0), False)
    got = tcore.select_action(ts, None, _t(frames), 0, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["hard", "soft"])
def test_sync_target_matches_jax(method):
    jcore, tcore = _cores()
    jcore.target_update_method = tcore.target_update_method = method
    jcore.soft_update_tau = tcore.soft_update_tau = 0.05
    obs0 = jnp.zeros((1, 84, 84, 4), jnp.uint8)
    js = jcore.init(jax.random.PRNGKey(0), obs0)
    js = js.replace(target_params=jcore.init(jax.random.PRNGKey(1), obs0).params)
    ts = convert.dqn_state_from_flax(
        tcore, _np_tree(js.params), _np_tree(js.target_params), _np_tree(js.opt_state), device="cpu"
    )
    js = jcore.sync_target(js)
    assert tcore.sync_target(ts) is ts
    _assert_params_close(ts.target_model, js.target_params, rtol=1e-7, atol=0)
    _assert_params_close(ts.model, js.params, rtol=0, atol=0)


def test_dqn_core_rejects_unknown_sync_method():
    with pytest.raises(ValueError):
        DQNCore(NatureQ(N_ACTIONS), RMSprop(1e-3), None, target_update_method="lazy")
