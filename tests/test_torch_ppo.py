"""``PPOCore`` of the port against the JAX package's, and optax's
``clip_by_global_norm`` chain against ``ClipByGlobalNorm``.

Updates start from a converted warm state: the JAX core's initial weights
after one JAX update, so Adam's moments and count are non-zero. Then one
update (and, in one test, three) on the same numpy rollout with the same
permutations, in both packages. The JAX update runs jitted with
``jax.random.split`` and ``jax.random.permutation`` replaced so that the key
*is* the ``[epochs, n]`` array of permutations (:func:`jax_draws_by_value`);
the port draws the same rows from :class:`GivenDraws`.

Rollouts are small (8 x 8 = 64 transitions, minibatch 16, 2 epochs: 8 Adam
steps per update; one of 6 x 10 = 60, whose last 12 ids are dropped), hold
terminations and truncations, and log-probabilities near the policy's, so
that some ratios are clipped and others not.

Tolerances: parameters 1e-6 absolute after one update and 3e-6 after three
(Adam's steps are about the learning rate whatever the gradient's size, so
a rounding difference in a small gradient shows at that level); Adam's
moments 1e-4 relative to each tensor's largest entry; losses, entropy and
explained variance 1e-5 relative; counts exact. The clip alone: 3e-7
relative (two ulps: the norm's squares are summed in another order).
"""

from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_actor_critic_modules import np_tree
from test_torch_sac import assert_adam, assert_network

from pfrl_tpu.agents.ppo import PPOCore as JaxPPOCore
from pfrl_tpu.agents.ppo import Rollout as JaxRollout
from pfrl_tpu.policies import GaussianHeadWithStateIndependentCovariance as JaxGaussianHead
from pfrl_tpu.policies import SoftmaxCategoricalHead as JaxSoftmaxHead
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents.ppo import PPOCore, PPOState, Rollout
from pfrl_tpu_torch.experiments.onpolicy import GaussianPiV, SoftmaxPiV
from pfrl_tpu_torch.optimizers import Adam, ClipByGlobalNorm, RMSprop

torch.set_num_threads(1)

OBS, ACT, HIDDEN = 5, 3, 16
T, B, MB, EPOCHS = 8, 8, 16, 2
LR = 3e-4


# ----------------------------------------------------------- JAX modules
def _dense(n, scale=None):
    init = nn.linear.default_kernel_init if scale is None else nn.initializers.variance_scaling(scale, "fan_in", "normal")
    return nn.Dense(n, kernel_init=init)


class JaxGaussianPiV(nn.Module):
    """``bench.py``'s ``PiV`` (``run_ppo_pendulum``'s with ``mean_scale``)."""

    act_dim: int = ACT
    hidden: int = HIDDEN
    mean_scale: Optional[float] = None

    @nn.compact
    def __call__(self, x):
        hp = nn.tanh(nn.Dense(self.hidden)(x))
        hp = nn.tanh(nn.Dense(self.hidden)(hp))
        dist = JaxGaussianHead(action_size=self.act_dim)(_dense(self.act_dim, self.mean_scale)(hp))
        hv = nn.tanh(nn.Dense(self.hidden)(x))
        hv = nn.tanh(nn.Dense(self.hidden)(hv))
        return dist, nn.Dense(1)(hv)


class JaxGaussianPi(nn.Module):
    """``run_trpo_pendulum``'s ``Pi``."""

    act_dim: int = 1
    hidden: int = HIDDEN
    mean_scale: Optional[float] = 1e-4

    @nn.compact
    def __call__(self, x):
        h = nn.tanh(nn.Dense(self.hidden)(x))
        h = nn.tanh(nn.Dense(self.hidden)(h))
        return JaxGaussianHead(action_size=self.act_dim)(_dense(self.act_dim, self.mean_scale)(h))


class JaxSoftmaxPiV(nn.Module):
    """``run_a2c_cartpole``'s ``PiV``."""

    n_actions: int = 2
    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x):
        h = nn.tanh(nn.Dense(self.hidden)(x))
        h = nn.tanh(nn.Dense(self.hidden)(h))
        return JaxSoftmaxHead()(nn.Dense(self.n_actions)(h)), nn.Dense(1)(h)


# ---------------------------------------------------------------- draws
def jax_draws_by_value(monkeypatch):
    """While installed, a key given to ``split(key, n)`` is ``n`` rows and
    ``permutation(key, n)`` returns the key: the rows are the permutations."""

    def split(key, num=2):
        assert key.shape[0] == num, (key.shape, num)
        return key

    def permutation(key, x, axis=0, independent=False):
        assert key.shape == (x,), (key.shape, x)
        return key

    monkeypatch.setattr(jax.random, "split", split)
    monkeypatch.setattr(jax.random, "permutation", permutation)


class GivenDraws:
    """Hands out given arrays in order: permutations (int64 on the way
    out, as ``Draws.permutation`` gives them), normals and uniforms."""

    def __init__(self, *arrays):
        self.queue = [np.asarray(a) for a in arrays]
        self.kinds = []

    def _pop(self, kind, n):
        self.kinds.append(kind)
        a = self.queue.pop(0)
        assert a.size == n, (a.shape, n)
        return torch.from_numpy(a.reshape(-1).copy())

    def permutation(self, n):
        return self._pop("permutation", n).to(torch.int64)

    def normal(self, n):
        return self._pop("normal", n)

    def uniform(self, n):
        return self._pop("uniform", n)


def permutations(seed, count, n):
    rs = np.random.RandomState(seed)
    return np.stack([rs.permutation(n) for _ in range(count)]).astype(np.int32)


# -------------------------------------------------------------- rollouts
def numpy_rollout(seed, jcore, jparams, t=T, b=B, discrete=False):
    """A rollout whose log-probabilities are the policy's own plus noise, so
    that some ratios leave the clip range and others stay inside."""
    rs = np.random.RandomState(seed)
    obs = rs.normal(size=(t, b, OBS)).astype(np.float32)
    if discrete:
        action = rs.randint(0, 2, (t, b)).astype(np.int32)
    else:
        action = rs.normal(size=(t, b, ACT)).astype(np.float32)
    dist, value = jcore.forward(jparams, jnp.asarray(obs.reshape(t * b, OBS)))
    lp = np.asarray(dist.log_prob(jnp.asarray(action.reshape((t * b,) + action.shape[2:])))).reshape(t, b)
    terminated = rs.uniform(size=(t, b)) < 0.08
    truncated = (rs.uniform(size=(t, b)) < 0.08) & ~terminated
    return dict(
        obs=obs,
        action=action,
        log_prob=(lp + rs.normal(size=(t, b)) * 0.3).astype(np.float32),
        value=(np.asarray(value).reshape(t, b) + rs.normal(size=(t, b)) * 0.1).astype(np.float32),
        reward=rs.normal(size=(t, b)).astype(np.float32),
        terminated=terminated,
        done=terminated | truncated,
        next_obs=rs.normal(size=(t, b, OBS)).astype(np.float32),
    )


def both_rollouts(d):
    jr = JaxRollout(**{k: jnp.asarray(v) for k, v in d.items()})
    tr = Rollout(**{k: torch.from_numpy(v.copy()) for k, v in d.items()})
    return jr, tr


def jax_update(jcore, state, key, rollout):
    with pytest.MonkeyPatch.context() as monkeypatch:
        jax_draws_by_value(monkeypatch)
        return jax.jit(jcore.update)(state, jnp.asarray(key), rollout)


# ----------------------------------------------------------------- cores
def ppo_cores(discrete=False, epochs=EPOCHS, optimizer="adam", **kw):
    kw = dict(epochs=epochs, minibatch_size=MB, entropy_coef=0.01, **kw)
    jopt, topt = (optax.adam(LR), Adam(LR)) if optimizer == "adam" else (
        optax.rmsprop(7e-4, decay=0.99, eps=1e-5), RMSprop(7e-4, decay=0.99, eps=1e-5))
    if discrete:
        return JaxPPOCore(JaxSoftmaxPiV(), jopt, **kw), PPOCore(SoftmaxPiV(OBS, 2, HIDDEN), topt, **kw)
    return JaxPPOCore(JaxGaussianPiV(), jopt, **kw), PPOCore(GaussianPiV(OBS, ACT, HIDDEN), topt, **kw)


def warm_pair(jcore, tcore, discrete=False):
    """The JAX core's initial state after one JAX update, and its port."""
    jstate = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    d = numpy_rollout(100, jcore, jstate.params, discrete=discrete)
    jstate, _ = jax_update(jcore, jstate, permutations(100, jcore.epochs, T * B), both_rollouts(d)[0])
    return jstate, convert.ppo_state_from_flax(tcore, np_tree(jstate), device="cpu")


def assert_ppo_states(tstate, jstate, atol, what):
    assert tstate.n_updates == int(jstate.n_updates), what
    assert_network(tstate.model, jstate.params, atol, what)
    assert_adam(tstate.opt_state, tstate.model, jstate.opt_state, what)


def assert_metrics(aux, jaux, names=("loss", "policy_loss", "value_loss", "entropy")):
    for name in names:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]), rtol=1e-5, atol=1e-7, err_msg=name)


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("clip_eps_vf", [None, 0.2])
@pytest.mark.parametrize("standardize", [True, False])
def test_one_update_from_a_warm_state_matches_jax(clip_eps_vf, standardize):
    jcore, tcore = ppo_cores(clip_eps_vf=clip_eps_vf, standardize_advantages=standardize)
    jstate, tstate = warm_pair(jcore, tcore)
    assert tstate.opt_state.count == EPOCHS * (T * B // MB) and tstate.n_updates == tstate.opt_state.count
    d = numpy_rollout(1, jcore, jstate.params)
    jr, tr = both_rollouts(d)
    perms = permutations(1, EPOCHS, T * B)
    jstate, jaux = jax_update(jcore, jstate, perms, jr)
    draws = GivenDraws(*perms)
    tstate2, aux = tcore.update(tstate, draws, tr)
    assert tstate2 is tstate and draws.kinds == ["permutation"] * EPOCHS and not draws.queue
    assert_ppo_states(tstate, jstate, 1e-6, "ppo")
    assert_metrics(aux, jaux)
    np.testing.assert_allclose(float(aux["explained_variance"]), float(jaux["explained_variance"]), rtol=1e-5, atol=1e-6)
    assert aux["errors"].shape == (1,)
    assert all(p.grad is None for p in tstate.model.parameters())
    # Some ratios were clipped: the clipped surrogate differs from the plain one.
    assert float(aux["policy_loss"]) != 0.0


def test_three_updates_match_jax():
    jcore, tcore = ppo_cores()
    jstate, tstate = warm_pair(jcore, tcore)
    for k in range(3):
        jr, tr = both_rollouts(numpy_rollout(10 + k, jcore, jstate.params))
        perms = permutations(10 + k, EPOCHS, T * B)
        jstate, jaux = jax_update(jcore, jstate, perms, jr)
        _, aux = tcore.update(tstate, GivenDraws(*perms), tr)
        assert_metrics(aux, jaux)
    assert_ppo_states(tstate, jstate, 3e-6, "ppo x3")
    assert tstate.n_updates == 4 * EPOCHS * (T * B // MB)


def test_a_rollout_that_is_not_a_whole_number_of_minibatches_drops_the_tail():
    """60 transitions in minibatches of 16: three per epoch, the last 12 ids
    of each permutation unused (``perm[: n_mb * mb]``)."""
    jcore, tcore = ppo_cores()
    jstate, tstate = warm_pair(jcore, tcore)
    t, b = 6, 10
    d = numpy_rollout(2, jcore, jstate.params, t=t, b=b)
    jr, tr = both_rollouts(d)
    perms = permutations(2, EPOCHS, t * b)
    jstate, jaux = jax_update(jcore, jstate, perms, jr)
    n0 = tstate.n_updates
    _, aux = tcore.update(tstate, GivenDraws(*perms), tr)
    assert tstate.n_updates - n0 == EPOCHS * 3 == tcore.minibatch_shape(t * b)[0] * EPOCHS
    assert_ppo_states(tstate, jstate, 1e-6, "ppo 60")
    assert_metrics(aux, jaux)
    # The same update with the dropped tail's ids changed is the same update.
    _, tstate2 = warm_pair(jcore, tcore)
    tail_changed = perms.copy()
    tail_changed[:, 48:] = tail_changed[:, 48:][:, ::-1]
    tcore.update(tstate2, GivenDraws(*tail_changed), both_rollouts(d)[1])
    for a, b_ in zip(tstate.model.parameters(), tstate2.model.parameters()):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("max_grad_norm", [0.05, 1e3])
def test_max_grad_norm_above_and_below_the_threshold_matches_jax(max_grad_norm):
    """0.05 is below every minibatch gradient's norm (every step clips);
    1,000 above all (none does). Also a categorical model and RMSprop, as
    A2C chains them."""
    jcore, tcore = ppo_cores(discrete=True, optimizer="rmsprop", max_grad_norm=max_grad_norm)
    assert isinstance(tcore.optimizer, ClipByGlobalNorm) and isinstance(tcore.optimizer.inner, RMSprop)
    jstate, tstate = warm_pair(jcore, tcore, discrete=True)
    nu = convert.torch_arrays(tstate.model, np_tree(jstate.opt_state[1][0].nu))
    for name, got in zip([n for n, _ in tstate.model.named_parameters()], tstate.opt_state):
        np.testing.assert_array_equal(got.numpy(), nu[name])
    d = numpy_rollout(3, jcore, jstate.params, discrete=True)
    jr, tr = both_rollouts(d)
    perms = permutations(3, EPOCHS, T * B)
    jstate, jaux = jax_update(jcore, jstate, perms, jr)
    _, aux = tcore.update(tstate, GivenDraws(*perms), tr)
    assert_network(tstate.model, jstate.params, 1e-6, "ppo clip")
    assert_metrics(aux, jaux)
    nu = convert.torch_arrays(tstate.model, np_tree(jstate.opt_state[1][0].nu))
    for name, got in zip([n for n, _ in tstate.model.named_parameters()], tstate.opt_state):
        np.testing.assert_allclose(got.numpy(), nu[name], rtol=1e-4, atol=1e-4 * float(np.abs(nu[name]).max()) + 1e-12)


@pytest.mark.parametrize("scale", [30.0, 0.01])
def test_clip_by_global_norm_is_optax_chain(scale):
    """Above the threshold the gradients become ``(g / norm) * max_norm``;
    below it they pass unchanged: one Adam step after the clip, as optax."""
    rs = np.random.RandomState(4)
    shapes = [(4, 3), (3,), (1,)]
    params = [rs.normal(size=s).astype(np.float32) for s in shapes]
    grads = [(rs.normal(size=s) * scale).astype(np.float32) for s in shapes]
    max_norm = 1.0
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
    assert (norm > max_norm) == (scale > 1)
    chain = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(1e-2))
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jg = {str(i): jnp.asarray(g) for i, g in enumerate(grads)}
    clipped, _ = optax.clip_by_global_norm(max_norm).update(jg, optax.EmptyState())
    updates, _ = chain.update(jg, chain.init(jp), jp)
    want = optax.apply_updates(jp, updates)

    opt = ClipByGlobalNorm(max_norm, Adam(1e-2))
    tp = [torch.from_numpy(p.copy()) for p in params]
    tg = [torch.from_numpy(g) for g in grads]
    for i, c in enumerate(opt.clip(tg)):
        np.testing.assert_allclose(c.numpy(), np.asarray(clipped[str(i)]), rtol=3e-7, atol=0)
        if scale < 1:
            assert torch.equal(c, tg[i])
    state = opt.init(tp)
    opt.update(tp, tg, state)
    for i, p in enumerate(tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(want[str(i)]), rtol=1e-6, atol=1e-7)
    assert state.count == 1


def test_act_with_aux_and_select_action_match_jax_by_value(monkeypatch):
    jcore, tcore = ppo_cores()
    jstate, tstate = warm_pair(jcore, tcore)
    obs = np.random.RandomState(5).normal(size=(7, OBS)).astype(np.float32)
    eps = np.random.RandomState(6).normal(size=(7, ACT)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(eps, dtype))
    ja, jaux = jcore.act_with_aux(jstate, None, jnp.asarray(obs), True)
    ta, taux = tcore.act_with_aux(tstate, GivenDraws(eps), torch.from_numpy(obs), True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6, rtol=0)
    for k in ("log_prob", "value"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), atol=1e-5, rtol=1e-6, err_msg=k)
    assert taux["value"].shape == (7,)
    greedy = tcore.select_action(tstate, None, torch.from_numpy(obs), 0, False)
    np.testing.assert_allclose(
        greedy.numpy(), np.asarray(jcore.select_action(jstate, None, jnp.asarray(obs), 0, False)), atol=1e-6
    )


def test_init_draws_flax_default_weights_and_compute_dtype_is_refused():
    _, tcore = ppo_cores()
    state = tcore.init(torch.Generator().manual_seed(0), torch.zeros(2, OBS))
    assert isinstance(state, PPOState) and state.n_updates == 0 and state.opt_state.count == 0
    model = state.model
    assert set(model.flax_names().values()) == {f"Dense_{i}" for i in range(6)} | {
        "GaussianHeadWithStateIndependentCovariance_0/log_std"}
    for layer in list(model.pi) + list(model.v):
        w = layer.weight.detach()
        std = (1.0 / w.shape[1]) ** 0.5
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6  # truncated at 2 std
        assert not layer.bias.any()
    assert float(model.head.log_std.detach()) == 0.0
    with pytest.raises(ValueError, match="compute_dtype"):  # not a floating dtype
        PPOCore(GaussianPiV(OBS, ACT), Adam(LR), compute_dtype=torch.int32)
