"""``DoubleDQNCore``, ``CategoricalDQNCore`` and ``CategoricalDoubleDQNCore``
of the port against the JAX package: loss, per-sample errors, ``average_q``
and the updated parameters and optimizer state after one and after three
updates from converted identical state, and noisy action selection.

The categorical cores run Rainbow's noisy distributional dueling network
with optax-semantics Adam. Their noise is matched two ways: the JAX update
runs un-jitted with ``jax.random.normal`` logged and the port replays the
log in order, which pins the order of the three forwards (online on
next_obs, target on next_obs, online on obs) and of the layers in each; and
with every sigma zero on both sides, where the noise does not matter.

Tolerances: convolutions, matmuls and sums reduce in another order in the
two libraries, so losses, errors and ``average_q`` match within
``rtol 1e-5`` (floor ``1e-6``) and parameters within ``rtol 1e-5`` (floor
``1e-6``). An Adam step is at most the learning rate, which that floor would
hide, so the *change* of every parameter is also held within ``1e-3`` of
itself plus ``2e-3`` of the learning rate per update. RMSprop's second
moments match as in ``test_torch_dqn.py``.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_rainbow_modules import (
    ReplayedNormals,
    jax_noisy_dense,
    np_tree,
    record_normals,
    zero_sigma,
)

from pfrl_tpu.agents.categorical_dqn import CategoricalDoubleDQNCore as JaxCategoricalDouble
from pfrl_tpu.agents.categorical_dqn import CategoricalDQNCore as JaxCategorical
from pfrl_tpu.agents.double_dqn import DoubleDQNCore as JaxDouble
from pfrl_tpu.explorers import Greedy as JaxGreedy
from pfrl_tpu.models import LargeAtariCNN as JaxLargeAtariCNN
from pfrl_tpu.q_functions import DiscreteActionValueHead as JaxHead
from pfrl_tpu.q_functions.dueling_dqn import DistributionalDuelingDQN as JaxDistDueling
from pfrl_tpu.replay import TransitionBatch as JaxBatch
from pfrl_tpu.utils import atari_phi as jax_atari_phi
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import CategoricalDoubleDQNCore, CategoricalDQNCore, DoubleDQNCore
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.experiments.atari_rainbow import make_rainbow_core
from pfrl_tpu_torch.optimizers import RMSprop
from pfrl_tpu_torch.replay import TransitionBatch
from pfrl_tpu_torch.utils import atari_phi
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

N_ACTIONS, LR = 6, 6.25e-5


class JaxNatureQ(nn.Module):
    """bench.py's NatureQ."""

    @nn.compact
    def __call__(self, x):
        return JaxHead()(nn.Dense(N_ACTIONS)(JaxLargeAtariCNN()(x)))


def _cores(kind):
    if kind == "double":
        common = dict(explorer=None, gamma=0.99, batch_accumulator="sum")
        jcore = JaxDouble(
            model=JaxNatureQ(), optimizer=optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2),
            phi=jax_atari_phi, **common,
        )
        tcore = DoubleDQNCore(
            model=NatureQ(N_ACTIONS), optimizer=RMSprop(2.5e-4, decay=0.95, eps=1e-2),
            phi=atari_phi, **common,
        )
        return jcore, tcore
    jcls = {"categorical": JaxCategorical, "categorical_double": JaxCategoricalDouble}[kind]
    jcore = jcls(
        model=JaxDistDueling(N_ACTIONS, 51, -10.0, 10.0, dense_cls=jax_noisy_dense),
        optimizer=optax.adam(LR, eps=1.5e-4), explorer=JaxGreedy(), gamma=0.99,
        phi=lambda x: x.astype(jnp.float32) / 255.0,
    )
    tcore = make_rainbow_core(N_ACTIONS)  # the categorical double core
    if kind == "categorical":
        tcore = CategoricalDQNCore(
            model=tcore.model, optimizer=tcore.optimizer, explorer=tcore.explorer,
            gamma=0.99, phi=tcore.phi,
        )
    assert type(tcore) is {"categorical": CategoricalDQNCore,
                           "categorical_double": CategoricalDoubleDQNCore}[kind]
    assert tcore.batch_accumulator == jcore.batch_accumulator == "mean"
    return jcore, tcore


def _batch(seed, b=4):
    """uint8 frames, 3-step discounts where not cut short, rewards on and
    off the atoms, a terminal row in two."""
    rs = np.random.RandomState(seed)
    frames = lambda: rs.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8)  # noqa: E731
    return dict(
        obs=frames(),
        action=rs.randint(0, N_ACTIONS, b).astype(np.int32),
        reward=np.where(np.arange(b) % 2 == 0, rs.normal(size=b), rs.randint(0, 3, b)).astype(np.float32),
        next_obs=frames(),
        discount=(np.float32(0.99) ** rs.randint(1, 4, b)).astype(np.float32),
        is_terminal=np.array([False, True] * (b // 2)),
        weight=rs.uniform(0.2, 1.0, b).astype(np.float32),
        indices=np.arange(b, dtype=np.int32),
    )


def _port_state(tcore, js):
    return convert.dqn_state_from_flax(
        tcore, np_tree(js.params), np_tree(js.target_params), np_tree(js.opt_state), device="cpu"
    )


def _initial_jax_state(jcore, sigma):
    """A target that differs from the online net, and nonzero moments."""
    obs0 = jnp.zeros((1, 84, 84, 4), jnp.uint8)
    js = jcore.init(jax.random.PRNGKey(0), obs0)
    js = js.replace(target_params=jcore.init(jax.random.PRNGKey(1), obs0).params)
    js, _ = jax.jit(jcore.update)(js, jax.random.PRNGKey(2), JaxBatch(**_batch(0)))
    if sigma == "zero_sigma":
        zero = lambda tree: jax.tree.map(jnp.asarray, zero_sigma(np_tree(tree)))  # noqa: E731
        js = js.replace(params=zero(js.params), target_params=zero(js.target_params))
    return js


# With sigma zero the outputs and the gradients of every other leaf do not
# depend on the noise, but the sigmas' own gradients do (dL/dw_sigma is
# dL/dw * eps): that route compares one update and leaves the sigmas out.
CASES = [("double", None, n) for n in (1, 3)] + [
    (kind, sigma, n)
    for kind in ("categorical", "categorical_double")
    for sigma, n in (("replayed", 1), ("replayed", 3), ("zero_sigma", 1))
]


@pytest.mark.parametrize("kind,sigma,n_updates", CASES)
def test_update_matches_jax_from_converted_state(monkeypatch, kind, sigma, n_updates):
    jcore, tcore = _cores(kind)
    js = _initial_jax_state(jcore, sigma)
    ts = _port_state(tcore, js)
    before = {n: p.detach().clone().numpy() for n, p in ts.model.named_parameters()}
    count0 = int(js.opt_state[0].count) if kind != "double" else 0

    # Un-jitted where the noise is logged; each update's draws are replayed
    # to the port's update in order.
    log = record_normals(monkeypatch) if sigma == "replayed" else []
    jupdate = jcore.update if sigma == "replayed" else jax.jit(jcore.update)
    forwards = {"double": 3, "categorical": 2, "categorical_double": 3}[kind]
    for i in range(n_updates):
        b = _batch(10 + i)
        del log[:]
        js, jaux = jupdate(js, jax.random.PRNGKey(3 + i), JaxBatch(**b))
        if sigma == "replayed":
            draws = ReplayedNormals(log)
            assert len(draws.queue) == 4 * forwards  # two streams, eps_in and eps_out each
        elif sigma == "zero_sigma":
            draws = Draws(torch.Generator().manual_seed(i))
        else:
            draws = None  # no noisy layer
        ts, taux = tcore.update(ts, TransitionBatch(**{k: torch.from_numpy(v) for k, v in b.items()}), draws)
        if sigma == "replayed":
            assert not draws.queue
        assert float(taux["loss"]) > 0
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(taux["errors"].numpy(), np.asarray(jaux["errors"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(taux["average_q"].item(), float(jaux["average_q"]), rtol=1e-5, atol=1e-6)

    assert ts.n_updates == n_updates
    names = [n for n, _ in ts.model.named_parameters()]
    compared = [n for n in names if not (sigma == "zero_sigma" and n.endswith("_sigma"))]
    want = convert.torch_arrays(ts.model, np_tree(js.params))
    for name in compared:
        got = dict(ts.model.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got, want[name], rtol=1e-5, atol=1e-6, err_msg=name)
        if kind != "double":
            np.testing.assert_allclose(
                got - before[name], want[name] - before[name],
                rtol=1e-3, atol=2e-3 * LR * n_updates, err_msg=name,
            )
    for name, want_t in convert.torch_arrays(ts.target_model, np_tree(js.target_params)).items():
        np.testing.assert_array_equal(dict(ts.target_model.named_parameters())[name].detach().numpy(), want_t)

    opt = js.opt_state[0]
    if kind == "double":
        moments = [(ts.opt_state, opt.nu)]
    else:
        assert ts.opt_state.count == int(opt.count) == count0 + n_updates
        moments = [(ts.opt_state.mu, opt.mu), (ts.opt_state.nu, opt.nu)]
    for got_list, tree in moments:
        want_m = convert.torch_arrays(ts.model, np_tree(tree))
        for name, m in zip(names, got_list):
            if name not in compared:
                continue
            # Where a gradient element cancels to near zero its relative
            # error grows: the floor scales with the tensor's largest moment.
            atol = 1e-5 * float(np.abs(want_m[name]).max())
            np.testing.assert_allclose(m.numpy(), want_m[name], rtol=1e-5, atol=atol, err_msg=name)


def test_noisy_greedy_actions_match_jax_and_differ_between_steps(monkeypatch):
    jcore, tcore = _cores("categorical_double")
    js = _initial_jax_state(jcore, "replayed")
    ts = _port_state(tcore, js)
    frames = np.random.RandomState(5).randint(0, 256, (6, 84, 84, 4)).astype(np.uint8)
    log = record_normals(monkeypatch)
    for training in (True, False):  # evaluation draws noise too
        del log[:]
        want = jcore.select_action(js, jax.random.PRNGKey(7), jnp.asarray(frames), jnp.int32(0), training)
        draws = ReplayedNormals(log)
        got = tcore.select_action(ts, draws, torch.from_numpy(frames), 0, training)
        assert len(log) == 4 and not draws.queue
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # Fresh noise on every act step: two calls see other action values.
    draws = Draws(torch.Generator().manual_seed(0))
    with torch.no_grad():
        q1 = tcore.action_value(ts.model, torch.from_numpy(frames), draws).q_values
        q2 = tcore.action_value(ts.model, torch.from_numpy(frames), draws).q_values
    assert not torch.equal(q1, q2)
