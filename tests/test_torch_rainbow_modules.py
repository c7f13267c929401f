"""Rainbow's modules of the port against the JAX package: the factorized
noisy layer, both dueling heads, the distributional action value, the
categorical projection, optax-semantics Adam, the draw source's new draws
and the converter for noisy parameters and Adam's state.

Noise cannot match by seed (flax derives each layer's key from the module
path), so it is matched by value: ``jax.random.normal`` is wrapped to log
what it returns while the flax module runs un-jitted, and the port's
layers are handed the log in order (:class:`ReplayedNormals`). That also
pins the order in which layers draw. A second route sets every sigma to
zero on both sides, where the output does not depend on the noise.

Tolerances: elementwise float32 ops and the support ``z`` are exact;
matmuls, convolutions, softmax and sums reduce in another order in the two
libraries, so outputs match within ``rtol 1e-5`` (floor ``1e-6``); the
projection within ``rtol 1e-6`` (floor ``1e-7``: its contraction adds at
most a few nonzero terms); Adam within ``rtol 1e-6`` over 5 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pfrl_tpu.action_value import DistributionalDiscreteActionValue as JaxDistAV
from pfrl_tpu.models.noisy_linear import FactorizedNoisyDense as JaxNoisyDense
from pfrl_tpu.ops.categorical import categorical_projection as jax_projection
from pfrl_tpu.q_functions.dueling_dqn import DistributionalDuelingDQN as JaxDistDueling
from pfrl_tpu.q_functions.dueling_dqn import DuelingDQN as JaxDueling
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.action_value import DistributionalDiscreteActionValue
from pfrl_tpu_torch.experiments.atari_rainbow import make_rainbow_core
from pfrl_tpu_torch.models.noisy_linear import FactorizedNoisyLinear
from pfrl_tpu_torch.ops.categorical import categorical_projection
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.dueling_dqn import (
    DistributionalDuelingDQN,
    DuelingDQN,
    support,
)
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

N_ACTIONS, N_ATOMS = 6, 51


# ------------------------------------------------------------ shared helpers
class ReplayedNormals:
    """A draw source that hands out logged normal draws, in order."""

    def __init__(self, log):
        self.queue = [np.asarray(x) for x in log]

    def normal(self, n):
        x = self.queue.pop(0)
        assert x.shape == (n,), (x.shape, n)
        return torch.from_numpy(np.array(x, np.float32))


def record_normals(monkeypatch):
    """Wrap ``jax.random.normal`` so that it logs what it returns; the log
    is the returned list. Only concrete (un-jitted) calls can be logged."""
    log = []
    real = jax.random.normal

    def logged(key, shape=(), dtype=jnp.float32):
        out = real(key, shape, dtype)
        log.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "normal", logged)
    return log


def jax_noisy_dense(features, **kw):
    return JaxNoisyDense(features=features, sigma_scale=0.5)


def zero_sigma(flax_tree):
    """The tree with every ``w_sigma``/``b_sigma`` leaf set to zero."""
    def walk(node):
        return {
            k: walk(v) if isinstance(v, dict) else (np.zeros_like(v) if k.endswith("_sigma") else v)
            for k, v in node.items()
        }
    return walk(flax_tree)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(seed, b=3):
    return np.random.RandomState(seed).randint(0, 256, (b, 84, 84, 4)).astype(np.uint8)


# --------------------------------------------------------------- noisy layer
@pytest.mark.parametrize("route", ["replayed", "zero_sigma", "deterministic"])
def test_noisy_layer_matches_flax(monkeypatch, route):
    rs = np.random.RandomState(0)
    x = rs.normal(size=(4, 20)).astype(np.float32)
    layer = JaxNoisyDense(features=7, sigma_scale=0.5)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    params = np_tree(layer.init(rngs, jnp.asarray(x)))
    if route == "zero_sigma":
        params = zero_sigma(params)
    log = record_normals(monkeypatch)
    want = layer.apply(
        params, jnp.asarray(x), deterministic=route == "deterministic",
        rngs={"noise": jax.random.PRNGKey(2)},
    )
    assert [a.shape for a in log] == ([] if route == "deterministic" else [(20,), (7,)])

    port = FactorizedNoisyLinear(20, 7, sigma_scale=0.5)
    leaves = params["params"]
    with torch.no_grad():
        port.w_mu.copy_(_t(leaves["w_mu"].T))
        port.w_sigma.copy_(_t(leaves["w_sigma"].T))
        port.b_mu.copy_(_t(leaves["b_mu"]))
        port.b_sigma.copy_(_t(leaves["b_sigma"]))
        if route == "deterministic":
            got = port(_t(x), None, deterministic=True)
        elif route == "zero_sigma":  # any noise gives the same output
            got = port(_t(x), Draws(torch.Generator().manual_seed(3)))
        else:
            draws = ReplayedNormals(log)
            got = port(_t(x), draws)
            assert not draws.queue
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_noisy_layer_init_matches_flax_ranges_and_draws_fresh_noise():
    layer = JaxNoisyDense(features=7, sigma_scale=0.5)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    leaves = np_tree(layer.init(rngs, jnp.zeros((1, 300))))["params"]
    port = FactorizedNoisyLinear(300, 7, sigma_scale=0.5)
    port.reset_parameters(torch.Generator().manual_seed(0))
    bound = np.float32((3.0 / 300) ** 0.5)
    for name in ("w_mu", "b_mu"):
        got = getattr(port, name).detach().numpy()
        assert np.abs(got).max() <= bound and np.abs(leaves[name]).max() <= bound
        assert got.std() > 0.4 * bound  # uniform: std = bound / sqrt(3)
    np.testing.assert_array_equal(port.w_sigma.detach().numpy(), leaves["w_sigma"].T)
    np.testing.assert_array_equal(port.b_sigma.detach().numpy(), leaves["b_sigma"])

    draws = Draws(torch.Generator().manual_seed(0))
    x = torch.ones(2, 300)
    with torch.no_grad():
        assert not torch.equal(port(x, draws), port(x, draws))
    with pytest.raises(ValueError):
        port(x)  # no draw source and not deterministic


# ------------------------------------------------------------- dueling heads
def _heads(kind, dense):
    noisy = dense == "noisy"
    if kind == "dueling":
        jmodel = JaxDueling(N_ACTIONS, dense_cls=jax_noisy_dense if noisy else None)
        tmodel = DuelingDQN(
            N_ACTIONS, dense_cls=(lambda i, o: FactorizedNoisyLinear(i, o, 0.5)) if noisy else None
        )
    else:
        jmodel = JaxDistDueling(N_ACTIONS, N_ATOMS, -10.0, 10.0, dense_cls=jax_noisy_dense if noisy else None)
        tmodel = DistributionalDuelingDQN(
            N_ACTIONS, N_ATOMS, -10.0, 10.0,
            dense_cls=(lambda i, o: FactorizedNoisyLinear(i, o, 0.5)) if noisy else None,
        )
    return jmodel, tmodel


@pytest.mark.parametrize("dense", ["default", "noisy"])
@pytest.mark.parametrize("kind", ["dueling", "distributional"])
def test_dueling_heads_match_flax(monkeypatch, kind, dense):
    jmodel, tmodel = _heads(kind, dense)
    x = _frames(0).astype(np.float32) / np.float32(255.0)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    params = np_tree(jmodel.init(rngs, jnp.asarray(x)))
    log = record_normals(monkeypatch)
    want = jmodel.apply(params, jnp.asarray(x), rngs={"noise": jax.random.PRNGKey(2)})
    # Advantage stream first (512 -> A or A*N), then value (512 -> 1 or N).
    a_out, v_out = (N_ACTIONS, 1) if kind == "dueling" else (N_ACTIONS * N_ATOMS, N_ATOMS)
    assert [a.shape for a in log] == ([(512,), (a_out,), (512,), (v_out,)] if dense == "noisy" else [])

    convert.load_flax_params(tmodel, params)
    draws = ReplayedNormals(log)
    with torch.no_grad():
        got = tmodel(_t(x), draws)
    assert not draws.queue
    if kind == "dueling":
        np.testing.assert_allclose(got.q_values.numpy(), np.asarray(want.q_values), rtol=1e-5, atol=1e-6)
    else:
        assert got.q_dist.shape == (3, N_ACTIONS, N_ATOMS)
        np.testing.assert_allclose(got.q_dist.numpy(), np.asarray(want.q_dist), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got.z_values.numpy(), np.asarray(want.z_values))
        np.testing.assert_allclose(got.q_dist.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("v_min,v_max,n_atoms", [(-10.0, 10.0, 51), (0.0, 200.0, 51), (-1.0, 1.0, 21)])
def test_support_is_jnp_linspace_to_the_bit(v_min, v_max, n_atoms):
    want = np.asarray(jnp.linspace(v_min, v_max, n_atoms, dtype=jnp.float32))
    got = support(v_min, v_max, n_atoms)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- distributional action value
def _dist_avs():
    rs = np.random.RandomState(0)
    logits = rs.normal(size=(5, N_ACTIONS, N_ATOMS)).astype(np.float32)
    q_dist = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    z = np.asarray(jnp.linspace(-10.0, 10.0, N_ATOMS, dtype=jnp.float32))
    actions = rs.randint(0, N_ACTIONS, 5).astype(np.int32)
    jav = JaxDistAV(q_dist=jnp.asarray(q_dist), z_values=jnp.asarray(z))
    tav = DistributionalDiscreteActionValue(q_dist=_t(q_dist), z_values=_t(z))
    return jav, tav, actions


@pytest.mark.parametrize(
    "accessor,takes_actions,exact",
    [
        ("q_values", None, False),
        ("greedy_actions", False, True),
        ("max", False, False),
        ("max_as_distribution", False, True),
        ("evaluate_actions", True, False),
        ("evaluate_actions_as_distribution", True, True),
    ],
)
def test_distributional_action_value_accessors_match_jax(accessor, takes_actions, exact):
    jav, tav, actions = _dist_avs()
    if takes_actions is None:  # a property
        want, got = getattr(jav, accessor), getattr(tav, accessor)
    elif takes_actions:
        want, got = getattr(jav, accessor)(jnp.asarray(actions)), getattr(tav, accessor)(_t(actions))
    else:
        want, got = getattr(jav, accessor)(), getattr(tav, accessor)()
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    if exact:  # picks, no arithmetic
        np.testing.assert_array_equal(got.numpy(), want)
    else:      # a sum over 51 atoms
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ categorical projection
def _projection_case(case):
    rs = np.random.RandomState(1)
    z = np.asarray(jnp.linspace(-10.0, 10.0, N_ATOMS, dtype=jnp.float32))
    b = 16
    probs = rs.dirichlet(np.ones(N_ATOMS), b).astype(np.float32)
    reward = rs.normal(scale=2.0, size=b).astype(np.float32)
    discount = np.full(b, 0.99**3, np.float32)
    terminal = rs.uniform(size=b) < 0.3
    if case == "clipped":        # far beyond both ends of the support
        reward = np.where(np.arange(b) % 2 == 0, 25.0, -25.0).astype(np.float32)
    elif case == "all_terminal":  # every atom of a row lands on r: integer rewards
        terminal = np.ones(b, bool)
        reward = rs.randint(-3, 4, b).astype(np.float32)
    elif case == "on_atoms":     # y is the support itself: low == up everywhere
        reward, discount, terminal = np.zeros(b, np.float32), np.ones(b, np.float32), np.zeros(b, bool)
    y = reward[:, None] + (1.0 - terminal.astype(np.float32))[:, None] * discount[:, None] * z[None, :]
    return y.astype(np.float32), probs, z


@pytest.mark.parametrize("case", ["random", "clipped", "all_terminal", "on_atoms"])
def test_categorical_projection_matches_jax(case):
    y, probs, z = _projection_case(case)
    want = np.asarray(jax_projection(jnp.asarray(y), jnp.asarray(probs), jnp.asarray(z)))
    got = categorical_projection(_t(y), _t(probs), support(-10.0, 10.0, N_ATOMS)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    if case == "on_atoms":  # each atom keeps its mass, up to the rounding of (z - v_min) / delta_z
        np.testing.assert_allclose(got, probs, atol=1e-5)
    if case == "clipped":   # all the mass on an end atom
        np.testing.assert_allclose(got[0::2, -1], 1.0, rtol=1e-5)
        np.testing.assert_allclose(got[1::2, 0], 1.0, rtol=1e-5)


# ---------------------------------------------------------------------- Adam
def test_adam_matches_optax_over_five_steps():
    rs = np.random.RandomState(1)
    params = {"w": rs.normal(size=(3, 4)).astype(np.float32), "b": rs.normal(size=4).astype(np.float32)}
    tx = optax.adam(6.25e-5, eps=1.5e-4)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    opt = Adam(6.25e-5, eps=1.5e-4)
    tp = [_t(params["w"]), _t(params["b"])]
    state = opt.init(tp)
    for _ in range(5):
        grads = {k: rs.normal(scale=0.1, size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, [_t(grads["w"]), _t(grads["b"])], state)
    assert state.count == int(jstate[0].count) == 5
    for i, name in enumerate(("w", "b")):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[name]), rtol=1e-6)
        np.testing.assert_allclose(state.mu[i].numpy(), np.asarray(jstate[0].mu[name]), rtol=1e-6)
        np.testing.assert_allclose(state.nu[i].numpy(), np.asarray(jstate[0].nu[name]), rtol=1e-6)
        # The step itself, which the parameter's magnitude would hide.
        np.testing.assert_allclose(
            tp[i].numpy() - params[name], np.asarray(jp[name]) - params[name], rtol=1e-3, atol=1e-9
        )


def test_adam_is_not_torch_adam():
    # optax adds eps to sqrt(nu_hat); torch.optim.Adam adds it to
    # sqrt(nu) / sqrt(1 - b2**t). The first step from zero moments is
    # -lr * g / (|g| + eps).
    p, g = torch.zeros(1), torch.full((1,), 1e-4)
    opt = Adam(1.0, eps=1.5e-4)
    opt.update([p], [g], opt.init([p]))
    np.testing.assert_allclose(p.item(), -1e-4 / (1e-4 + 1.5e-4), rtol=1e-5)


# -------------------------------------------------------------- draw source
def test_draws_normal_and_device_bounded_integers():
    draws = Draws(torch.Generator().manual_seed(0))
    x = draws.normal(4096)
    assert x.dtype == torch.float32 and x.shape == (4096,)
    assert abs(float(x.mean())) < 0.1 and abs(float(x.std()) - 1.0) < 0.1
    for high in (1, 7, 100_000):
        bound = torch.tensor(high, dtype=torch.int32)  # a 0-d tensor, as a ring's fill level
        ids = draws.randint_below(bound, 2048)
        assert ids.dtype == torch.int32 and ids.shape == (2048,)
        assert int(ids.min()) >= 0 and int(ids.max()) < high
    assert len(torch.unique(draws.randint_below(torch.tensor(7), 2048))) == 7


# ---------------------------------------------------------------- converter
def test_converter_round_trip_for_noisy_params_and_adam_state():
    core = make_rainbow_core(N_ACTIONS)
    jmodel = JaxDistDueling(N_ACTIONS, N_ATOMS, -10.0, 10.0, dense_cls=jax_noisy_dense)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    params = jmodel.init(rngs, jnp.zeros((1, 84, 84, 4)))
    tx = optax.adam(6.25e-5, eps=1.5e-4)
    opt_state = tx.init(params)
    rs = np.random.RandomState(0)
    for _ in range(2):  # nonzero moments and a count of 2
        grads = jax.tree.map(lambda p: jnp.asarray(rs.normal(size=p.shape).astype(np.float32)), params)
        _, opt_state = tx.update(grads, opt_state, params)
    adam = opt_state[0]
    target = jax.tree.map(lambda p: p + 1.0, params)
    state = convert.dqn_state_from_flax(
        core, np_tree(params), np_tree(target), np_tree(opt_state), device="cpu"
    )
    assert state.opt_state.count == 2 and state.n_updates == 0

    flax = np_tree(params)["params"]
    names = [n for n, _ in state.model.named_parameters()]
    assert set(names) == (
        {f"torso.convs.{i}.{k}" for i in range(3) for k in ("weight", "bias")}
        | {"torso.dense.weight", "torso.dense.bias"}
        | {f"{s}.{k}" for s in ("advantage", "value") for k in ("w_mu", "b_mu", "w_sigma", "b_sigma")}
    )
    got = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
    # flax numbers the streams in construction order: _0 advantage, _1 value.
    for sub, scope, out in (("advantage", "FactorizedNoisyDense_0", N_ACTIONS * N_ATOMS),
                            ("value", "FactorizedNoisyDense_1", N_ATOMS)):
        assert got[f"{sub}.w_mu"].shape == (out, 512)
        for leaf in ("w_mu", "w_sigma"):
            np.testing.assert_array_equal(got[f"{sub}.{leaf}"], flax[scope][leaf].T)
        for leaf in ("b_mu", "b_sigma"):
            np.testing.assert_array_equal(got[f"{sub}.{leaf}"], flax[scope][leaf])
    for module, tree in ((state.model, params), (state.target_model, target)):
        for name, want in convert.torch_arrays(module, np_tree(tree)).items():
            np.testing.assert_array_equal(dict(module.named_parameters())[name].detach().numpy(), want)
    for moments, tree in ((state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu)):
        want = convert.torch_arrays(state.model, np_tree(tree))
        for name, m in zip(names, moments):
            np.testing.assert_array_equal(m.numpy(), want[name], err_msg=name)
