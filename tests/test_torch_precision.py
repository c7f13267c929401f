"""bf16 compute over float32 masters in the port
(``pfrl_tpu_torch/utils/precision.py``, ``models/layers.py``) against the
JAX package's ``pfrl_tpu/utils/precision.py`` and flax's layers.

The port's counterpart of ``tests/test_precision.py``, which stays as it
is. Covered: the cast helpers (floats only; every output type of the port
maps back to float32); ``apply_cast``'s gradients reach the float32
masters, buffers and keyword arguments stay float32; the promotion table
of the Dense, Conv and factorized noisy layers (bf16 x bf16 -> bf16, bf16 x
float32 -> float32, as flax's ``promote_dtype`` and ``jnp``); the bf16
forwards of every network of the ported recipes against the JAX package's
``apply_cast``; ``use_full_fp32``'s flags.

Tolerances:
- Run eagerly (``jax.disable_jit``), every output the JAX package computes
  in bf16 through the MLPs (reductions of up to 256 terms) is equal **to
  the bit**: both take a bf16 product rounded once from a float32
  accumulation, add the bias after, and round each op of the softmax.
- Outputs that promotion puts in float32 (IQN after the product
  ``psi(x) * phi(tau)``, whose taus are float32) within 1e-6 absolute, the
  float32 tests' tolerance: float32 products reduce in another order.
- The Nature CNN's reductions are 256 to 3,136 terms long over 10^4 to
  10^5 outputs. There the float32 accumulations of MKL and XLA, summed in
  another order, round to either side of a bf16 value in about one output
  in 10^5: each layer, fed the same bf16 input, matches to the bit but for
  at most 1e-4 of its outputs, each one bf16 ulp of the product off (and
  the bias's sum rounded after it). Through the network
  the flips spread, so networks on the CNN (and the noisy heads on it) are
  held, eagerly and jitted, within 8 bf16 ulps of each output's largest
  magnitude (8 * 2**-8 = 3.1%).
- Run jitted, XLA keeps float32 inside its fusions where eager bf16
  rounds: every network within those 8 ulps, and the jitted outputs do
  differ from the eager ones (so the bound is not idle).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_actor_critic_modules import JaxDetPolicy, JaxSACPolicy
from test_torch_ppo import JaxGaussianPiV, JaxSoftmaxPiV
from test_torch_rainbow_modules import ReplayedNormals, np_tree, record_normals
from test_torch_value_modules import JaxProbs, JaxPsi, Probs

from pfrl_tpu import q_functions as jq
from pfrl_tpu.models import LargeAtariCNN as JaxLargeAtariCNN
from pfrl_tpu.models.noisy_linear import FactorizedNoisyDense
from pfrl_tpu.q_functions import DiscreteActionValueHead as JaxHead
from pfrl_tpu.utils import precision as jprecision
from pfrl_tpu_torch import _device, convert
from pfrl_tpu_torch.action_value import (
    DiscreteActionValue,
    DistributionalDiscreteActionValue,
    QuantileDiscreteActionValue,
)
from pfrl_tpu_torch.distributions import Categorical, Delta, Normal, SquashedNormal
from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ
from pfrl_tpu_torch.experiments.cartpole_value import ReLUMLP
from pfrl_tpu_torch.experiments.onpolicy import GaussianPiV, SoftmaxPiV
from pfrl_tpu_torch.models import FactorizedNoisyLinear, to_factorized_noisy
from pfrl_tpu_torch.models.layers import Conv2d, Linear
from pfrl_tpu_torch.q_functions import (
    DistributionalDuelingDQN,
    DistributionalFCStateQFunctionWithDiscreteAction,
    DistributionalSingleModelStateQFunctionWithDiscreteAction,
    DuelingDQN,
    FCLateActionSAQFunction,
    FCSAQFunction,
    FCStateQFunctionWithDiscreteAction,
    ImplicitQuantileQFunction,
)
from pfrl_tpu_torch.utils.precision import (
    apply_cast,
    cast_floating,
    cast_to_float32,
    check_compute_dtype,
    softmax,
    softplus,
)

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
JDT = {BF16: jnp.bfloat16, F32: jnp.float32}
OBS, ACT, HIDDEN, ATOMS = 4, 3, 32, 51
JIT_ULPS = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    """A bf16 or float32 array/tensor as float32 numpy, exactly."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(F32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------ cast helpers
def test_cast_helpers_touch_only_floats():
    tree = {
        "w": torch.ones(4, 4),
        "frames": torch.ones(2, dtype=torch.uint8),
        "n": torch.ones((), dtype=torch.int32),
        "flag": torch.ones(3, dtype=torch.bool),
        "pair": (torch.ones(2), [torch.zeros(2, dtype=torch.int64)]),
    }
    lo = cast_floating(tree, BF16)
    assert lo["w"].dtype == lo["pair"][0].dtype == BF16
    assert lo["frames"].dtype == torch.uint8 and lo["n"].dtype == torch.int32 and lo["flag"].dtype == torch.bool
    assert lo["pair"][1][0].dtype == torch.int64 and isinstance(lo["pair"], tuple) and isinstance(lo["pair"][1], list)
    hi = cast_to_float32(lo)
    assert hi["w"].dtype == hi["pair"][0].dtype == F32 and hi["frames"].dtype == torch.uint8
    assert cast_floating(tree, None) is tree
    assert check_compute_dtype(None) is None and check_compute_dtype(BF16) is BF16
    for bad in (torch.int32, "bfloat16", jnp.bfloat16):
        with pytest.raises(ValueError, match="compute_dtype"):
            check_compute_dtype(bad)


def _bf(*shape):
    return torch.linspace(-2.0, 2.0, int(np.prod(shape))).reshape(shape).to(BF16)


OUTPUTS = {
    "tensor": lambda: _bf(3),
    "tuple": lambda: (Categorical(logits=_bf(2, 3)), _bf(2, 1)),
    "discrete": lambda: DiscreteActionValue(q_values=_bf(2, 3)),
    "distributional": lambda: DistributionalDiscreteActionValue(q_dist=_bf(2, 3, 5), z_values=_bf(5)),
    "quantile": lambda: QuantileDiscreteActionValue(quantiles=_bf(2, 4, 3)),
    "normal": lambda: Normal(loc=_bf(2, 3), scale=_bf(2, 3).abs() + 1),
    "squashed_normal": lambda: SquashedNormal(loc=_bf(2, 3), scale=_bf(2, 3).abs() + 1),
    "delta": lambda: Delta(loc=_bf(2, 3)),
    "categorical": lambda: Categorical(logits=_bf(2, 3)),
}


@pytest.mark.parametrize("kind", sorted(OUTPUTS))
def test_cast_to_float32_knows_every_output_type(kind):
    out = OUTPUTS[kind]()
    back = cast_to_float32(out)
    assert type(back) is type(out)
    lo, hi = _leaves(out), _leaves(back)
    assert sorted(lo) == sorted(hi) and lo
    for path, x in lo.items():
        assert x.dtype == BF16 and hi[path].dtype == F32
        np.testing.assert_array_equal(hi[path].numpy(), x.to(F32).numpy())  # an exact widening


# --------------------------------------------------------------- apply_cast
def test_apply_cast_gradients_reach_the_float32_masters():
    model = FCStateQFunctionWithDiscreteAction(OBS, ACT, 2, HIDDEN)
    x = torch.randn(8, OBS, generator=torch.Generator().manual_seed(0))
    params = list(model.parameters())
    out = apply_cast(model, BF16, x)
    assert out.q_values.dtype == F32
    grads = torch.autograd.grad(out.q_values.square().sum(), params)
    assert all(g.dtype == F32 and g.shape == p.shape and bool(g.abs().max() > 0) for g, p in zip(grads, params))
    assert all(p.dtype == F32 for p in model.parameters())  # the masters are untouched
    # The same gradient as a bf16 copy's, widened: a cast's backward is an up-cast.
    lo = FCStateQFunctionWithDiscreteAction(OBS, ACT, 2, HIDDEN).to(BF16)
    lo.load_state_dict({k: v.to(BF16) for k, v in model.state_dict().items()})
    lo_grads = torch.autograd.grad(lo(x.to(BF16)).q_values.float().square().sum(), list(lo.parameters()))
    for g, h in zip(grads, lo_grads):
        np.testing.assert_array_equal(g.numpy(), h.to(F32).numpy())
    assert apply_cast(model, None, x).q_values.dtype == F32


def test_apply_cast_leaves_buffers_keywords_and_uncast_args_in_float32():
    seen = {}

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))
            self.register_buffer("z", torch.linspace(0, 1, 3))

        def forward(self, a, b, c=None):
            seen.update(w=self.w.dtype, z=self.z.dtype, a=a.dtype, b=b.dtype, c=c.dtype)
            return a * self.w

    out = apply_cast(Probe(), BF16, torch.ones(3), torch.ones(3), c=torch.ones(3), uncast_argnums=(1,))
    assert seen == dict(w=BF16, z=F32, a=BF16, b=F32, c=F32) and out.dtype == F32
    model = DistributionalFCStateQFunctionWithDiscreteAction(OBS, ACT, ATOMS, 0.0, 500.0, 2, HIDDEN)
    av = apply_cast(model, BF16, torch.zeros(2, OBS))
    assert model.z_values.dtype == F32
    np.testing.assert_array_equal(av.z_values.numpy(), model.z_values.numpy())  # never rounded to bf16


# --------------------------------------------------- the promotion table
def _jax_dense(kind):
    if kind == "dense":
        return nn.Dense(5)
    if kind == "conv":
        return nn.Conv(4, (3, 3), strides=(2, 2), padding="VALID")
    return FactorizedNoisyDense(features=5, sigma_scale=0.5)


def _port_layer(kind):
    if kind == "dense":
        return Linear(7, 5)
    if kind == "conv":
        return Conv2d(3, 4, 3, stride=2)
    return FactorizedNoisyLinear(7, 5, 0.5)


class _Scoped(torch.nn.Module):
    """One bare layer under the flax scope ``layer``, for the converter."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def flax_names(self):
        return {"layer": "layer"}


def _load_layer(layer, params):
    convert.load_flax_params(_Scoped(layer), {"params": {"layer": params["params"]}})
    return layer


@pytest.mark.parametrize("x_dtype,p_dtype", [(BF16, BF16), (BF16, F32), (F32, BF16), (F32, F32)])
@pytest.mark.parametrize("kind", ["dense", "conv", "noisy", "noisy_deterministic"])
def test_layers_promote_like_flax(monkeypatch, kind, x_dtype, p_dtype):
    rs = np.random.RandomState(0)
    conv = kind == "conv"
    x = rs.normal(size=(6, 9, 9, 3) if conv else (6, 7)).astype(np.float32)
    jlayer = _jax_dense(kind.replace("_deterministic", ""))
    kw = {"deterministic": True} if kind == "noisy_deterministic" else {}
    params = np_tree(jlayer.init({"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, x, **kw))
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(JDT[p_dtype]), params)
    log = record_normals(monkeypatch)
    with jax.disable_jit():
        want = jlayer.apply(jparams, jnp.asarray(x).astype(JDT[x_dtype]), rngs={"noise": jax.random.PRNGKey(3)}, **kw)
    layer = _load_layer(_port_layer(kind.replace("_deterministic", "")), params).to(p_dtype)
    tx = _t(x).to(x_dtype)
    with torch.no_grad():
        if conv:
            got = layer(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        elif kind.startswith("noisy"):
            got = layer(tx, ReplayedNormals(log), deterministic=bool(kw))
        else:
            got = layer(tx)
    noisy = kind == "noisy"
    want_dtype = F32 if (noisy or F32 in (x_dtype, p_dtype)) else BF16
    assert str(want.dtype) == str(JDT[want_dtype].dtype) and got.dtype == want_dtype
    if want_dtype == BF16:
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)


def test_fused_bias_would_round_once_and_differ_from_flax():
    """Why the layers add the bias after the bf16 product: ``F.linear``'s
    fused bias differs from flax's Dense by an ulp in many outputs."""
    rs = np.random.RandomState(1)
    x, w, b = rs.normal(size=(64, 100)), rs.normal(size=(100, 100)) * 0.1, rs.normal(size=100)
    params = {"params": {"kernel": jnp.asarray(w).astype(jnp.bfloat16), "bias": jnp.asarray(b).astype(jnp.bfloat16)}}
    with jax.disable_jit():
        want = _np(nn.Dense(100).apply(params, jnp.asarray(x).astype(jnp.bfloat16)))
    tx, tw, tb = (_t(a).to(BF16) for a in (x, w.T, b))
    fused = _np(torch.nn.functional.linear(tx, tw, tb))
    assert (fused != want).mean() > 0.05
    layer = Linear(100, 100).to(BF16)
    layer.weight.data, layer.bias.data = tw, tb
    np.testing.assert_array_equal(_np(layer(tx)), want)


@pytest.mark.parametrize("fn", ["softmax", "softplus"])
def test_softmax_and_softplus_are_spelled_op_by_op_below_float32(fn):
    x = np.random.RandomState(2).normal(size=(16, 6, 51)).astype(np.float32) * 3
    jfn = {"softmax": lambda v: jax.nn.softmax(v, axis=-1), "softplus": jax.nn.softplus}[fn]
    tfn = {"softmax": lambda v: softmax(v, dim=-1), "softplus": softplus}[fn]
    fused = {"softmax": lambda v: torch.softmax(v, -1), "softplus": torch.nn.functional.softplus}[fn]
    with jax.disable_jit():
        want = _np(jfn(jnp.asarray(x).astype(jnp.bfloat16)))
    tx = _t(x).to(BF16)
    got = tfn(tx)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), want)
    assert (_np(fused(tx)) != want).mean() > 0.05  # the fused kernel rounds once
    np.testing.assert_array_equal(tfn(_t(x)).numpy(), fused(_t(x)).numpy())  # float32 is the fused op


def test_constants_follow_jax_promotion_not_the_0d_rule():
    """A 0-d float32 tensor times a bf16 tensor is bf16 in torch and float32
    in JAX; the port's forwards take Python scalars (weak in both) or
    tensors of a dimension, never 0-d float32 tensors, so they promote as JAX
    does. The two rules, and a forward of every kind, show it."""
    x = torch.ones(3, dtype=BF16)
    assert (x * torch.tensor(2.0)).dtype == BF16 and (x * torch.tensor([2.0])).dtype == F32
    assert (jnp.ones(3, jnp.bfloat16) * jnp.asarray(2.0, jnp.float32)).dtype == jnp.float32
    assert (x * 2.0).dtype == BF16 and (jnp.ones(3, jnp.bfloat16) * 2.0).dtype == jnp.bfloat16
    head = mac.squashed_gaussian_policy(OBS, ACT, HIDDEN)
    dist = head.head(torch.zeros(2, 2 * ACT, dtype=BF16))  # clamp and exp of bf16 with Python bounds
    assert dist.loc.dtype == dist.scale.dtype == BF16


# ---------------------------------------------------- whole networks, bf16
def _cartpole_obs(rs, n):
    return (rs.uniform(-1, 1, (n, OBS)) * np.array([2.0, 2.0, 0.2, 2.0])).astype(np.float32)


class JaxNatureQ(nn.Module):
    """``bench.py``'s ``NatureQ``, ``dense_cls`` for the noisy head."""

    dense_cls: object = None

    @nn.compact
    def __call__(self, x):
        h = JaxLargeAtariCNN()(x)
        dense = self.dense_cls(6) if self.dense_cls else nn.Dense(6)
        return JaxHead()(dense(h))


def _frames(rs, b=4):
    return rs.randint(0, 256, (b, 84, 84, 4)).astype(np.float32) / np.float32(255.0)


def _pendulum(rs, n):
    th = rs.uniform(-np.pi, np.pi, n)
    return np.stack([np.cos(th), np.sin(th), rs.uniform(-8, 8, n)], axis=1).astype(np.float32)


class SoftmaxProbs(Probs):
    """``Probs`` with ``jax.nn.softmax``'s arithmetic in every dtype."""

    def forward(self, x):
        return softmax(self.mlp(x).reshape(x.shape[0], -1, ATOMS), dim=-1)


def _network(kind, rs):
    """``(flax module, port module, inputs, uncast_argnums, noisy)``."""
    noisy_dense = lambda f, **kw: FactorizedNoisyDense(features=f, sigma_scale=0.5)  # noqa: E731
    if kind == "nature_q":
        return JaxNatureQ(), NatureQ(6), (_frames(rs),), (), False
    if kind == "noisy_nature_q":
        return (JaxNatureQ(noisy_dense), NatureQ(6, dense_cls=to_factorized_noisy(sigma_scale=0.5)),
                (_frames(rs),), (), True)
    if kind in ("dueling", "noisy_distributional_dueling", "distributional_dueling"):
        noisy = kind.startswith("noisy")
        dense = noisy_dense if noisy else None
        tdense = (lambda i, o: FactorizedNoisyLinear(i, o, 0.5)) if noisy else None
        if kind == "dueling":
            return jq.DuelingDQN(6), DuelingDQN(6), (_frames(rs, 3),), (), False
        return (jq.DistributionalDuelingDQN(6, 11, -10.0, 10.0, dense_cls=dense),
                DistributionalDuelingDQN(6, 11, -10.0, 10.0, dense_cls=tdense), (_frames(rs, 3),), (), noisy)
    obs = _cartpole_obs(rs, 16)
    if kind == "fc":
        return (jq.FCStateQFunctionWithDiscreteAction(n_actions=2, n_hidden_channels=100, n_hidden_layers=2),
                FCStateQFunctionWithDiscreteAction(OBS, 2, 2, 100), (obs,), (), False)
    if kind == "distributional_fc":
        return (jq.DistributionalFCStateQFunctionWithDiscreteAction(
                    n_actions=2, n_atoms=ATOMS, v_min=0.0, v_max=500.0, n_hidden_channels=HIDDEN, n_hidden_layers=2),
                DistributionalFCStateQFunctionWithDiscreteAction(OBS, 2, ATOMS, 0.0, 500.0, 2, HIDDEN), (obs,), (), False)
    if kind == "distributional_single_model":
        z = tuple(np.linspace(0, 1, ATOMS).tolist())
        return (jq.DistributionalSingleModelStateQFunctionWithDiscreteAction(model=JaxProbs(), z_values=z),
                DistributionalSingleModelStateQFunctionWithDiscreteAction(SoftmaxProbs(), z), (obs,), (), False)
    if kind == "iqn":
        taus = rs.uniform(size=(16, 8)).astype(np.float32)
        return (jq.ImplicitQuantileQFunction(psi=JaxPsi(out=HIDDEN, hidden=HIDDEN), n_actions=2, n_basis_functions=64),
                ImplicitQuantileQFunction(ReLUMLP(OBS, HIDDEN, HIDDEN), HIDDEN, 2, 64), (obs, taus), (1,), False)
    pend = _pendulum(rs, 16)
    act = rs.uniform(-1, 1, (16, 1)).astype(np.float32)
    if kind == "sac_policy":
        return JaxSACPolicy(act_dim=1, hidden=256), mac.squashed_gaussian_policy(3, 1, 256), (pend,), (), False
    if kind == "deterministic_policy":
        return JaxDetPolicy(act_dim=1, hidden=64), mac.deterministic_policy(3, 1, 64), (pend,), (), False
    if kind == "fc_critic":
        return (jq.FCSAQFunction(n_hidden_channels=256, n_hidden_layers=2), FCSAQFunction(3, 1, 256, 2),
                (pend, act), (), False)
    if kind == "late_action_critic":
        return (jq.FCLateActionSAQFunction(n_hidden_channels=64, n_hidden_layers=2), FCLateActionSAQFunction(3, 1, 64, 2),
                (pend, act), (), False)
    if kind == "gaussian_piv":
        x = rs.normal(size=(16, 17)).astype(np.float32)
        return JaxGaussianPiV(act_dim=6, hidden=64), GaussianPiV(17, 6, 64), (x,), (), False
    return JaxSoftmaxPiV(n_actions=2, hidden=64), SoftmaxPiV(OBS, 2, 64), (obs,), (), False


NETWORKS = ["nature_q", "noisy_nature_q", "dueling", "distributional_dueling", "noisy_distributional_dueling",
            "fc", "distributional_fc", "distributional_single_model", "iqn", "sac_policy", "deterministic_policy",
            "fc_critic", "late_action_critic", "gaussian_piv", "softmax_piv"]
CNN = {"nature_q", "noisy_nature_q", "dueling", "distributional_dueling", "noisy_distributional_dueling"}


def _within_ulps(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=JIT_ULPS * 2.0**-8 * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _leaves(out, prefix=""):
    """``{path: array}`` of the float leaves of an output (JAX or port)."""
    if isinstance(out, (tuple, list)):
        return {k: v for i, o in enumerate(out) for k, v in _leaves(o, f"{prefix}{i}.").items()}
    if dataclasses.is_dataclass(out) or hasattr(out, "__dataclass_fields__"):
        return {k: v for f in dataclasses.fields(out) for k, v in _leaves(getattr(out, f.name), f"{prefix}{f.name}.").items()}
    return {prefix.rstrip("."): out}


def _jax_apply(jmodel, params, args, uncast, rng):
    return jprecision.apply_cast(jmodel, params, jnp.bfloat16, *[jnp.asarray(a) for a in args],
                                 uncast_argnums=uncast, rngs={"noise": rng})


@pytest.mark.parametrize("kind", NETWORKS)
def test_bf16_forward_matches_jax_to_the_bit_eagerly_and_within_ulps_jitted(monkeypatch, kind):
    rs = np.random.RandomState(NETWORKS.index(kind))
    jmodel, tmodel, args, uncast, noisy = _network(kind, rs)
    params = np_tree(jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                 *[jnp.asarray(a) for a in args]))
    convert.load_flax_params(tmodel, params)
    log = record_normals(monkeypatch)
    with jax.disable_jit():
        want = _jax_apply(jmodel, params, args, uncast, jax.random.PRNGKey(2))
    draws = ReplayedNormals(log)
    takes_draws = not kind.endswith(("policy", "critic", "piv"))
    with torch.no_grad():
        got = apply_cast(tmodel, BF16, *[_t(a) for a in args], *([draws] if takes_draws else []),
                         uncast_argnums=uncast)
    assert not draws.queue and bool(log) == noisy
    jl, tl = _leaves(want), _leaves(got)
    assert sorted(jl) == sorted(tl)
    for path, w in jl.items():
        g = tl[path]
        assert g.dtype == F32 and str(w.dtype) == "float32", path
        if path.startswith("z_values"):
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=path)  # float32 buffers, never cast
        elif kind in CNN:
            _within_ulps(_np(g), _np(w), f"{kind} {path}")
        elif kind == "iqn":
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{kind} {path}")
    if noisy:
        return  # the noise is logged from the eager run only
    jitted = jax.jit(lambda p, *a: _jax_apply(jmodel, p, a, uncast, jax.random.PRNGKey(2)))(params, *args)
    for path, w in _leaves(jitted).items():
        _within_ulps(_np(tl[path]), _np(w), f"jitted {kind} {path}")


def test_nature_cnn_layers_round_alike_but_for_rare_accumulation_order_flips():
    """Each layer of the Nature CNN, fed the JAX package's bf16 input to it,
    against flax's layer: at most 1e-4 of the outputs differ, each by one
    bf16 ulp of the product (the float32 sum landed on the other side of a
    rounding boundary) carried through the bias's rounded sum; most layers
    match to the bit."""
    x = _frames(np.random.RandomState(5), 8)
    jmodel = JaxLargeAtariCNN()
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                          np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"])
    tmodel = NatureQ(6).torso
    h = jnp.asarray(x).astype(jnp.bfloat16)
    flips = []
    for i, (features, k, s) in enumerate([(32, 8, 4), (64, 4, 2), (64, 3, 1)]):
        with jax.disable_jit():
            want = nn.Conv(features, (k, k), strides=(s, s), padding="VALID").apply({"params": params[f"Conv_{i}"]}, h)
        layer = _load_layer(tmodel.convs[i], {"params": jax.tree.map(_np, params[f"Conv_{i}"])}).to(BF16)
        with torch.no_grad():
            got = layer(_t(_np(h)).to(BF16).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        flips.append(_assert_rare_one_ulp_flips(_np(got), _np(want), _np(params[f"Conv_{i}"]["bias"]), f"Conv_{i}"))
        h = jax.nn.relu(want)
    h = h.reshape(h.shape[0], -1)
    with jax.disable_jit():
        want = nn.Dense(512).apply({"params": params["Dense_0"]}, h)
    layer = _load_layer(tmodel.dense, {"params": jax.tree.map(_np, params["Dense_0"])}).to(BF16)
    with torch.no_grad():
        got = _np(layer(_t(_np(h)).to(BF16)))
    flips.append(_assert_rare_one_ulp_flips(got, _np(want), _np(params["Dense_0"]["bias"]), "Dense_0"))
    assert flips.count(0) >= 2, flips


def _assert_rare_one_ulp_flips(got, want, bias, what):
    """A flip: one ulp of the rounded product, carried through the bias's
    rounded sum (one ulp of the result more)."""
    differ = got != want

    def ulp(v):
        return 2.0 ** (np.floor(np.log2(np.maximum(v, 2.0**-126))) - 7)

    assert differ.mean() <= 1e-4, (what, differ.mean())
    product = np.maximum(np.abs(want - bias), np.abs(got - bias))
    ulp = ulp(product) + ulp(np.maximum(np.abs(want), np.abs(got)))
    assert (np.abs(got - want)[differ] <= ulp[differ]).all(), what
    return int(differ.sum())


def test_jitted_jax_differs_from_eager_somewhere():
    """The jitted bound above is not idle: under ``jax.jit`` XLA keeps
    excess precision inside fusions and some outputs differ from the eager
    bf16 run (and so from the port)."""
    rs = np.random.RandomState(0)
    jmodel, tmodel, args, uncast, _ = _network("distributional_fc", rs)
    params = np_tree(jmodel.init(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args]))
    with jax.disable_jit():
        eager = _jax_apply(jmodel, params, args, uncast, jax.random.PRNGKey(2)).q_dist
    jitted = jax.jit(lambda p, a: _jax_apply(jmodel, p, (a,), uncast, jax.random.PRNGKey(2)))(params, args[0]).q_dist
    assert (_np(eager) != _np(jitted)).any()


# ------------------------------------------------------------- device flags
def test_use_full_fp32_turns_the_reduced_precision_reduction_off(monkeypatch):
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    for obj, name in ((matmul, "allow_tf32"), (cudnn, "allow_tf32"), (matmul, "allow_bf16_reduced_precision_reduction")):
        monkeypatch.setattr(obj, name, True)
    _device.use_full_fp32()
    assert matmul.allow_bf16_reduced_precision_reduction is False
    assert matmul.allow_tf32 is False and cudnn.allow_tf32 is False


# ------------------------------------------------------------- the tools
def test_every_profiled_config_builds_at_bf16_and_trpo_refuses():
    from pfrl_tpu_torch.experiments import acer, recurrent
    from pfrl_tpu_torch.experiments.profile_slice import CONFIGS

    for name, make in CONFIGS.items():
        if name in ("trpo", "rtrpo-delayedcue-16"):
            with pytest.raises(ValueError, match="TRPO"):
                make(device="cpu", compute_dtype=BF16)
            continue
        # A small replay: ring slots, or (episodic, above 2 x lanes) rows.
        episodic = name in recurrent.RECIPES or name in acer.RECIPES
        runner = make(device="cpu", compute_dtype=BF16, capacity=96 if episodic else 1_024)
        assert runner.core.compute_dtype is BF16, name


def test_profile_slice_times_under_the_torch_profiler(monkeypatch):
    """``_profiled`` (also used by ``chip_smoke.py``) runs a function under
    ``torch.profiler``; on the CPU it counts no kernels."""
    from pfrl_tpu_torch.experiments import profile_slice

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    out, seconds, kernels, busy_us, top = profile_slice._profiled(lambda: torch.ones(8).sum())
    assert float(out) == 8.0 and seconds >= 0.0
    assert (kernels, busy_us, top) == (0, 0, [])


def test_count_ops_counts_the_casts_that_bf16_adds():
    from pfrl_tpu_torch.experiments.count_ops import count_ops

    fp32 = count_ops("dqn-cartpole", 1, "cpu")
    bf16 = count_ops("dqn-cartpole", 1, "cpu", BF16)
    assert fp32["compute_dtype"] == "None" and bf16["compute_dtype"] == "torch.bfloat16"
    assert bf16["ops_per_scan_step"] > fp32["ops_per_scan_step"]
    casts = lambda r: r["top_ops_per_scan_step"].get("aten._to_copy", 0)  # noqa: E731
    assert casts(bf16) > casts(fp32) + 8 * 6  # at least the six parameters' casts per update
