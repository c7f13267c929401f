"""The port's last sibling modules against the JAX package's, on the same
numpy inputs: flax-exact ``BatchNorm`` under ``MLPBN``, the batch-norm and
LSTM (state, action) Q-functions, ``Branched``, ``Lambda``,
``BoundByTanh``, ``ConcatObsAndAction``, ``EmpiricalNormalization``,
``synchronize_parameters`` and ``RMSpropEpsInsideSqrt``.

Weights are the JAX modules' own, initialized from a key and converted
(``convert.load_flax_params``, ``batch_stats`` included). Tolerances:

- the batch-norm modules, the LSTM Q-function and ``EmpiricalNormalization``
  within 4x the larger of what 1 + 2**-23 and 1 - 2**-23 nudges of the
  port's own weights and of the inputs move each tensor (the normalizer has
  no weights; an input BatchNorm sees only the inputs). XLA on the CPU sums a batch row by row and takes
  its own ``rsqrt`` and ``tanh``; torch sums in another order, so a batch
  mean or an activation lands an ulp away (ROADMAP C89);
- ``BoundByTanh``'s arithmetic to the bit on the same ``tanh`` values, and
  ``tanh`` itself within 4 float32 ulps (XLA's and torch's differ in the
  last bits);
- ``Branched`` and ``Lambda`` around MLPs within 1e-6 absolute (dots over
  at most 16 terms, summed in another order, as in
  ``test_torch_actor_critic_modules.py``);
- ``ConcatObsAndAction``, ``synchronize_parameters`` and
  ``RMSpropEpsInsideSqrt`` (elementwise float32 arithmetic in the same
  order; the root and the division correctly rounded in both) to the bit.

The converters run both ways on every module here: ``flax_arrays`` of the
port module is the JAX variables tree, leaf for leaf, to the bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pfrl_tpu import models as jmodels
from pfrl_tpu import q_functions as jq
from pfrl_tpu.optimizers import rmsprop_eps_inside_sqrt
from pfrl_tpu.utils.copy_param import synchronize_parameters as jax_synchronize_parameters
from pfrl_tpu_torch import convert, models, q_functions
from pfrl_tpu_torch.optimizers import RMSpropEpsInsideSqrt
from pfrl_tpu_torch.utils import synchronize_parameters

torch.set_num_threads(1)

NUDGES = (1.0 + 2.0**-23, 1.0 - 2.0**-23)
OBS, ACT, HIDDEN, BATCH = 5, 3, 16, 32


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def nudged(module, factor):
    """A copy of ``module`` whose parameters are multiplied by ``factor``;
    the tests hand it the inputs multiplied by ``factor`` too, since an
    input BatchNorm's statistics see only the input."""
    out = copy.deepcopy(module)
    with torch.no_grad():
        for p in out.parameters():
            p.mul_(factor)
    return out


def assert_within_nudges(got, want, moved, what):
    """``got`` (the port) within 4x the larger nudge move ``moved`` of
    ``want`` (JAX); both nudges must move it, or it must be equal."""
    got, want = _np(got), _np(want)
    bound = 4 * max(float(np.abs(_np(m) - got).max()) for m in moved)
    diff = float(np.abs(got - want).max())
    assert diff <= bound, f"{what}: {diff} > {bound} (4x the nudges)"


def assert_stats_within_nudges(module, nudged_modules, want, what):
    """Every running statistic of ``module`` against flax's ``batch_stats``
    ``want``, leaf for leaf, by :func:`assert_within_nudges`."""
    trees = [convert.flax_arrays(m)["batch_stats"] for m in (module, *nudged_modules)]
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(np_tree(want))]
    assert paths == [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(trees[0])]
    for path, w, g, *m in zip(paths, *(jax.tree_util.tree_leaves(t) for t in (np_tree(want), *trees))):
        assert_within_nudges(g, w, m, f"{what} {path}")


def assert_same_tree(got, want, path="tree"):
    """The same keys, shapes, dtypes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), path


def batches(n, size, seed=0, width=OBS + ACT):
    rs = np.random.RandomState(seed)
    return [(rs.normal(size=(size, width)) * 3 + 1).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------- MLPBN
CASES = [(True, False), (False, True), (True, True), (False, False)]


@pytest.mark.parametrize("normalize_input,normalize_output", CASES)
def test_mlpbn_scopes_follow_flax_call_order(normalize_input, normalize_output):
    jm = jmodels.MLPBN(out_size=3, hidden_sizes=(HIDDEN, 8), normalize_input=normalize_input,
                       normalize_output=normalize_output)
    v = np_tree(jm.init(jax.random.PRNGKey(0), np.zeros((2, OBS), np.float32)))
    tm = models.MLPBN(OBS, 3, (HIDDEN, 8), normalize_input=normalize_input, normalize_output=normalize_output)
    names = tm.flax_names()
    bns = [n for n in names.values() if n.startswith("BatchNorm_")]
    assert sorted(names.values()) == sorted(v["params"]) and len(bns) == 2 + normalize_input + normalize_output
    assert names["hidden_bns.0"] == f"BatchNorm_{int(normalize_input)}"
    if normalize_output:
        assert names["output_bn"] == f"BatchNorm_{len(bns) - 1}"
    convert.load_flax_params(tm, v)
    assert_same_tree(convert.flax_arrays(tm), v)  # both ways, batch_stats included


@pytest.mark.parametrize("normalize_input,normalize_output", CASES)
def test_mlpbn_train_and_eval_match_flax(normalize_input, normalize_output):
    """Three train-mode calls (outputs and the running statistics after
    each, against ``apply(..., mutable=["batch_stats"])``), then an eval
    forward on the running statistics."""
    jm = jmodels.MLPBN(out_size=3, hidden_sizes=(HIDDEN, 8), normalize_input=normalize_input,
                       normalize_output=normalize_output)
    xs = batches(4, BATCH, width=OBS)
    v = jm.init(jax.random.PRNGKey(1), xs[0])
    tm = convert.load_flax_params(
        models.MLPBN(OBS, 3, (HIDDEN, 8), normalize_input=normalize_input, normalize_output=normalize_output),
        np_tree(v))
    nms = [nudged(tm, f) for f in NUDGES]
    for i, x in enumerate(xs[:3]):
        y, mutated = jm.apply(v, x, mutable=["batch_stats"])
        v = {"params": v["params"], **mutated}
        got = tm(_t(x), train=True)
        assert_within_nudges(got, y, [m(_t(x * f), train=True) for m, f in zip(nms, NUDGES)], f"train call {i}")
        assert_stats_within_nudges(tm, nms, v["batch_stats"], f"batch_stats after call {i}")
    y = jm.apply(v, xs[3], train=False)
    x = xs[3]
    assert_within_nudges(tm(_t(x), train=False), y, [m(_t(x * f), train=False) for m, f in zip(nms, NUDGES)], "eval")
    before = convert.flax_arrays(tm)["batch_stats"]
    tm(_t(xs[3]), train=False)
    assert_same_tree(convert.flax_arrays(tm)["batch_stats"], before)  # eval moves nothing


def test_batch_norm_is_not_torchs():
    """flax's biased running variance and momentum 0.99, not
    ``torch.nn.BatchNorm1d``'s unbiased variance and momentum 0.1."""
    x = batches(1, 8, width=4)[0]
    bn = models.BatchNorm(4)
    bn(_t(x), train=True)
    xt = _t(x).double()
    mean, var = xt.mean(0), xt.var(0, unbiased=False)
    np.testing.assert_allclose(_np(bn.mean), 0.01 * mean.numpy(), rtol=1e-5)
    np.testing.assert_allclose(_np(bn.var), 0.99 + 0.01 * var.numpy(), rtol=1e-5)
    torch_bn = torch.nn.BatchNorm1d(4)
    torch_bn(_t(x))
    assert not np.allclose(_np(torch_bn.running_var), _np(bn.var), rtol=1e-3)


# ------------------------------------------------- (state, action) Q-functions
def _bn_q(kind):
    if kind == "FCBNSAQFunction":
        return (jq.FCBNSAQFunction(n_hidden_channels=HIDDEN, n_hidden_layers=2),
                q_functions.FCBNSAQFunction(OBS, ACT, HIDDEN, 2))
    return (jq.FCBNLateActionSAQFunction(n_hidden_channels=HIDDEN, n_hidden_layers=2),
            q_functions.FCBNLateActionSAQFunction(OBS, ACT, HIDDEN, 2))


@pytest.mark.parametrize("kind", ["FCBNSAQFunction", "FCBNLateActionSAQFunction"])
def test_bn_q_functions_match_flax(kind):
    jqf, tqf = _bn_q(kind)
    data = batches(4, BATCH)
    obs, act = [d[:, :OBS] for d in data], [np.tanh(d[:, OBS:]) for d in data]
    v = jqf.init(jax.random.PRNGKey(2), obs[0], act[0])
    convert.load_flax_params(tqf, np_tree(v))
    assert_same_tree(convert.flax_arrays(tqf), np_tree(v))
    if kind == "FCBNLateActionSAQFunction":  # the action is never normalized
        assert tqf.obs_mlp.input_bn.scale.shape == (OBS,) and tqf.mlp.layers[0].in_features == HIDDEN + ACT
    nqs = [nudged(tqf, f) for f in NUDGES]
    for i in range(3):
        q, mutated = jqf.apply(v, obs[i], act[i], mutable=["batch_stats"])
        v = {"params": v["params"], **mutated}
        got = tqf(_t(obs[i]), _t(act[i]), train=True)
        assert got.shape == (BATCH,)
        assert_within_nudges(got, q, [m(_t(obs[i] * f), _t(act[i] * f), train=True) for m, f in zip(nqs, NUDGES)],
                             f"{kind} train {i}")
    assert_stats_within_nudges(tqf, nqs, v["batch_stats"], f"{kind} batch_stats")
    q = jqf.apply(v, obs[3], act[3], train=False)
    assert_within_nudges(tqf(_t(obs[3]), _t(act[3]), train=False), q,
                         [m(_t(obs[3] * f), _t(act[3] * f), train=False) for m, f in zip(nqs, NUDGES)], f"{kind} eval")


def test_bn_q_function_gradients_match_flax():
    """One train-mode gradient of the late-action critic's mean Q."""
    jqf, tqf = _bn_q("FCBNLateActionSAQFunction")
    d = batches(1, BATCH, seed=3)[0]
    obs, act = d[:, :OBS], np.tanh(d[:, OBS:])
    v = jqf.init(jax.random.PRNGKey(3), obs, act)
    convert.load_flax_params(tqf, np_tree(v))

    def loss(params):
        q, _ = jqf.apply({"params": params, "batch_stats": v["batch_stats"]}, obs, act, mutable=["batch_stats"])
        return jnp.mean(q)

    jgrad = np_tree(jax.grad(loss)(v["params"]))

    def port_grad(module, f=1.0):
        module.zero_grad()
        module(_t(obs * f), _t(act * f), train=True).mean().backward()
        return convert.flax_arrays(module, {n: p.grad for n, p in module.named_parameters()})["params"]

    got, moved = port_grad(tqf), [port_grad(nudged(tqf, f), f) for f in NUDGES]
    for g, w, *m in zip(*(jax.tree_util.tree_leaves(t) for t in (got, jgrad, *moved))):
        assert_within_nudges(g, w, m, "gradient")


def test_fc_lstm_sa_q_function_matches_flax():
    """Five steps from ``initial_carry``: Q-values and carries; the
    sequence form equals the step loop to the bit."""
    jqf = jq.FCLSTMSAQFunction(n_hidden_channels=HIDDEN, n_hidden_layers=2)
    tqf = q_functions.FCLSTMSAQFunction(OBS, ACT, HIDDEN, 2)
    data = batches(5, 4, seed=4)
    obs, act = [d[:, :OBS] for d in data], [np.tanh(d[:, OBS:]) for d in data]
    jcarry = jqf.initial_carry(4)
    v = jqf.init(jax.random.PRNGKey(4), obs[0], act[0], jcarry)
    convert.load_flax_params(tqf, np_tree(v))
    names = tqf.flax_names()
    assert names["lstm.ih"][0] == "LSTMCellModule_0/OptimizedLSTMCell_0/ii"
    assert names["head.layers.0"] == "MLP_1/Dense_0"
    assert_same_tree(convert.flax_arrays(tqf), np_tree(v))  # the fused gates split back
    nqs = [nudged(tqf, f) for f in NUDGES]
    carries = [tqf.initial_carry(4, "cpu")] + [m.initial_carry(4, "cpu") for m in nqs]
    assert all(torch.equal(c, torch.zeros(4, HIDDEN)) for c in carries[0][0])
    steps = []
    for i in range(5):
        q, jcarry = jqf.apply(v, obs[i], act[i], jcarry)
        outs = [m(_t(obs[i] * f), _t(act[i] * f), c) for m, f, c in zip([tqf, *nqs], (1.0, *NUDGES), carries)]
        carries = [o[1] for o in outs]
        steps.append(outs[0][0])
        assert_within_nudges(outs[0][0], q, [o[0] for o in outs[1:]], f"q step {i}")
        for k in range(2):
            assert_within_nudges(carries[0][0][k], jcarry[0][k], [c[0][k] for c in carries[1:]], f"carry step {i}")
    qs, (carry,) = tqf(_t(np.stack(obs)), _t(np.stack(act)), tqf.initial_carry(4, "cpu"), sequence=True)
    assert torch.equal(qs, torch.stack(steps)) and all(torch.equal(a, b) for a, b in zip(carry, carries[0][0]))


# ---------------------------------------------- Branched, Lambda and the glue
def test_branched_and_lambda_around_mlps_match_flax():
    """A torso MLP, then ``Branched`` over two MLP heads and a ``Lambda``
    between them: flax names the heads ``branches_0`` and ``branches_2``."""
    x = batches(1, 6, seed=5, width=OBS)[0]
    jtorso = jmodels.MLP(out_size=HIDDEN, hidden_sizes=(HIDDEN,))
    jbranched = jmodels.Branched(branches=[
        jmodels.MLP(out_size=2), jmodels.Lambda(lambda h: jnp.sum(h, axis=-1)),
        jmodels.MLP(out_size=1, hidden_sizes=(8,)),
    ])
    vt = np_tree(jtorso.init(jax.random.PRNGKey(5), x))
    h = jtorso.apply(vt, x)
    vb = np_tree(jbranched.init(jax.random.PRNGKey(6), h))
    assert sorted(vb["params"]) == ["branches_0", "branches_2"]
    torso = models.MLP(OBS, HIDDEN, (HIDDEN,))
    branched = models.Branched([models.MLP(HIDDEN, 2), models.Lambda(lambda h: torch.sum(h, dim=-1)),
                                models.MLP(HIDDEN, 1, (8,))])
    assert branched.flax_names() == {"branches.0.layers.0": "branches_0/Dense_0",
                                     "branches.2.layers.0": "branches_2/Dense_0",
                                     "branches.2.layers.1": "branches_2/Dense_1"}
    convert.load_flax_params(torso, vt)
    convert.load_flax_params(branched, vb)
    assert_same_tree(convert.flax_arrays(branched), vb)
    want = jbranched.apply(vb, h)
    got = branched(torso(_t(x)))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6, rtol=0)
    lam = models.Lambda(torch.tanh)
    assert list(lam.parameters()) == []
    np.testing.assert_array_equal(_np(lam(got[0])), _np(torch.tanh(got[0])))


def test_bound_by_tanh_module_keeps_the_float32_arithmetic(monkeypatch):
    x = batches(1, 64, seed=6, width=3)[0]
    low, high = (-1.0, -2.0, 0.1), (1.0, 3.0, 2.3)  # 0.1 and 2.3 are not float32 numbers
    want = np.asarray(jmodels.BoundByTanh(low=low, high=high).apply({}, x))
    jtanh = np.asarray(jnp.tanh(x))
    ttanh = _np(torch.tanh(_t(x)))
    assert np.abs(ttanh.view(np.int32).astype(np.int64) - jtanh.view(np.int32)).max() <= 4
    module = models.BoundByTanh(low, high)
    monkeypatch.setattr(torch, "tanh", lambda t: _t(jtanh))  # the same tanh values
    np.testing.assert_array_equal(_np(module(_t(x))), want)


def test_concat_obs_and_action_matches_flax():
    obs, act = batches(1, 4, seed=7, width=OBS)[0], batches(1, 4, seed=8, width=ACT)[0]
    want = np.asarray(jmodels.ConcatObsAndAction().apply({}, obs, act))
    np.testing.assert_array_equal(_np(models.ConcatObsAndAction()(_t(obs), _t(act))), want)


# ------------------------------------------------------ EmpiricalNormalization
@pytest.mark.parametrize("until", [None, 250])
def test_empirical_normalization_matches_jax_across_until(until):
    """Six batches of 100 (``until`` 250 freezes the state after the third
    update, on the count before it), then ``normalize`` (clipped) and
    ``inverse``."""
    rs = np.random.RandomState(9)
    data = [(rs.normal(size=(100, 3)) * [1.0, 10.0, 0.1] + [5.0, -3.0, 0.0]).astype(np.float32) for _ in range(6)]
    jen = jmodels.EmpiricalNormalization((3,), until=until)
    ten = models.EmpiricalNormalization((3,), until=until)
    js = jen.init()
    states = [ten.init("cpu") for _ in range(3)]
    for i, b in enumerate(data):
        js = jax.jit(jen.update)(js, b)
        states = [ten.update(s, _t(b * f)) for s, f in zip(states, (1.0, *NUDGES))]
        assert float(states[0].count) == float(js.count) == (100 * min(i + 1, 3) if until else 100 * (i + 1))
        for field in ("mean", "var"):
            assert_within_nudges(getattr(states[0], field), getattr(js, field),
                                 [getattr(s, field) for s in states[1:]], f"{field} after update {i}")
    x = (data[0] * 2).astype(np.float32)
    y = np.asarray(jen.normalize(js, x))
    assert np.abs(y).max() == 5.0  # the clip is reached
    got = [ten.normalize(s, _t(x)) for s in states]
    assert_within_nudges(got[0], y, got[1:], "normalize")
    assert torch.equal(ten(states[0], _t(x)), got[0])
    inv = [ten.inverse(s, _t(y)) for s in states]
    assert_within_nudges(inv[0], jen.inverse(js, y), inv[1:], "inverse")


# ---------------------------------------------------- synchronize_parameters
@pytest.mark.parametrize("method", ["hard", "soft"])
def test_synchronize_parameters_matches_jax(method):
    """On an ``MLPBN`` whose running statistics have moved: the JAX function
    on the whole variables, the port's in place on the target module."""
    src, dst = models.MLPBN(OBS, 2, (HIDDEN,)), models.MLPBN(OBS, 2, (HIDDEN,))
    src.reset_parameters(torch.Generator().manual_seed(0))
    dst.reset_parameters(torch.Generator().manual_seed(1))
    src(_t(batches(1, 8, width=OBS)[0]), train=True)
    want = jax_synchronize_parameters(convert.flax_arrays(src), convert.flax_arrays(dst), method, tau=0.3)
    assert synchronize_parameters(src, dst, method, tau=0.3) is dst
    assert_same_tree(convert.flax_arrays(dst), np_tree(want))


def test_synchronize_parameters_rejects_an_unknown_method():
    a, b = models.MLP(OBS, 2), models.MLP(OBS, 2)
    with pytest.raises(ValueError, match="Unknown method"):
        synchronize_parameters(a, b, "polyak")
    with pytest.raises(ValueError, match="Unknown method"):
        jax_synchronize_parameters(convert.flax_arrays(a), convert.flax_arrays(b), "polyak")


# ------------------------------------------------------ RMSpropEpsInsideSqrt
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_rmsprop_eps_inside_sqrt_matches_the_jax_transform(centered, momentum):
    """Five steps on an MLP's parameters from seeded gradients (scaled so
    that ``v - m * m`` is near ``eps``), at the Nature DQN settings: every
    parameter and every tree of the state to the bit; the unused trees are
    ``()`` in both."""
    tm = models.MLP(OBS, 2, (HIDDEN,))
    tm.reset_parameters(torch.Generator().manual_seed(2))
    params = convert.flax_arrays(tm)
    tx = rmsprop_eps_inside_sqrt(2.5e-4, alpha=0.95, eps=1e-2, momentum=momentum, centered=centered)
    opt = RMSpropEpsInsideSqrt(2.5e-4, alpha=0.95, eps=1e-2, momentum=momentum, centered=centered)
    jstate, tparams = tx.init(params), list(tm.parameters())
    tstate = opt.init(tparams)
    names = [n for n, _ in tm.named_parameters()]
    rs = np.random.RandomState(10)
    for step in range(5):
        grads = {n: (rs.normal(size=p.shape) * 0.1).astype(np.float32) for n, p in tm.named_parameters()}
        jgrads = convert.flax_arrays(tm, {n: _t(g) for n, g in grads.items()})
        updates, jstate = tx.update(jgrads, jstate)
        params = optax.apply_updates(params, updates)
        opt.update(tparams, [_t(grads[n]) for n in names], tstate)
        assert_same_tree(convert.flax_arrays(tm), np_tree(params))
    for field in ("square_avg", "momentum_buf", "grad_avg"):
        want = getattr(jstate, field)
        got = getattr(tstate, field)
        if want == ():
            assert got == () and field != "square_avg"
            continue
        assert_same_tree(convert.flax_arrays(tm, dict(zip(names, got))), np_tree(want))
    assert (tstate.momentum_buf != ()) == (momentum > 0) and (tstate.grad_avg != ()) == centered


def test_rmsprop_eps_inside_sqrt_is_not_the_optax_rmsprop():
    """The same gradient through the port's ``RMSprop`` (``optax.rmsprop``)
    moves the parameters elsewhere: eps sits inside the root in both, but
    the decay's default and the order differ, and the Nature settings'
    ``alpha`` 0.95 is not ``decay`` 0.9."""
    from pfrl_tpu_torch.optimizers import RMSprop

    p1, p2 = [torch.ones(4)], [torch.ones(4)]
    g = [torch.full((4,), 0.5)]
    RMSpropEpsInsideSqrt(1e-2, alpha=0.95, eps=1e-2).update(p1, g, RMSpropEpsInsideSqrt(1e-2).init(p1))
    RMSprop(1e-2, eps=1e-2).update(p2, g, RMSprop(1e-2).init(p2))
    assert not torch.equal(p1[0], p2[0])


def test_a_jax_rmsprop_eps_inside_sqrt_state_converts():
    """``convert._load_optimizer`` reads the transform's state (and ``()``
    for an unused tree) into the port's."""
    tm = models.MLP(OBS, 2, (HIDDEN,))
    params = convert.flax_arrays(tm)
    tx = rmsprop_eps_inside_sqrt(1e-3, momentum=0.9)
    state = tx.init(params)
    _, state = tx.update(jax.tree.map(lambda p: jnp.full_like(p, 0.25), params), state)
    opt = RMSpropEpsInsideSqrt(1e-3, momentum=0.9)
    tstate = opt.init(list(tm.parameters()))
    convert._load_optimizer(opt, tstate, tm, np_tree(state))
    assert tstate.grad_avg == ()
    for field in ("square_avg", "momentum_buf"):
        got = convert.flax_arrays(tm, dict(zip([n for n, _ in tm.named_parameters()], getattr(tstate, field))))
        assert_same_tree(got, np_tree(getattr(state, field)))
    assert_same_tree(convert.optimizer_to_flax(opt, tstate, tm)["grad_avg"], {})
