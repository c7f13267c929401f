"""ACER's cores of the port against the JAX package's, from converted
states, 1 and 3 updates each on the same numpy rows and draws:
``ACERCore`` (discrete) and ``ACERContinuousCore`` (the SDN head), each
with the trust region on and off and with ``Q_opc`` on and off, at float32
and at bf16; also their act paths, the trust region's gradient in the
log-probs against ``jax.grad``, and the continuous update's draw order.
The networks are the ``tools/record_curves.py`` recipes' (``run_acer_abc``'s
``PiQ``, ``run_acer_continuous_abc``'s ``Pi``, ``V`` and ``FCSAQFunction``)
at width 16.

Data: rows ``[B=6, T=5]`` as the episodic buffer returns whole rows: lengths
5, 5, 3, 4, 1, 5, so that padding and each row's last valid step
(``is_last``) are exercised; two rows end ``terminated``, the others are
cut (no termination at their last step: the recursion bootstraps from
V(next_obs)); the padded steps hold zero behaviour statistics, as a fresh
buffer does (the continuous core patches them). The average model is the
initial weights times 0.9, so the trust region's ``k`` is not zero; a
``trust_region_delta`` of 1e-3 makes its projection act on most steps.

Draws: the discrete update draws nothing (its JAX update runs jitted); the
continuous update takes one normal of ``[5, B, T, d]`` for the SDN
expectation, then one of ``[B, T, d]`` for the correction (ROADMAP C25,
extended): :func:`install_acer_tape` hands them to the un-jitted JAX
update by value, the first through its ``vmap`` over split keys.

Tolerances (float32): losses and their parts 1e-5 relative (floor 1e-6);
parameters and the average model within 1e-6 after one update and 3e-6
after three (Adam's steps amplify rounding, ROADMAP C22); Adam's moments
1e-4 of each tensor's largest entry; the trust region's gradient 1e-6.
bf16 (JAX eager, ROADMAP C34): the first loss within 1e-3 relative; each
parameter tensor's change after one and three updates within 3% (L2,
relative), as ``test_torch_bf16_cores.py`` holds the other cores. The
SDN's advantage output bias cancels in Q and gets no true gradient: Adam
turns its rounding noise into steps of up to its learning rate, so it is
held within ``2 n lr`` at both precisions (measured 1.0e-2 after three
float32 updates, where every other parameter agrees within 1.2e-7).
"""

import copy
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_recurrent_cores import np_tree
from test_torch_recurrent_modules import install_recurrent_tape
from test_torch_sac import assert_network
from test_torch_value_modules import Tape, _is_abstract, _is_value_key

from pfrl_tpu import q_functions as jq
from pfrl_tpu.action_value import DiscreteActionValue as JaxDiscreteAV
from pfrl_tpu.agents.acer import ACERContinuousCore as JaxACERContinuous
from pfrl_tpu.agents.acer import ACERCore as JaxACER
from pfrl_tpu.agents.acer import ACERSDNModel as JaxSDN
from pfrl_tpu.distributions import Categorical as JaxCategorical
from pfrl_tpu.policies import GaussianHeadWithStateIndependentCovariance as JaxGaussianHead
from pfrl_tpu.replay.episodic import EpisodeBatch as JaxEpisodeBatch
from pfrl_tpu.replay.transition import Transition as JaxTransition
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents.acer import ACERContinuousCore, ACERCore, ACERSDNModel, policy_loss_grad
from pfrl_tpu_torch.experiments.acer import DensePiQ, DenseV, GaussianPi
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import FCSAQFunction
from pfrl_tpu_torch.replay.episodic import EpisodeBatch
from pfrl_tpu_torch.replay.transition import Transition

torch.set_num_threads(1)

OBS, ACTIONS, DIM, HIDDEN = 5, 3, 2, 16
B, T = 6, 5
LENGTHS = np.array([5, 5, 3, 4, 1, 5], np.int32)
N_SDN = 5


# ---------------------------------------------------- the recipes' JAX nets
class JaxPiQ(nn.Module):
    """``run_acer_abc``'s ``PiQ``."""

    n_actions: int = ACTIONS
    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Dense(self.hidden)(x))
        return JaxCategorical(logits=nn.Dense(self.n_actions)(h)), JaxDiscreteAV(q_values=nn.Dense(self.n_actions)(h))


class JaxPi(nn.Module):
    """``run_acer_continuous_abc``'s ``Pi``."""

    action_size: int = DIM
    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Dense(self.hidden)(x))
        return JaxGaussianHead(action_size=self.action_size)(nn.Dense(self.action_size)(h))


class JaxV(nn.Module):
    """``run_acer_continuous_abc``'s ``V``."""

    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x):
        return nn.Dense(1)(nn.relu(nn.Dense(self.hidden)(x)))


def jax_sdn(hidden=HIDDEN, action_size=DIM):
    return JaxSDN(pi=JaxPi(action_size=action_size, hidden=hidden), vf=JaxV(hidden=hidden),
                  adv=jq.FCSAQFunction(n_hidden_channels=hidden, n_hidden_layers=1))


def port_sdn(obs=OBS - 1, hidden=HIDDEN, action_size=DIM):
    return ACERSDNModel(pi=GaussianPi(obs, action_size, hidden), vf=DenseV(obs, hidden),
                        adv=FCSAQFunction(obs, action_size, n_hidden_channels=hidden, n_hidden_layers=1))


# ------------------------------------------------------------ draw bridge
def install_acer_tape(monkeypatch, tape: Tape):
    """``install_recurrent_tape``, and a real key split into ``n`` keys
    gives index keys ``[0, i]``: a normal drawn inside a ``vmap`` over them
    pops one logged normal of ``[n, *shape]`` and hands row ``i`` to the
    i-th key (the continuous ACER's SDN samples); a normal from a real key
    outside pops its own."""
    install_recurrent_tape(monkeypatch, tape)
    last = [0]

    def split(key, num=2):
        if _is_value_key(key):
            return key
        if _is_abstract(key):
            return jnp.zeros((num, 2), jnp.uint32)
        last[0] = num
        return jnp.stack([jnp.zeros(num, jnp.uint32), jnp.arange(num, dtype=jnp.uint32)], axis=1)

    def normal(key, shape=(), dtype=jnp.float32):
        if _is_value_key(key):
            return key.astype(dtype)
        kind, values = tape.log.pop(0)
        assert kind == "normal", kind
        if isinstance(key, jax.core.Tracer):  # vmapped over the keys of one split
            full = (last[0],) + tuple(shape)
            assert values.size == math.prod(full), (values.shape, full)
            return jnp.asarray(values.reshape(full), dtype)[key[1]]
        assert values.size == math.prod(shape), (values.shape, shape)
        return jnp.asarray(values.reshape(shape), dtype)

    monkeypatch.setattr(jax.random, "split", split)
    monkeypatch.setattr(jax.random, "normal", normal)


# -------------------------------------------------------------------- data
def _t(x):
    return torch.from_numpy(np.array(x))


def rows(seed, continuous=False, obs=OBS):
    """A batch of whole rows as the episodic buffer gives it: numpy arrays."""
    rs = np.random.RandomState(seed)
    mask = (np.arange(T)[None] < LENGTHS[:, None]).astype(np.float32)
    term = np.zeros((B, T), bool)
    term[2, 2] = term[4, 0] = True  # rows 2 and 4 end terminated; 0, 1, 3, 5 are cut
    pad = mask[..., None] == 0
    if continuous:
        action = np.clip(rs.standard_normal((B, T, DIM)), -1.5, 1.5).astype(np.float32)
        extras = {"mu_mean": np.where(pad, 0.0, rs.standard_normal((B, T, DIM)) * 0.3).astype(np.float32),
                  "mu_std": np.where(pad, 0.0, np.exp(rs.uniform(-0.5, 0.3, (B, T, DIM)))).astype(np.float32)}
    else:
        logits = rs.standard_normal((B, T, ACTIONS)).astype(np.float32)
        mu = logits - np.log(np.sum(np.exp(logits), -1, keepdims=True))
        action = rs.randint(0, ACTIONS, (B, T)).astype(np.int32)
        extras = {"mu_logits": np.where(pad, 0.0, mu).astype(np.float32)}
    return dict(
        obs=rs.standard_normal((B, T, obs)).astype(np.float32),
        action=action,
        reward=rs.standard_normal((B, T)).astype(np.float32),
        next_obs=rs.standard_normal((B, T, obs)).astype(np.float32),
        terminated=term, done=term | (mask == 0), extras=extras, mask=mask, lengths=LENGTHS,
    )


def port_batch(w):
    tr = Transition(**{k: _t(w[k]) for k in ("obs", "action", "reward", "next_obs", "terminated", "done")},
                    extras={k: _t(v) for k, v in w["extras"].items()})
    zeros = torch.zeros(B, dtype=torch.int32)
    return EpisodeBatch(transitions=tr, mask=_t(w["mask"]), lengths=_t(w["lengths"]), rows=zeros, offsets=zeros)


def jax_batch(w):
    tr = JaxTransition(**{k: jnp.asarray(w[k]) for k in ("obs", "action", "reward", "next_obs", "terminated", "done")},
                       extras=FrozenDict({k: jnp.asarray(v) for k, v in w["extras"].items()}))
    return JaxEpisodeBatch(transitions=tr, mask=jnp.asarray(w["mask"]), lengths=jnp.asarray(w["lengths"]))


# ------------------------------------------------------- cores and states
def acer_pair(continuous, trust_region=True, q_opc=False, delta=0.1, compute_dtype=None):
    jdtype = None if compute_dtype is None else jnp.bfloat16
    kw = dict(gamma=0.9, use_trust_region=trust_region, trust_region_delta=delta, use_Q_opc=q_opc)
    if continuous:
        jcore = JaxACERContinuous(model=jax_sdn(), optimizer=optax.adam(5e-3), beta=1e-3, compute_dtype=jdtype, **kw)
        tcore = ACERContinuousCore(model=port_sdn(), optimizer=Adam(5e-3), beta=1e-3, compute_dtype=compute_dtype,
                                   **kw)
        return jcore, tcore
    jcore = JaxACER(model=JaxPiQ(), optimizer=optax.adam(5e-3), beta=1e-2, compute_dtype=jdtype, **kw)
    tcore = ACERCore(model=DensePiQ(OBS, ACTIONS, HIDDEN), optimizer=Adam(5e-3), beta=1e-2,
                     compute_dtype=compute_dtype, **kw)
    return jcore, tcore


def acer_states(jcore, tcore, continuous, seed=1):
    obs = OBS - 1 if continuous else OBS
    args = (jnp.zeros((2, obs)), jnp.zeros((2, DIM))) if continuous else (jnp.zeros((2, obs)),)
    jstate = jcore.init(jax.random.PRNGKey(seed), *args)
    # An average model apart from the weights, so that the trust region acts.
    jstate = jstate.replace(avg_params=jax.tree.map(lambda p: p * 0.9, jstate.params))
    return jstate, convert.acer_state_from_flax(tcore, np_tree(jstate), device="cpu")


def run_updates(continuous, n, trust_region=True, q_opc=False, delta=0.1, compute_dtype=None, jit=True):
    """Both cores after ``n`` updates on ``n`` batches: (jstate, tstate,
    JAX auxes, port auxes, initial port state, the port's draw log)."""
    jcore, tcore = acer_pair(continuous, trust_region, q_opc, delta, compute_dtype)
    jstate, tstate = acer_states(jcore, tcore, continuous)
    start = copy.deepcopy(tstate)
    batches = [rows(10 + i, continuous, OBS - 1 if continuous else OBS) for i in range(n)]
    tape = Tape(3)
    taux = [tcore.update_episodic(tstate, port_batch(w), tape)[1] for w in batches]
    log = [(k, v.size) for k, v in tape.log]
    jaux = []
    with pytest.MonkeyPatch.context() as mp:
        install_acer_tape(mp, tape)
        update = jax.jit(jcore.update_episodic) if jit and not continuous else jcore.update_episodic
        for w in batches:
            with jax.disable_jit(not jit):
                jstate, aux = update(jstate, jnp.zeros((2,), jnp.uint32), jax_batch(w))
            jaux.append(aux)
    assert not tape.log
    return jstate, tstate, jaux, taux, start, log


# The SDN's advantage output bias cancels in Q(s, a) = V + A(s, a) -
# mean_i A(s, a_i): its gradient is rounding noise, which Adam scales to
# steps of up to about its learning rate (ROADMAP C48).
SDN_FREE_BIAS = "adv.mlp.layers.1.bias"
LR = 5e-3


def assert_sdn_network(module, tree, atol, n, what):
    """Every parameter within ``atol`` but the advantage's output bias, which
    is held within the ``2 n lr`` two Adam trajectories can part by."""
    got = dict(module.named_parameters())
    for name, want in convert.torch_arrays(module, np_tree(tree)).items():
        tol = 2 * n * LR if name == SDN_FREE_BIAS else atol
        np.testing.assert_allclose(got[name].detach().numpy(), want, atol=tol, rtol=0, err_msg=f"{what} {name}")


def assert_adam_except(opt_state, module, jax_opt_state, skip):
    """``assert_adam`` over every parameter but ``skip``."""
    adam = jax_opt_state[0]
    assert opt_state.count == int(adam.count)
    names = [n for n, _ in module.named_parameters()]
    for moments, tree in ((opt_state.mu, adam.mu), (opt_state.nu, adam.nu)):
        want = convert.torch_arrays(module, np_tree(tree))
        for name, m in zip(names, moments):
            if name != skip:
                atol = 1e-4 * float(np.abs(want[name]).max()) + 1e-12
                np.testing.assert_allclose(m.numpy(), want[name], rtol=1e-4, atol=atol, err_msg=name)


def assert_close(got, want, rtol, floor, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=floor,
                               err_msg=what)


# ------------------------------------------------------------------ tests
CASES = [  # trust region, Q_opc, delta
    pytest.param(True, False, 0.1, id="trust-region"),
    pytest.param(True, True, 1e-3, id="trust-region-acting-opc"),
    pytest.param(False, False, 0.1, id="plain"),
    pytest.param(False, True, 0.1, id="plain-opc"),
]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("trust_region,q_opc,delta", CASES)
@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_acer_update_matches_jax_from_converted_state(continuous, trust_region, q_opc, delta, n):
    jstate, tstate, jaux, taux, _, _ = run_updates(continuous, n, trust_region, q_opc, delta)
    for i, (ja, ta) in enumerate(zip(jaux, taux)):
        assert set(ta) == set(ja)
        for key in ("loss", "pi_loss", "q_loss", "kl", "entropy"):
            assert_close(ta[key].numpy(), ja[key], 1e-5, 1e-6, f"update {i} {key}")
        np.testing.assert_array_equal(ta["errors"].numpy(), np.zeros(1))
        assert (float(ta["kl"]) != 0.0) == trust_region
    atol = 1e-6 if n == 1 else 3e-6
    for module, tree, what in ((tstate.model, jstate.params, "params"), (tstate.avg_model, jstate.avg_params, "avg")):
        assert_sdn_network(module, tree, atol, n, what) if continuous else assert_network(module, tree, atol, what)
    assert_adam_except(tstate.opt_state, tstate.model, jstate.opt_state, SDN_FREE_BIAS if continuous else None)
    assert tstate.n_updates == int(jstate.n_updates) == n
    assert not any(p.requires_grad for p in tstate.avg_model.parameters())


def test_trust_region_gradient_in_free_log_probs_matches_jax_grad():
    """``policy_loss_grad`` is the gradient of the JAX core's ``g_of_logits``
    with respect to the log-probs as free variables."""
    rs = np.random.RandomState(5)
    lg = rs.standard_normal((B, T, ACTIONS)).astype(np.float32)
    actions = rs.randint(0, ACTIONS, (B, T)).astype(np.int32)
    trunc_rho, adv = rs.uniform(0, 10, (B, T)).astype(np.float32), rs.standard_normal((B, T)).astype(np.float32)
    corr_w = rs.uniform(0, 1, (B, T, ACTIONS)).astype(np.float32)
    corr_adv = rs.standard_normal((B, T, ACTIONS)).astype(np.float32)
    mask = (np.arange(T)[None] < LENGTHS[:, None]).astype(np.float32)

    def g_of_logits(lg):  # pfrl_tpu/agents/acer.py:241-245
        lp_a = jnp.take_along_axis(lg, actions[..., None], axis=-1)[..., 0]
        gl = -trunc_rho * lp_a * adv
        gl = gl + jnp.sum(corr_w * lg * corr_adv, axis=-1) * (-1.0)
        return jnp.sum(gl * mask)

    want = np.asarray(jax.grad(g_of_logits)(jnp.asarray(lg)))
    got = policy_loss_grad(_t(actions), _t(trunc_rho), _t(adv), _t(corr_w), _t(corr_adv), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 1.0


def test_continuous_update_draws_the_sdn_samples_then_the_correction():
    """One normal of ``[n_sdn, B, T, d]``, then one of ``[B, T, d]``; the
    JAX update on those values in that order agrees (the test above), and
    on them swapped does not."""
    _, _, jaux, taux, _, log = run_updates(True, 1)
    assert log == [("normal", N_SDN * B * T * DIM), ("normal", B * T * DIM)]
    jcore, tcore = acer_pair(True)
    jstate, tstate = acer_states(jcore, tcore, True)
    w = rows(10, True, OBS - 1)
    tape = Tape(3)
    tcore.update_episodic(tstate, port_batch(w), tape)
    sdn, corr = tape.log
    tape.log = [("normal", np.concatenate([corr[1], sdn[1][corr[1].size:]])),
                ("normal", sdn[1][:corr[1].size])]
    with pytest.MonkeyPatch.context() as mp:
        install_acer_tape(mp, tape)
        _, swapped = jcore.update_episodic(jstate, jnp.zeros((2,), jnp.uint32), jax_batch(w))
    assert abs(float(swapped["loss"]) - float(taux[0]["loss"])) > 1e-4


def test_padded_steps_are_patched_to_a_standard_normal():
    """Zero behaviour statistics on the padded steps would give NaN log-probs,
    and NaN * 0 would poison the loss; the patch keeps it finite."""
    jcore, tcore = acer_pair(True)
    _, tstate = acer_states(jcore, tcore, True)
    w = rows(12, True, OBS - 1)
    assert (w["extras"]["mu_std"][w["mask"] == 0] == 0).all()
    _, aux = tcore.update_episodic(tstate, port_batch(w), Tape(0))
    assert all(math.isfinite(float(v)) for v in aux.values())
    assert all(torch.isfinite(p).all() for p in tstate.model.parameters())


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_acts_with_the_behaviour_distribution_as_jax(monkeypatch, continuous):
    jcore, tcore = acer_pair(continuous)
    jstate, tstate = acer_states(jcore, tcore, continuous)
    obs = np.random.RandomState(4).standard_normal((7, OBS - 1 if continuous else OBS)).astype(np.float32)
    tape = Tape(2)
    action, extras = tcore.select_action_with_extras(tstate, tape, _t(obs), 0, True)
    greedy = tcore.select_action(tstate, tape, _t(obs), 0, False)
    install_acer_tape(monkeypatch, tape)
    jaction, jextras = jcore.select_action_with_extras(jstate, jnp.zeros((2,), jnp.uint32), jnp.asarray(obs), 0, True)
    jgreedy = jcore.select_action(jstate, jnp.zeros((2,), jnp.uint32), jnp.asarray(obs), 0, False)
    assert not tape.log
    assert set(extras) == set(jextras) == ({"mu_mean", "mu_std"} if continuous else {"mu_logits"})
    for k in extras:
        np.testing.assert_allclose(extras[k].numpy(), np.asarray(jextras[k]), rtol=0, atol=1e-6, err_msg=k)
    if continuous:
        np.testing.assert_allclose(action.numpy(), np.asarray(jaction), rtol=0, atol=1e-6)
        np.testing.assert_allclose(greedy.numpy(), np.asarray(jgreedy), rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
        np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_bf16_acer_update_matches_jax_eager(continuous, n):
    jstate, tstate, jaux, taux, start, _ = run_updates(continuous, n, delta=1e-3, compute_dtype=torch.bfloat16,
                                                       jit=False)
    assert_close(taux[0]["loss"].numpy(), jaux[0]["loss"], 1e-3, 1e-6, "first loss")
    assert all(v.dtype == torch.float32 for v in taux[0].values())
    moved = 0
    for module, start_module, tree in ((tstate.model, start.model, jstate.params),
                                       (tstate.avg_model, start.avg_model, jstate.avg_params)):
        want = convert.torch_arrays(module, np_tree(tree))
        before = dict(start_module.named_parameters())
        for name, p in module.named_parameters():
            assert p.dtype == torch.float32, name  # the masters stay float32
            change = p.detach().numpy() - before[name].detach().numpy()
            jchange = want[name] - before[name].detach().numpy()
            size = float(np.linalg.norm(jchange))
            if continuous and name == SDN_FREE_BIAS:
                assert float(np.abs(change - jchange).max()) <= 2 * n * LR, name
                continue
            assert float(np.linalg.norm(change - jchange)) <= 0.03 * size, name
            moved += size > 0
    assert moved > 0
    assert all(m.dtype == torch.float32 for m in tstate.opt_state.mu + tstate.opt_state.nu)


def test_bf16_acer_runs_its_layers_in_bf16():
    """The network sees bf16 weights and inputs; its outputs, the behaviour
    statistics and the masters come back float32."""
    for continuous in (False, True):
        _, tcore = acer_pair(continuous, compute_dtype=torch.bfloat16)
        state = tcore.init(torch.Generator().manual_seed(0), torch.zeros(4, OBS - 1 if continuous else OBS),
                           torch.zeros(4, DIM))
        layer = next(m for m in state.model.modules() if isinstance(m, torch.nn.Linear))
        seen = []
        hook = layer.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
        _, extras = tcore.select_action_with_extras(state, Tape(0), torch.ones(4, OBS - 1 if continuous else OBS),
                                                    0, True)
        hook.remove()
        assert seen == [torch.bfloat16]
        assert all(v.dtype == torch.float32 for v in extras.values())
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
