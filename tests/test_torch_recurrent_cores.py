"""The four recurrent cores of the port against the JAX package's, from
converted states, 1 and 3 updates each on the same numpy data and draws:
``RecurrentDQNCore`` (``burn_in`` 0 and 2, ``"sum"`` and ``"mean"``
accumulation, and at bf16), ``RecurrentIQNCore``, ``RecurrentPPOCore`` and
``RecurrentTRPOCore``; also their act paths. The networks are the
``tools/record_curves.py`` recipes' compact LSTM nets at width 16.

Data: windows ``[B=6, T=5]`` with masked tails and stored carries, as the
episodic buffer returns them; rollouts ``[T=8, B=3]`` with episode ends and
stored carries, as the on-policy runner collects them. DRQN draws nothing;
IQN draws from ``Tape`` (``install_recurrent_tape``) and its JAX update
runs under ``jax.disable_jit`` so that the draws of the scan's steps pop
in order (one tau draw per unrolled step, ROADMAP C25); the on-policy
updates' permutations are handed to the jitted JAX update by value
(``ValueKeys``).

Tolerances (float32): losses, errors and metrics 1e-5 relative (floor
1e-6); parameters and Adam moments within 1e-6 after one update and 3e-6
after three (sequential Adam steps amplify rounding, ROADMAP C22); TRPO's
policy within 8e-6 after one and three updates, or four times what scaling
its weights by 1 + 2**-23 moves the port's own step where that is more
(measured on the machine that runs the test: 1.5e-6 on one CPU, 2.4e-6 on
an AMD EPYC with avx512_bf16; float32 CG amplifies the rounding of the
Fisher-vector products, ROADMAP C21;
:func:`test_trpo_tolerance_is_what_an_ulp_nudge_moves`; measured against
JAX: 4.2e-7 to 5.6e-7) and its value function 2e-6. bf16 (JAX eager, ROADMAP C34): the first loss
within 1e-3 relative; each parameter tensor's change after one and three
updates within 3% (L2, relative), as ``test_torch_bf16_cores.py`` holds the
feed-forward cores (ROADMAP C37).
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
from test_torch_continuous_envs import ValueKeys
from test_torch_recurrent_modules import install_recurrent_tape
from test_torch_sac import assert_adam, assert_network
from test_torch_value_modules import Tape

from pfrl_tpu.action_value import DiscreteActionValue as JaxDiscreteAV
from pfrl_tpu.agents import RecurrentDQNCore as JaxRDQN
from pfrl_tpu.agents import RecurrentIQNCore as JaxRIQN
from pfrl_tpu.agents import RecurrentPPOCore as JaxRPPO
from pfrl_tpu.agents import RecurrentTRPOCore as JaxRTRPO
from pfrl_tpu.agents.ppo import Rollout as JaxRollout
from pfrl_tpu.explorers import ConstantEpsilonGreedy as JaxConstantEps
from pfrl_tpu.models.recurrent import LSTMCellModule as JaxLSTM
from pfrl_tpu.models.recurrent import RecurrentSequential as JaxRecurrentSequential
from pfrl_tpu.policies import SoftmaxCategoricalHead as JaxSoftmaxHead
from pfrl_tpu.q_functions import RecurrentImplicitQuantileQFunction as JaxRIQF
from pfrl_tpu.replay.episodic import EpisodeBatch as JaxEpisodeBatch
from pfrl_tpu.replay.transition import Transition as JaxTransition
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.action_value import DiscreteActionValue
from pfrl_tpu_torch.agents.ppo import Rollout
from pfrl_tpu_torch.agents.recurrent_dqn import RecurrentDQNCore
from pfrl_tpu_torch.agents.recurrent_iqn import RecurrentIQNCore
from pfrl_tpu_torch.agents.recurrent_ppo import RecurrentPPOCore
from pfrl_tpu_torch.agents.recurrent_trpo import RecurrentTRPOCore
from pfrl_tpu_torch.experiments.onpolicy import Dense
from pfrl_tpu_torch.experiments.recurrent import LSTMNet
from pfrl_tpu_torch.explorers import ConstantEpsilonGreedy
from pfrl_tpu_torch.models.recurrent import LSTMCellModule, RecurrentSequential
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import RecurrentImplicitQuantileQFunction
from pfrl_tpu_torch.replay.episodic import EpisodeBatch
from pfrl_tpu_torch.replay.transition import Transition
from pfrl_tpu_torch.utils import recurrent as tutils

torch.set_num_threads(1)

OBS, ACTIONS, HIDDEN = 13, 2, 16
B, T = 6, 5


# ---------------------------------------------------- the recipes' JAX nets
def _zeros_carry(batch, hidden):
    z = jnp.zeros((batch, hidden), jnp.float32)
    return ((z, z),)


class JaxRQ(nn.Module):
    """``run_drqn_*``'s ``RQ``: Dense, relu, LSTM, Dense."""

    n_actions: int = ACTIONS
    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x, carry):
        h = nn.relu(nn.Dense(self.hidden)(x))
        h, new_carry = JaxLSTM(self.hidden)(h, carry[0])
        return JaxDiscreteAV(q_values=nn.Dense(self.n_actions)(h)), (new_carry,)

    def initial_carry(self, batch_size):
        return _zeros_carry(batch_size, self.hidden)


class JaxRPsi(nn.Module):
    """``run_riqn_delayed_cue``'s ``Psi``."""

    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x, carry):
        h = nn.relu(nn.Dense(self.hidden)(x))
        h, new_carry = JaxLSTM(self.hidden)(h, carry[0])
        return h, (new_carry,)

    def initial_carry(self, batch_size):
        return _zeros_carry(batch_size, self.hidden)


class JaxRPiV(nn.Module):
    """``run_rppo_delayed_cue``'s ``RPiV``."""

    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x, carry):
        h = nn.relu(nn.Dense(self.hidden)(x))
        h, new_carry = JaxLSTM(self.hidden)(h, carry[0])
        return (JaxSoftmaxHead()(nn.Dense(2)(h)), nn.Dense(1)(h)), (new_carry,)

    def initial_carry(self, batch_size):
        return _zeros_carry(batch_size, self.hidden)


class JaxRPolicy(nn.Module):
    """``run_rtrpo_delayed_cue``'s ``RPolicy``."""

    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x, carry):
        h = nn.relu(nn.Dense(self.hidden)(x))
        h, new_carry = JaxLSTM(self.hidden)(h, carry[0])
        return JaxSoftmaxHead()(nn.Dense(2)(h)), (new_carry,)

    def initial_carry(self, batch_size):
        return _zeros_carry(batch_size, self.hidden)


class JaxRVF(nn.Module):
    """``run_rtrpo_delayed_cue``'s ``RVF``."""

    hidden: int = HIDDEN

    @nn.compact
    def __call__(self, x, carry):
        h = nn.relu(nn.Dense(self.hidden)(x))
        h, new_carry = JaxLSTM(self.hidden)(h, carry[0])
        return nn.Dense(1)(h), (new_carry,)

    def initial_carry(self, batch_size):
        return _zeros_carry(batch_size, self.hidden)


class PermutingTape(Tape):
    def permutation(self, n):
        return self._record("permutation", self.rs.permutation(n)).to(torch.int64)


def _t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(got, want, rtol, floor, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=floor,
                               err_msg=what)


def jax_q_values(x):
    return JaxDiscreteAV(q_values=x)


def q_values(x):
    return DiscreteActionValue(q_values=x)


class JaxSequentialQ(JaxRecurrentSequential):
    """``JaxRQ`` as a generic ``RecurrentSequential``; the same carry."""

    layers: tuple = (nn.Dense(HIDDEN), nn.relu, JaxLSTM(HIDDEN), nn.Dense(ACTIONS), jax_q_values)


def sequential_q():
    return RecurrentSequential(Dense(OBS, HIDDEN), torch.relu, LSTMCellModule(HIDDEN, HIDDEN), Dense(HIDDEN, ACTIONS),
                               q_values)


# ------------------------------------------------------- cores and states
def dqn_pair(kind, burn_in=0, accumulator="mean", compute_dtype=None):
    """(JAX core, port core) of ``kind`` ``"drqn"``, ``"drqn-sequential"``
    (the same net as a ``RecurrentSequential``) or ``"riqn"``."""
    jdtype = None if compute_dtype is None else jnp.bfloat16
    if kind.startswith("drqn"):
        sequential = kind == "drqn-sequential"
        jcore = JaxRDQN(model=JaxSequentialQ() if sequential else JaxRQ(), optimizer=optax.adam(5e-3),
                        explorer=JaxConstantEps(0.2, ACTIONS), gamma=0.95, burn_in=burn_in,
                        batch_accumulator=accumulator, compute_dtype=jdtype)
        tmodel = sequential_q() if sequential else LSTMNet(OBS, HIDDEN, (ACTIONS,), "q")
        tcore = RecurrentDQNCore(model=tmodel, optimizer=Adam(5e-3),
                                 explorer=ConstantEpsilonGreedy(0.2, ACTIONS), gamma=0.95, burn_in=burn_in,
                                 batch_accumulator=accumulator, compute_dtype=compute_dtype)
        return jcore, tcore
    taus = dict(quantile_thresholds_N=4, quantile_thresholds_N_prime=5, quantile_thresholds_K=3)
    jcore = JaxRIQN(model=JaxRIQF(psi=JaxRPsi(), n_actions=ACTIONS, n_basis_functions=32), optimizer=optax.adam(3e-3),
                    explorer=JaxConstantEps(0.2, ACTIONS), gamma=0.95, batch_accumulator=accumulator, **taus)
    model = RecurrentImplicitQuantileQFunction(LSTMNet(OBS, HIDDEN), HIDDEN, ACTIONS, n_basis_functions=32)
    tcore = RecurrentIQNCore(model=model, optimizer=Adam(3e-3), explorer=ConstantEpsilonGreedy(0.2, ACTIONS),
                             gamma=0.95, batch_accumulator=accumulator, **taus)
    return jcore, tcore


def dqn_states(jcore, tcore, seed=1):
    jstate = jcore.init(jax.random.PRNGKey(seed), jnp.zeros((2, OBS)))
    # A different target, so that the target's unroll is checked.
    target = jax.tree.map(lambda p: p * 0.9, jstate.params)
    jstate = jstate.replace(target_params=target)
    tstate = convert.dqn_state_from_flax(tcore, np_tree(jstate.params), np_tree(target), np_tree(jstate.opt_state),
                                         device="cpu")
    return jstate, tstate


def windows(seed):
    """A batch of windows as the episodic buffer gives it: numpy arrays."""
    rs = np.random.RandomState(seed)
    lengths = np.array([5, 5, 3, 4, 1, 5], np.int32)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    term = np.zeros((B, T), bool)
    term[2, 2] = term[4, 0] = True
    carry = lambda: ((rs.standard_normal((B, T, HIDDEN)).astype(np.float32) * 0.5,  # noqa: E731
                      np.tanh(rs.standard_normal((B, T, HIDDEN))).astype(np.float32)),)
    return dict(
        obs=rs.standard_normal((B, T, OBS)).astype(np.float32),
        action=rs.randint(0, ACTIONS, (B, T)).astype(np.int32),
        reward=rs.standard_normal((B, T)).astype(np.float32),
        next_obs=rs.standard_normal((B, T, OBS)).astype(np.float32),
        terminated=term, done=term, carry=carry(), next_carry=carry(), mask=mask, lengths=lengths,
    )


def port_batch(w):
    tr = Transition(**{k: _t(w[k]) for k in ("obs", "action", "reward", "next_obs", "terminated", "done")},
                    extras={"carry": jax.tree.map(_t, w["carry"]), "next_carry": jax.tree.map(_t, w["next_carry"])})
    zeros = torch.zeros(B, dtype=torch.int32)
    return EpisodeBatch(transitions=tr, mask=_t(w["mask"]), lengths=_t(w["lengths"]), rows=zeros, offsets=zeros)


def jax_batch(w):
    tr = JaxTransition(**{k: jnp.asarray(w[k]) for k in ("obs", "action", "reward", "next_obs", "terminated", "done")},
                       extras=FrozenDict({"carry": jax.tree.map(jnp.asarray, w["carry"]),
                                          "next_carry": jax.tree.map(jnp.asarray, w["next_carry"])}))
    return JaxEpisodeBatch(transitions=tr, mask=jnp.asarray(w["mask"]), lengths=jnp.asarray(w["lengths"]))


def run_dqn_updates(kind, n, burn_in=0, accumulator="mean", compute_dtype=None, jit=True):
    """Both cores after ``n`` updates on ``n`` batches: (jstate, tstate,
    JAX auxes, port auxes, initial port state)."""
    jcore, tcore = dqn_pair(kind, burn_in, accumulator, compute_dtype)
    jstate, tstate = dqn_states(jcore, tcore)
    start = copy.deepcopy(tstate)
    batches = [windows(10 + i) for i in range(n)]
    tape = Tape(3)
    taux = [tcore.update_episodic(tstate, port_batch(w), tape)[1] for w in batches]
    jaux = []
    with pytest.MonkeyPatch.context() as mp:
        install_recurrent_tape(mp, tape)
        update = jcore.update_episodic if not jit else jax.jit(jcore.update_episodic)
        for w in batches:
            with jax.disable_jit(not jit):
                jstate, aux = update(jstate, jnp.zeros((2,), jnp.uint32), jax_batch(w))
            jaux.append(aux)
    assert not tape.log
    return jstate, tstate, jaux, taux, start


# ------------------------------------------------------------------- DRQN
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("burn_in,accumulator", [(0, "mean"), (0, "sum"), (2, "mean"), (2, "sum")])
def test_drqn_update_matches_jax_from_converted_state(n, burn_in, accumulator):
    jstate, tstate, jaux, taux, _ = run_dqn_updates("drqn", n, burn_in, accumulator)
    for i, (ja, ta) in enumerate(zip(jaux, taux)):
        for key in ("loss", "average_q", "errors"):
            assert_close(ta[key].numpy(), ja[key], 1e-5, 1e-6, f"update {i} {key}")
        assert ta["errors"].shape == (B,)
    atol = 1e-6 if n == 1 else 3e-6
    assert_network(tstate.model, jstate.params, atol, "params")
    assert_network(tstate.target_model, jstate.target_params, 0.0, "target")
    assert_adam(tstate.opt_state, tstate.model, jstate.opt_state, "adam")
    assert tstate.n_updates == int(jstate.n_updates) == n


@pytest.mark.parametrize("n", [1, 3])
def test_drqn_over_a_recurrent_sequential_matches_jax(n):
    """A generic ``RecurrentSequential`` goes through the same one-call
    window unroll as the recipes' nets."""
    jstate, tstate, jaux, taux, _ = run_dqn_updates("drqn-sequential", n, burn_in=2)
    for i, (ja, ta) in enumerate(zip(jaux, taux)):
        for key in ("loss", "average_q", "errors"):
            assert_close(ta[key].numpy(), ja[key], 1e-5, 1e-6, f"update {i} {key}")
    assert_network(tstate.model, jstate.params, 1e-6 if n == 1 else 3e-6, "params")
    assert_network(tstate.target_model, jstate.target_params, 0.0, "target")
    assert tstate.n_updates == int(jstate.n_updates) == n


def test_drqn_burn_in_trains_only_the_tail():
    """With burn-in K the first K steps carry no loss: changing their
    rewards and actions changes nothing."""
    jcore, tcore = dqn_pair("drqn", burn_in=2)
    _, tstate = dqn_states(jcore, tcore)
    w = windows(20)
    w2 = dict(w, reward=w["reward"].copy(), action=w["action"].copy())
    w2["reward"][:, :2] += 5.0
    w2["action"][:, :2] = 1 - w2["action"][:, :2]
    a = tcore.update_episodic(copy.deepcopy(tstate), port_batch(w))[1]
    b = tcore.update_episodic(copy.deepcopy(tstate), port_batch(w2))[1]
    assert float(a["loss"]) == float(b["loss"])


@pytest.mark.parametrize("n", [1, 3])
def test_drqn_at_bf16_matches_eager_jax(n):
    jstate, tstate, jaux, taux, start = run_dqn_updates("drqn", n, compute_dtype=torch.bfloat16, jit=False)
    assert_close(taux[0]["loss"].numpy(), jaux[0]["loss"], 1e-3, 1e-6, "first loss")
    for ta in taux:
        assert ta["loss"].dtype == ta["errors"].dtype == torch.float32
    got = dict(tstate.model.named_parameters())
    before = dict(start.model.named_parameters())
    for name, want in convert.torch_arrays(tstate.model, np_tree(jstate.params)).items():
        assert got[name].dtype == torch.float32
        want_change = want - before[name].detach().numpy()
        got_change = got[name].detach().numpy() - before[name].detach().numpy()
        rel = np.linalg.norm(got_change - want_change) / np.linalg.norm(want_change)
        assert rel < 0.03, (name, rel)


def test_drqn_at_bf16_runs_the_input_side_in_bf16_and_the_hidden_side_in_float32():
    _, tcore = dqn_pair("drqn", compute_dtype=torch.bfloat16)
    tstate = tcore.init(torch.Generator().manual_seed(0), torch.zeros(2, OBS))
    seen = {}
    lstm = tstate.model.lstm
    hooks = [m.register_forward_hook(lambda mod, i, o, name=name: seen.update({name: (i[0].dtype, o.dtype)}) and None)
             for name, m in (("ih", lstm.ih), ("hh", lstm.hh), ("dense", tstate.model.dense))]
    tcore.update_episodic(tstate, port_batch(windows(30)))
    for h in hooks:
        h.remove()
    bf16, f32 = torch.bfloat16, torch.float32
    assert seen == {"dense": (bf16, bf16), "ih": (bf16, bf16), "hh": (f32, f32)}
    carry = tcore.init_act_state(4, "cpu")
    _, new_carry = tcore.select_action_recurrent(tstate, Tape(0), torch.randn(4, OBS), 0, False, carry)
    assert all(c.dtype == f32 for c in tutils.tree_leaves(new_carry))


# ------------------------------------------------------------------- RIQN
@pytest.mark.parametrize("n", [1, 3])
def test_riqn_update_matches_jax_with_one_tau_draw_per_step(n):
    jstate, tstate, jaux, taux, _ = run_dqn_updates("riqn", n, jit=False)
    for i, (ja, ta) in enumerate(zip(jaux, taux)):
        for key in ("loss", "average_q", "errors"):
            assert_close(ta[key].numpy(), ja[key], 1e-5, 1e-6, f"update {i} {key}")
    atol = 1e-6 if n == 1 else 3e-6
    assert_network(tstate.model, jstate.params, atol, "params")
    assert_adam(tstate.opt_state, tstate.model, jstate.opt_state, "adam")


def test_riqn_draws_n_then_n_prime_taus_per_unrolled_step():
    _, tcore = dqn_pair("riqn")
    tstate = tcore.init(torch.Generator().manual_seed(0), torch.zeros(2, OBS))
    tape = Tape(0)
    tcore.update_episodic(tstate, port_batch(windows(40)), tape)
    assert [(k, v.size) for k, v in tape.log] == [("uniform", B * 4)] * T + [("uniform", B * 5)] * T


@pytest.mark.parametrize("kind", ["drqn", "riqn"])
def test_recurrent_act_matches_jax(monkeypatch, kind):
    """Acting over a few steps from a carry: greedy (evaluation) and
    explored actions, and the carry, against the JAX core."""
    jcore, tcore = dqn_pair(kind)
    jstate, tstate = dqn_states(jcore, tcore)
    rs = np.random.RandomState(4)
    jcarry, tcarry = jcore.init_act_state(5), tcore.init_act_state(5, "cpu")
    tape = Tape(5)
    install_recurrent_tape(monkeypatch, tape)
    for step in range(4):
        obs = rs.standard_normal((5, OBS)).astype(np.float32)
        training = step % 2 == 0
        ta, tcarry = tcore.select_action_recurrent(tstate, tape, _t(obs), step, training, tcarry)
        with jax.disable_jit():
            ja, jcarry = jcore.select_action_recurrent(jstate, jnp.zeros((2,), jnp.uint32), jnp.asarray(obs),
                                                       jnp.int32(step), training, jcarry)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        for g, w in zip(tutils.tree_leaves(tcarry), jax.tree.leaves(jcarry)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert not tape.log
    done = torch.tensor([True, False, False, True, False])
    reset = tcore.reset_act_state(tcarry, done)
    assert all(float(x[done].abs().max()) == 0 and torch.equal(x[~done], y[~done])
               for x, y in zip(tutils.tree_leaves(reset), tutils.tree_leaves(tcarry)))


# ---------------------------------------------------------------- on-policy
R_T, R_B, CHUNK = 8, 3, 4
TRPO_POLICY_ATOL = 8e-6


def rollout_data(seed):
    rs = np.random.RandomState(seed)
    done = rs.uniform(size=(R_T, R_B)) < 0.2
    done[3, 1] = True
    term = done & (rs.uniform(size=(R_T, R_B)) < 0.6)
    carry = lambda: ((rs.standard_normal((R_T, R_B, HIDDEN)).astype(np.float32) * 0.3,  # noqa: E731
                      np.tanh(rs.standard_normal((R_T, R_B, HIDDEN))).astype(np.float32)),)
    return dict(
        obs=rs.standard_normal((R_T, R_B, OBS)).astype(np.float32),
        action=rs.randint(0, 2, (R_T, R_B)).astype(np.int32),
        log_prob=np.log(rs.uniform(0.3, 0.7, (R_T, R_B))).astype(np.float32),
        value=rs.standard_normal((R_T, R_B)).astype(np.float32),
        reward=rs.standard_normal((R_T, R_B)).astype(np.float32),
        terminated=term, done=done,
        next_obs=rs.standard_normal((R_T, R_B, OBS)).astype(np.float32),
        next_value=rs.standard_normal((R_T, R_B)).astype(np.float32),
        carry=carry(),
    )


def port_rollout(d, trpo):
    carry = jax.tree.map(_t, d["carry"])
    fields = {k: _t(v) for k, v in d.items() if k != "carry"}
    fields["action"] = fields["action"].long()
    return Rollout(carry=(carry, jax.tree.map(lambda x: x * 0.5, carry)) if trpo else carry, **fields)


def jax_rollout(d, trpo):
    carry = jax.tree.map(jnp.asarray, d["carry"])
    fields = {k: jnp.asarray(v) for k, v in d.items() if k != "carry"}
    return JaxRollout(carry=(carry, jax.tree.map(lambda x: x * 0.5, carry)) if trpo else carry, **fields)


def onpolicy_pair(kind):
    if kind == "ppo":
        kw = dict(gamma=0.95, epochs=2, minibatch_size=2, entropy_coef=1e-2, chunk_len=CHUNK)
        jcore = JaxRPPO(JaxRPiV(), optax.adam(5e-3), **kw)
        tcore = RecurrentPPOCore(LSTMNet(OBS, HIDDEN, (2, 1), "piv"), Adam(5e-3), **kw)
        jstate = jcore.init(jax.random.PRNGKey(2), jnp.zeros((2, OBS)))
        return jcore, tcore, jstate, convert.ppo_state_from_flax(tcore, np_tree(jstate), device="cpu")
    kw = dict(gamma=0.95, entropy_coef=1e-2, max_kl=0.01, vf_epochs=2, vf_batch_size=2, chunk_len=CHUNK)
    jcore = JaxRTRPO(policy=JaxRPolicy(), vf=JaxRVF(), vf_optimizer=optax.adam(3e-3), **kw)
    tcore = RecurrentTRPOCore(policy=LSTMNet(OBS, HIDDEN, (2,), "pi"), vf=LSTMNet(OBS, HIDDEN, (1,), "v"),
                              vf_optimizer=Adam(3e-3), **kw)
    jstate = jcore.init(jax.random.PRNGKey(2), jnp.zeros((2, OBS)))
    return jcore, tcore, jstate, convert.trpo_state_from_flax(tcore, np_tree(jstate), device="cpu")


def run_onpolicy_updates(kind, n):
    """The JAX update runs jitted: its key is the update's permutations,
    stacked, one per epoch (``ValueKeys``: ``split`` gives the rows and
    ``permutation`` of a row is the row)."""
    jcore, tcore, jstate, tstate = onpolicy_pair(kind)
    trpo = kind == "trpo"
    data = [rollout_data(50 + i) for i in range(n)]
    tape = PermutingTape(6)
    taux = [tcore.update(tstate, tape, port_rollout(d, trpo))[1] for d in data]
    jaux = []
    with pytest.MonkeyPatch.context() as mp:
        ValueKeys(mp)
        mp.setattr(jax.random, "permutation", lambda key, x, axis=0, independent=False: key)
        update = jax.jit(jcore.update)
        for d in data:
            perms = np.stack(tape.take(*["permutation"] * 2)).astype(np.int32)
            jstate, aux = update(jstate, jnp.asarray(perms), jax_rollout(d, trpo))
            jaux.append(aux)
    assert not tape.log
    return jcore, tcore, jstate, tstate, jaux, taux


@pytest.mark.parametrize("n", [1, 3])
def test_rppo_update_matches_jax_through_the_chunked_unroll(n):
    _, _, jstate, tstate, jaux, taux = run_onpolicy_updates("ppo", n)
    for i, (ja, ta) in enumerate(zip(jaux, taux)):
        assert set(ta) == set(ja)
        for key in ta:
            assert_close(ta[key].numpy(), ja[key], 1e-5, 1e-6, f"update {i} {key}")
    atol = 1e-6 if n == 1 else 3e-6
    assert_network(tstate.model, jstate.params, atol, "params")
    assert_adam(tstate.opt_state, tstate.model, jstate.opt_state, "adam")
    assert tstate.n_updates == int(jstate.n_updates) == n * 2 * 3  # 6 chunks, minibatches of 2


@pytest.mark.parametrize("n", [1, 3])
def test_rtrpo_update_matches_jax_through_the_double_backward(n):
    _, _, jstate, tstate, jaux, taux = run_onpolicy_updates("trpo", n)
    for i, (ja, ta) in enumerate(zip(jaux, taux)):
        assert set(ta) == set(ja)
        for key in ta:
            assert_close(ta[key].numpy(), ja[key], 1e-4, 1e-6, f"update {i} {key}")
        assert float(ta["step_accepted"]) == 1.0
    assert_network(tstate.policy, jstate.policy_params, max(TRPO_POLICY_ATOL, 4 * trpo_nudge_move()), "policy")
    assert_network(tstate.vf, jstate.vf_params, 2e-6 * n, "vf")
    assert tstate.n_updates == int(jstate.n_updates) == n


def trpo_nudge_move() -> float:
    """How far scaling the policy's weights by 1 + 2**-23 moves the port's
    own policy after one update. The float32 CG amplifies rounding (ROADMAP
    C21) by an amount that depends on the CPU's kernels: 1.5e-6 on one CPU,
    2.4e-6 on an AMD EPYC with avx512_bf16."""
    _, tcore, _, tstate = onpolicy_pair("trpo")
    nudged = copy.deepcopy(tstate)
    with torch.no_grad():
        for p in nudged.policy.parameters():
            p.mul_(1 + 2**-23)
    d = rollout_data(50)
    a, b = copy.deepcopy(tstate), nudged
    tcore.update(a, PermutingTape(6), port_rollout(d, True))
    tcore.update(b, PermutingTape(6), port_rollout(d, True))
    return max(float((p - q).detach().abs().max()) for p, q in zip(a.policy.parameters(), b.policy.parameters()))


def test_trpo_tolerance_is_what_an_ulp_nudge_moves():
    """A 1 + 2**-23 nudge of the policy moves the port's own step, and the
    port's policy after one update lies within four times that of JAX's
    (C48's rule; the held bound is the larger of this and
    ``TRPO_POLICY_ATOL``)."""
    moved = trpo_nudge_move()
    _, _, jstate, tstate, _, _ = run_onpolicy_updates("trpo", 1)
    want = convert.torch_arrays(tstate.policy, np_tree(jstate.policy_params))
    diff = max(float(np.abs(p.detach().numpy() - want[name]).max()) for name, p in tstate.policy.named_parameters())
    print(f"rtrpo: port vs JAX {diff:.3e}, a nudge moves the port {moved:.3e}")
    assert 1e-8 < moved and diff <= 4 * moved, (diff, moved)


@pytest.mark.parametrize("kind", ["ppo", "trpo"])
def test_onpolicy_act_and_value_match_jax(monkeypatch, kind):
    jcore, tcore, jstate, tstate = onpolicy_pair(kind)
    rs = np.random.RandomState(7)
    jcarry, tcarry = jcore.init_act_state(4), tcore.init_act_state(4, "cpu")
    tape = Tape(8)
    install_recurrent_tape(monkeypatch, tape)
    from test_torch_categorical import value_categorical

    monkeypatch.setattr(jax.random, "categorical", value_categorical)
    for step in range(3):
        obs = rs.standard_normal((4, OBS)).astype(np.float32)
        ta, taux, tcarry_new = tcore.act_with_aux_recurrent(tstate, tape, _t(obs), True, tcarry)
        (u,) = tape.take("uniform")
        with jax.disable_jit():
            ja, jaux, jcarry_new = jcore.act_with_aux_recurrent(jstate, jnp.asarray(u.reshape(4, 2)), jnp.asarray(obs),
                                                                True, jcarry)
            jv = jcore.value_recurrent(jstate, jnp.asarray(obs), jcarry_new)
        tv = tcore.value_recurrent(tstate, _t(obs), tcarry_new)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        for key in ("log_prob", "value"):
            np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]), atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
        for g, w in zip(tutils.tree_leaves(tcarry_new), jax.tree.leaves(jcarry_new)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        tcarry, jcarry = tcarry_new, jcarry_new
    assert not tape.log
    assert math.isfinite(float(ta.sum()))
