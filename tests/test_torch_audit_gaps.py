"""What ``tests/test_torch_api_parity.py`` found missing from the port, each
held to the JAX package on the CPU on the same numpy inputs from a seed:

- ``activation`` of ``LargeAtariCNN``, ``SmallAtariCNN``, ``DuelingDQN``
  and ``DistributionalDuelingDQN`` (tanh and ELU on converted weights, at
  the tolerances ``test_torch_models.py`` and ``test_torch_rainbow_modules.py``
  hold the ReLU forms to: torsos rtol 1e-5, atol 1e-5; heads rtol 1e-5,
  atol 1e-6); the ReLU default to the bit against the forward it replaced;
- ``utils.recurrent.one_step_forward`` on the LSTM and GRU cells (1e-6, as
  ``test_torch_recurrent_modules.py`` holds the cells);
- ``utils.pytree`` (exact: selects, stacks and zeros);
- the ``ActionValue`` interface and each variant's ``params`` (exact);
- ``ACERSDNModel.pi_v`` and ``advantage`` (1e-6), ``DDPGCore.target_next_q``
  (rtol 1e-5, as ``test_torch_td3_ddpg.py`` holds the losses) and
  ``TRPOCore.forward`` (1e-6) from converted states;
- the episodic buffers' ``configure_lanes`` and ``wants_next_obs``.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import struct
from test_torch_a2c_trpo import trpo_cores, warm_trpo
from test_torch_acer_cores import DIM, OBS as ACER_OBS, JaxSDN, acer_pair, acer_states
from test_torch_rainbow_modules import np_tree
from test_torch_recurrent_modules import _converted
from test_torch_sac import assert_close, both_batches, numpy_batch
from test_torch_td3_ddpg import KEY, _ddpg_cores, _ddpg_warm_state

from pfrl_tpu import action_value as jav
from pfrl_tpu.models.atari_cnn import LargeAtariCNN as JaxLarge
from pfrl_tpu.models.atari_cnn import SmallAtariCNN as JaxSmall
from pfrl_tpu.q_functions.dueling_dqn import DistributionalDuelingDQN as JaxDistDueling
from pfrl_tpu.q_functions.dueling_dqn import DuelingDQN as JaxDueling
from pfrl_tpu.replay import EpisodicReplayBuffer as JaxEpisodic
from pfrl_tpu.replay import PrioritizedEpisodicReplayBuffer as JaxPrioritizedEpisodic
from pfrl_tpu.utils import pytree as jtree
from pfrl_tpu.utils import recurrent as jrecurrent
from pfrl_tpu_torch import action_value as tav
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN, SmallAtariCNN
from pfrl_tpu_torch.q_functions.dueling_dqn import DistributionalDuelingDQN, DuelingDQN
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer
from pfrl_tpu_torch.replay.prioritized_episodic import PrioritizedEpisodicReplayBuffer
from pfrl_tpu_torch.utils import pytree as ttree
from pfrl_tpu_torch.utils import recurrent as trecurrent

torch.set_num_threads(1)

ACTIVATIONS = {"tanh": (jax.nn.tanh, torch.tanh), "elu": (jax.nn.elu, F.elu)}
N_ACTIONS, N_ATOMS = 4, 11


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(seed, b=3):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (b, 84, 84, 4)).astype(np.float32) / np.float32(255.0)


# ------------------------------------------------------------- activation
def _torsos(kind, jact=nn.relu, tact=torch.relu):
    if kind == "large":
        return JaxLarge(activation=jact), LargeAtariCNN(activation=tact)
    return JaxSmall(activation=jact), SmallAtariCNN(activation=tact)


def _heads(kind, jact=nn.relu, tact=torch.relu):
    if kind == "dueling":
        return JaxDueling(N_ACTIONS, activation=jact), DuelingDQN(N_ACTIONS, activation=tact)
    return (JaxDistDueling(N_ACTIONS, N_ATOMS, -10.0, 10.0, activation=jact),
            DistributionalDuelingDQN(N_ACTIONS, N_ATOMS, -10.0, 10.0, activation=tact))


@pytest.mark.parametrize("act", sorted(ACTIVATIONS))
@pytest.mark.parametrize("kind", ["large", "small"])
def test_atari_torsos_apply_their_activation_as_jax(kind, act):
    jmodel, tmodel = _torsos(kind, *ACTIVATIONS[act])
    x = _frames(1)
    params = np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jmodel.apply(params, jnp.asarray(x))
    convert.load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if act == "tanh":  # a negative pre-activation passes, unlike through a ReLU
        assert float(got.min()) < 0.0


@pytest.mark.parametrize("act", sorted(ACTIVATIONS))
@pytest.mark.parametrize("kind", ["dueling", "distributional"])
def test_dueling_heads_pass_their_activation_to_the_torso_as_jax(kind, act):
    jmodel, tmodel = _heads(kind, *ACTIVATIONS[act])
    assert tmodel.torso.activation is ACTIVATIONS[act][1]
    x = _frames(2)
    params = np_tree(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = jmodel.apply(params, jnp.asarray(x))
    convert.load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(_t(x))
    if kind == "dueling":
        np.testing.assert_allclose(got.q_values.numpy(), np.asarray(want.q_values), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.q_dist.numpy(), np.asarray(want.q_dist), rtol=1e-5, atol=1e-6)


def _relu_forward(torso, x):
    """The torsos' forward before ``activation`` existed."""
    x = x.permute(0, 3, 1, 2)
    for conv in torso.convs:
        x = torch.relu(conv(x))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return torch.relu(torso.dense(x))


@pytest.mark.parametrize("kind", ["large", "small", "dueling", "distributional"])
def test_relu_default_is_the_forward_it_replaced_to_the_bit(kind):
    torch.manual_seed(0)
    model = (_torsos if kind in ("large", "small") else _heads)(kind)[1]
    x = _t(_frames(3))
    torso = model if kind in ("large", "small") else model.torso
    assert torso.activation is torch.relu
    with torch.no_grad():
        want = _relu_forward(torso, x)
        got = torso(x)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        if kind in ("dueling", "distributional"):  # the streams read the same features
            a, v = model.advantage(want), model.value(want)
            out = model(x)
            if kind == "dueling":
                want_q = v + (a - a.mean(dim=-1, keepdim=True))
                np.testing.assert_array_equal(out.q_values.numpy(), want_q.numpy())
            else:
                a = a.reshape(-1, N_ACTIONS, N_ATOMS)
                logits = v[:, None, :] + (a - a.mean(dim=1, keepdim=True))
                np.testing.assert_array_equal(out.q_dist.numpy(), torch.softmax(logits, dim=-1).numpy())


# ------------------------------------------------------- one_step_forward
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_one_step_forward_matches_jax(kind):
    jmod, tmod, params, jcarry = _converted(kind)
    rs = np.random.RandomState(4)
    tcarry = tmod.initial_carry(3)
    for step in range(3):
        x = rs.standard_normal((3, 4)).astype(np.float32)
        jy, jcarry = jrecurrent.one_step_forward(jmod.apply, params, jnp.asarray(x), jcarry)
        with torch.no_grad():
            ty, tcarry = trecurrent.one_step_forward(tmod, _t(x), tcarry)
        for g, w in zip([ty] + trecurrent.tree_leaves(tcarry), [jy] + jax.tree.leaves(jcarry)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=f"{kind} step {step}")


# ------------------------------------------------------------------ pytree
@struct.dataclass
class JaxPair:
    a: jax.Array
    b: jax.Array


@dataclasses.dataclass
class TorchPair:
    a: torch.Tensor
    b: torch.Tensor


def _trees(seed):
    """One tree of each package on the same numpy leaves: a dict of a
    tuple, a list, a dataclass and ``None``."""
    rs = np.random.RandomState(seed)
    x, y, z = (rs.standard_normal(s).astype(np.float32) for s in ((4, 3), (4,), (4, 2, 2)))
    w = rs.randint(-5, 5, (4, 5)).astype(np.int32)
    jt = {"p": (jnp.asarray(x), jnp.asarray(y)), "q": [jnp.asarray(z)], "r": JaxPair(jnp.asarray(w), jnp.asarray(y)),
          "s": None}
    tt = {"p": (_t(x), _t(y)), "q": [_t(z)], "r": TorchPair(_t(w), _t(y)), "s": None}
    return jt, tt


def _assert_same_tree(got, want):
    g, w = ttree.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape) and str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("fn", ["tree_where_rows", "tree_where_scalar", "tree_select", "tree_stack",
                                "tree_unstack", "tree_zeros_like_batched", "tree_replace"])
def test_pytree_helpers_match_jax(fn):
    (ja, ta), (jb, tb) = _trees(0), _trees(1)
    if fn == "tree_where_rows":
        mask = np.array([True, False, False, True])
        _assert_same_tree(ttree.tree_where(_t(mask), ta, tb), jtree.tree_where(jnp.asarray(mask), ja, jb))
    elif fn == "tree_where_scalar":
        for c in (True, False):
            _assert_same_tree(ttree.tree_where(torch.tensor(c), ta, tb), jtree.tree_where(jnp.asarray(c), ja, jb))
    elif fn == "tree_select":
        for c in (True, False):
            _assert_same_tree(ttree.tree_select(torch.tensor(c), ta, tb), jtree.tree_select(jnp.asarray(c), ja, jb))
    elif fn == "tree_stack":
        for axis in (0, 1):
            _assert_same_tree(ttree.tree_stack([ta, tb], axis), jtree.tree_stack([ja, jb], axis))
    elif fn == "tree_unstack":
        got, want = ttree.tree_unstack(ta), jtree.tree_unstack(ja)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    elif fn == "tree_zeros_like_batched":
        _assert_same_tree(ttree.tree_zeros_like_batched(ta, 3), jtree.tree_zeros_like_batched(ja, 3))
    else:
        got = ttree.tree_replace(ta["r"], b=ta["p"][1] * 2)
        want = jtree.tree_replace(ja["r"], b=ja["p"][1] * 2)
        _assert_same_tree(got, want)
        assert got is not ta["r"] and torch.equal(ta["r"].b, ta["p"][1])  # a copy, the original kept


# ------------------------------------------------------------ action values
def test_action_values_share_the_interface_and_params_match_jax():
    rs = np.random.RandomState(5)
    q, dist, quant = (rs.standard_normal(s).astype(np.float32) for s in ((3, 4), (3, 4, 5), (3, 6, 4)))
    mu, mat, v = (rs.standard_normal(s).astype(np.float32) for s in ((3, 2), (3, 2, 2), (3,)))
    z = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    pairs = [
        (jav.DiscreteActionValue(jnp.asarray(q)), tav.DiscreteActionValue(_t(q))),
        (jav.DistributionalDiscreteActionValue(jnp.asarray(dist), jnp.asarray(z)),
         tav.DistributionalDiscreteActionValue(_t(dist), _t(z))),
        (jav.QuantileDiscreteActionValue(jnp.asarray(quant)), tav.QuantileDiscreteActionValue(_t(quant))),
        (jav.QuadraticActionValue(jnp.asarray(mu), jnp.asarray(mat), jnp.asarray(v)),
         tav.QuadraticActionValue(_t(mu), _t(mat), _t(v))),
    ]
    for jv, tv in pairs:
        assert isinstance(tv, tav.ActionValue) and isinstance(jv, jav.ActionValue)
        assert len(tv.params) == len(jv.params)
        for g, w in zip(tv.params, jv.params):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert isinstance(tav.SingleActionValue(lambda a: a), tav.ActionValue)
    base = tav.ActionValue()
    for call in (base.greedy_actions, base.max, lambda: base.evaluate_actions(_t(q))):
        with pytest.raises(NotImplementedError):
            call()


# ----------------------------------------------------------- core methods
def test_acer_sdn_model_pi_v_and_advantage_match_jax():
    jcore, tcore = acer_pair(continuous=True)
    jstate, tstate = acer_states(jcore, tcore, continuous=True)
    rs = np.random.RandomState(6)
    obs = rs.standard_normal((5, ACER_OBS - 1)).astype(np.float32)
    act = rs.standard_normal((5, DIM)).astype(np.float32)
    jpi, jv = jcore.model.apply(jstate.params, jnp.asarray(obs), method=JaxSDN.pi_v)
    jadv = jcore.model.apply(jstate.params, jnp.asarray(obs), jnp.asarray(act), method=JaxSDN.advantage)
    with torch.no_grad():
        tpi, tv = tstate.model.pi_v(_t(obs))
        tadv = tstate.model.advantage(_t(obs), _t(act))
        fpi, fv = tstate.model(_t(obs))
        np.testing.assert_array_equal(tstate.model(_t(obs), _t(act)).numpy(), tadv.numpy())
    np.testing.assert_array_equal(fv.numpy(), tv.numpy())
    np.testing.assert_array_equal(fpi.loc.numpy(), tpi.loc.numpy())
    for g, w in ((tpi.loc, jpi.loc), (tpi.scale, jpi.scale), (tv, jv), (tadv, jadv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_ddpg_target_next_q_matches_jax():
    jcore, tcore = _ddpg_cores("hard", None)
    jstate = _ddpg_warm_state(jcore)
    tstate = convert.actor_critic_state_from_flax(tcore, np_tree(jstate), device="cpu")
    jb, tb = both_batches(numpy_batch(13))
    want = jcore.target_next_q(jstate, KEY, jb)
    with torch.no_grad():
        got = tcore.target_next_q(tstate, tb)
    assert got.shape == want.shape
    assert_close(got.numpy(), want, 1e-5, "target_next_q", 1e-6)


def test_trpo_forward_takes_the_state_or_the_policy_as_jax():
    jcore, tcore = trpo_cores()
    jstate, tstate = warm_trpo(jcore, tcore)
    obs = np.random.RandomState(7).standard_normal((6, 5)).astype(np.float32)
    for jarg, targ in ((jstate, tstate), (jstate.policy_params, tstate.policy)):
        want = jcore.forward(jarg, jnp.asarray(obs))
        with torch.no_grad():
            got = tcore.forward(targ, _t(obs))
        np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc), atol=1e-6)
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), atol=1e-6)


# --------------------------------------------------------- episodic buffers
@pytest.mark.parametrize("prioritized", [False, True])
def test_episodic_buffers_configure_lanes_as_jax(prioritized):
    if prioritized:
        kw = dict(uniform_ratio=0.2, alpha=0.7, eps=1e-2, subseq_len=5, store_carries=False)
        jbuf, tbuf = JaxPrioritizedEpisodic(40, 9, 2, **kw), PrioritizedEpisodicReplayBuffer(40, 9, 2, device="cpu", **kw)
        names = ("uniform_ratio", "alpha", "eps", "tree_capacity")
    else:
        kw = dict(subseq_len=5, gamma=0.9, store_carries=False)
        jbuf, tbuf = JaxEpisodic(40, 9, 2, **kw), EpisodicReplayBuffer(40, 9, 2, device="cpu", **kw)
        names = ()
    assert tbuf.wants_next_obs is jbuf.wants_next_obs is True
    jnew, tnew = jbuf.configure_lanes(4), tbuf.configure_lanes(4)
    assert type(tnew) is type(tbuf) and tnew is not tbuf and tnew.device == tbuf.device
    for name in ("max_episodes", "max_episode_len", "num_lanes", "subseq_len", "gamma", "stores_carries") + names:
        assert getattr(tnew, name) == getattr(jnew, name), name
    assert tnew.num_lanes == 4 and tbuf.num_lanes == 2
