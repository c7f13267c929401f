"""``TD3Core`` and ``DDPGCore`` of the port against the JAX package's: from
a converted state with non-zero Adam moments, one and three ``update``
calls on the same numpy batch with the same noise, and ``select_action``.
TD3 at both parities of ``n_updates`` (the actor and the three targets
step only on even ones); DDPG with hard and soft target sync and with
``clip_delta`` on and off.

Method and tolerances as in ``test_torch_sac.py``: the JAX core un-jitted
on given noise; losses 1e-5 relative, parameters and targets 1e-6 absolute
after one update and 3e-6 after three, Adam's moments 1e-4 relative to
each tensor's largest entry, counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_actor_critic_modules import ACT, HIDDEN, OBS, JaxDetPolicy, np_tree
from test_torch_sac import (
    BATCH,
    LR,
    GivenDraws,
    assert_adam,
    assert_close,
    assert_network,
    both_batches,
    give_jax,
    numpy_batch,
)

from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.agents.ddpg import DDPGCore as JaxDDPGCore
from pfrl_tpu.agents.td3 import TD3Core as JaxTD3Core
from pfrl_tpu.agents.td3 import default_target_policy_smoothing_func as jax_smoothing
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import ActorCriticState, DDPGCore, TD3Core, TD3State
from pfrl_tpu_torch.agents.td3 import default_target_policy_smoothing_func
from pfrl_tpu_torch.experiments.mujoco_actor_critic import deterministic_policy, uniform_burnin
from pfrl_tpu_torch.explorers import AdditiveGaussian
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import FCSAQFunction

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


def _jqf():
    return jq.FCSAQFunction(n_hidden_layers=2, n_hidden_channels=HIDDEN)


def _tqf():
    return FCSAQFunction(OBS, ACT, HIDDEN, 2)


def _jburn(rng, n):
    return jax.random.uniform(rng, (n, ACT), minval=-1.0, maxval=1.0)


def _noise(seed, n):
    rs = np.random.RandomState(seed)
    return [(rs.normal(size=(BATCH, ACT)) * 2.0).astype(np.float32) for _ in range(n)]  # some beyond +-0.5 / 0.2


# ------------------------------------------------------------------------ TD3
def _td3_cores(burnin=False):
    common = dict(gamma=0.99, policy_update_delay=2, burnin_steps=100 if burnin else 0)
    jcore = JaxTD3Core(
        policy=JaxDetPolicy(), q_func1=_jqf(), q_func2=_jqf(),
        policy_optimizer=optax.adam(LR), q_func1_optimizer=optax.adam(LR), q_func2_optimizer=optax.adam(LR),
        explorer=jexplorers.AdditiveGaussian(0.1, low=-1.0, high=1.0),
        burnin_action_func=_jburn if burnin else None, **common,
    )
    tcore = TD3Core(
        policy=deterministic_policy(OBS, ACT, HIDDEN), q_func1=_tqf(), q_func2=_tqf(),
        policy_optimizer=Adam(LR), q_func1_optimizer=Adam(LR), q_func2_optimizer=Adam(LR),
        explorer=AdditiveGaussian(0.1, low=-1.0, high=1.0),
        burnin_action_func=uniform_burnin(ACT) if burnin else None, **common,
    )
    return jcore, tcore


def _td3_warm_state(monkeypatch, jcore, n_warm):
    jstate = jcore.init(KEY, jnp.zeros((1, OBS)), jnp.zeros((1, ACT)))
    jb, _ = both_batches(numpy_batch(200))
    give_jax(monkeypatch, *_noise(201, n_warm))
    for _ in range(n_warm):
        jstate, _ = jcore.update(jstate, KEY, jb)
    return jstate


TD3_NETS = (("policy", "policy_params"), ("q_func1", "q1_params"), ("q_func2", "q2_params"),
            ("target_policy", "target_policy_params"), ("target_q_func1", "target_q1_params"),
            ("target_q_func2", "target_q2_params"))


def _assert_td3_states(tstate, jstate, atol, tag):
    assert isinstance(tstate, TD3State)
    assert tstate.n_updates == int(jstate.n_updates), tag
    for attr, field in TD3_NETS:
        assert_network(getattr(tstate, attr), getattr(jstate, field), atol, f"{tag} {attr}")
    for attr, module in (("policy_opt_state", tstate.policy), ("q1_opt_state", tstate.q_func1),
                         ("q2_opt_state", tstate.q_func2)):
        assert_adam(getattr(tstate, attr), module, getattr(jstate, attr), f"{tag} {attr}")


def _snapshot(tstate, attrs):
    return {a: [p.detach().clone() for p in getattr(tstate, a).parameters()] for a in attrs}


@pytest.mark.parametrize("n_warm", [2, 3], ids=["even_n_updates", "odd_n_updates"])
@pytest.mark.parametrize("n_updates,atol", [(1, 1e-6), (3, 3e-6)])
def test_td3_updates_match_jax_at_both_parities(monkeypatch, n_warm, n_updates, atol):
    jcore, tcore = _td3_cores()
    jstate = _td3_warm_state(monkeypatch, jcore, n_warm)
    tstate = convert.td3_state_from_flax(tcore, np_tree(jstate), device="cpu")
    _assert_td3_states(tstate, jstate, 0.0, "converted")
    assert tstate.n_updates == n_warm and tstate.q1_opt_state.count == n_warm
    assert tstate.policy_opt_state.count == (n_warm + 1) // 2  # updates 0 and 2 stepped the actor

    jb, tb = both_batches(numpy_batch(6))
    noise = _noise(7, n_updates)
    give_jax(monkeypatch, *noise)
    draws = GivenDraws(*noise)
    delayed = ("policy", "target_policy", "target_q_func1", "target_q_func2")
    for k in range(n_updates):
        on_cycle = tstate.n_updates % 2 == 0
        before = _snapshot(tstate, delayed)
        moments = [m.clone() for m in tstate.policy_opt_state.mu + tstate.policy_opt_state.nu]
        count = tstate.policy_opt_state.count
        jstate, jaux = jcore.update(jstate, KEY, jb)
        same, taux = tcore.update(tstate, tb, draws)
        assert same is tstate
        assert_close(taux["loss"], jaux["loss"], 1e-5, f"update {k} loss")
        assert_close(taux["errors"], jaux["errors"], 1e-5, f"update {k} errors", 1e-5)
        changed = {
            a: any(not torch.equal(x, y) for x, y in zip(before[a], getattr(tstate, a).parameters())) for a in delayed
        }
        if on_cycle:
            assert_close(taux["actor_loss"], jaux["actor_loss"], 1e-5, f"update {k} actor_loss")
            assert all(changed.values()) and tstate.policy_opt_state.count == count + 1
        else:  # the step is skipped: nothing of the actor or the targets moves
            assert "actor_loss" not in taux
            assert not any(changed.values()) and tstate.policy_opt_state.count == count
            after = tstate.policy_opt_state.mu + tstate.policy_opt_state.nu
            assert all(torch.equal(x, y) for x, y in zip(moments, after))
    assert not draws.queue
    _assert_td3_states(tstate, jstate, atol, f"after {n_updates}")
    assert tstate.policy_opt_state.count == (n_warm + n_updates + 1) // 2
    modules = [getattr(tstate, a) for a, _ in TD3_NETS]
    assert all(p.grad is None for m in modules for p in m.parameters())


def test_td3_smoothing_clips_noise_and_action_exactly_like_jax(monkeypatch):
    (eps,) = _noise(8, 1)
    action = np.random.RandomState(9).uniform(-1, 1, (BATCH, ACT)).astype(np.float32)
    give_jax(monkeypatch, eps)
    want = np.asarray(jax_smoothing(KEY, jnp.asarray(action)))
    got = default_target_policy_smoothing_func(GivenDraws(eps), torch.from_numpy(action)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - action).max() <= 0.5 + 1e-6 and np.abs(got).max() == 1.0
    assert (np.abs(0.2 * eps) > 0.5).any()


@pytest.mark.parametrize("core_kind", ["td3", "ddpg"])
def test_deterministic_select_action_training_evaluating_and_burn_in_match_jax(monkeypatch, core_kind):
    if core_kind == "td3":
        jcore, tcore = _td3_cores(burnin=True)
        jstate = _td3_warm_state(monkeypatch, jcore, 1)
        tstate = convert.td3_state_from_flax(tcore, np_tree(jstate), device="cpu")
    else:
        jcore, tcore = _ddpg_cores("soft", True, burnin=True)
        jstate = _ddpg_warm_state(jcore)
        tstate = convert.actor_critic_state_from_flax(tcore, np_tree(jstate), device="cpu")
    rs = np.random.RandomState(10)
    obs = rs.normal(size=(6, OBS)).astype(np.float32)
    eps = (rs.normal(size=(6, ACT)) * 10.0).astype(np.float32)  # scale 0.1: many cross +-1
    u = rs.uniform(size=(6, ACT)).astype(np.float32)
    tobs, jobs = torch.from_numpy(obs), jnp.asarray(obs)

    want = jcore.select_action(jstate, KEY, jobs, jnp.int32(0), False)
    got = tcore.select_action(tstate, GivenDraws(), tobs, 0, False)  # draws nothing
    assert_close(got, want, 0, "greedy", 1e-6)
    give_jax(monkeypatch, eps, uniforms=[u])
    want = np.asarray(jcore.select_action(jstate, KEY, jobs, jnp.int32(100), True))
    draws = GivenDraws(eps)
    got = tcore.select_action(tstate, draws, tobs, 100, True).numpy()
    assert_close(got, want, 0, "explorer's noise", 1e-6)
    assert not draws.queue and np.abs(got).max() == 1.0  # clipped to the bounds
    np.testing.assert_array_equal(np.abs(got) == 1.0, np.abs(want) == 1.0)
    give_jax(monkeypatch, eps, uniforms=[u])
    want = jcore.select_action(jstate, KEY, jobs, jnp.int32(99), True)
    draws = GivenDraws(eps, u)  # the explorer's noise, then the burn-in actions
    got = tcore.select_action(tstate, draws, tobs, 99, True)
    assert not draws.queue
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------- DDPG
def _ddpg_cores(method, clip_delta, burnin=False):
    common = dict(gamma=0.99, clip_delta=clip_delta, target_update_method=method, soft_update_tau=0.05,
                  burnin_steps=100 if burnin else 0)
    jcore = JaxDDPGCore(
        policy=JaxDetPolicy(), q_func=_jqf(), policy_optimizer=optax.adam(LR), q_optimizer=optax.adam(LR),
        explorer=jexplorers.AdditiveGaussian(0.1, low=-1.0, high=1.0),
        burnin_action_func=_jburn if burnin else None, **common,
    )
    tcore = DDPGCore(
        policy=deterministic_policy(OBS, ACT, HIDDEN), q_func=_tqf(), policy_optimizer=Adam(LR), q_optimizer=Adam(LR),
        explorer=AdditiveGaussian(0.1, low=-1.0, high=1.0),
        burnin_action_func=uniform_burnin(ACT) if burnin else None, **common,
    )
    return jcore, tcore


def _ddpg_warm_state(jcore, n_warm=2):
    jstate = jcore.init(KEY, jnp.zeros((1, OBS)), jnp.zeros((1, ACT)))
    jb, _ = both_batches(numpy_batch(300))
    for _ in range(n_warm):
        jstate, _ = jcore.update(jstate, KEY, jb)
    return jstate


DDPG_NETS = (("policy", "policy_params"), ("q_func", "q_params"),
             ("target_policy", "target_policy_params"), ("target_q_func", "target_q_params"))


def _assert_ddpg_states(tstate, jstate, atol, tag):
    assert isinstance(tstate, ActorCriticState)
    assert tstate.n_updates == int(jstate.n_updates), tag
    for attr, field in DDPG_NETS:
        assert_network(getattr(tstate, attr), getattr(jstate, field), atol, f"{tag} {attr}")
    assert_adam(tstate.policy_opt_state, tstate.policy, jstate.policy_opt_state, f"{tag} policy Adam")
    assert_adam(tstate.q_opt_state, tstate.q_func, jstate.q_opt_state, f"{tag} q Adam")


@pytest.mark.parametrize("method", ["soft", "hard"])
@pytest.mark.parametrize("clip_delta", [True, False])
@pytest.mark.parametrize("n_updates,atol", [(1, 1e-6), (3, 3e-6)])
def test_ddpg_updates_and_sync_match_jax(method, clip_delta, n_updates, atol):
    jcore, tcore = _ddpg_cores(method, clip_delta)
    jstate = _ddpg_warm_state(jcore)
    tstate = convert.actor_critic_state_from_flax(tcore, np_tree(jstate), device="cpu")
    _assert_ddpg_states(tstate, jstate, 0.0, "converted")
    d = numpy_batch(11)
    d["reward"] = d["reward"] * 5.0  # TD errors on both sides of the Huber knee
    jb, tb = both_batches(d)
    target0 = [p.detach().clone() for p in tstate.target_q_func.parameters()]
    for k in range(n_updates):
        jstate, jaux = jcore.update(jstate, KEY, jb)
        same, taux = tcore.update(tstate, tb)
        assert same is tstate and set(taux) == set(jaux)
        for name in ("loss", "actor_loss", "average_q"):
            assert_close(taux[name], jaux[name], 1e-5, f"update {k} {name}")
        assert_close(taux["errors"], jaux["errors"], 1e-5, f"update {k} errors", 1e-5)
    assert float(taux["errors"].max()) > 1.0 > float(taux["errors"].min())
    moved = any(not torch.equal(a, b) for a, b in zip(target0, tstate.target_q_func.parameters()))
    assert moved == (method == "soft")  # a hard target waits for the runner's sync
    _assert_ddpg_states(tstate, jstate, atol, f"after {n_updates}")
    jstate = jcore.sync_target(jstate)
    assert tcore.sync_target(tstate) is tstate
    _assert_ddpg_states(tstate, jstate, atol, "after sync_target")
    if method == "hard":
        assert all(torch.equal(a, b) for a, b in zip(tstate.policy.parameters(), tstate.target_policy.parameters()))
        assert all(torch.equal(a, b) for a, b in zip(tstate.q_func.parameters(), tstate.target_q_func.parameters()))
    assert tstate.n_updates == 2 + n_updates == tstate.q_opt_state.count == tstate.policy_opt_state.count
    modules = [getattr(tstate, a) for a, _ in DDPG_NETS]
    assert all(p.grad is None for m in modules for p in m.parameters())


def test_ddpg_clip_delta_changes_the_loss_as_in_jax():
    d = numpy_batch(12)
    d["reward"] = d["reward"] * 5.0
    jb, tb = both_batches(d)
    losses = {}
    for clip in (True, False):
        jcore, tcore = _ddpg_cores("soft", clip)
        jstate = _ddpg_warm_state(jcore)
        tstate = convert.actor_critic_state_from_flax(tcore, np_tree(jstate), device="cpu")
        _, jaux = jcore.update(jstate, KEY, jb)
        _, taux = tcore.update(tstate, tb)
        assert_close(taux["loss"], jaux["loss"], 1e-5, f"clip_delta={clip}")
        losses[clip] = float(taux["loss"])
    assert losses[True] < losses[False]


def test_ddpg_rejects_an_unknown_sync_method():
    with pytest.raises(ValueError):
        DDPGCore(deterministic_policy(OBS, ACT, HIDDEN), _tqf(), Adam(LR), Adam(LR), target_update_method="polyak")
