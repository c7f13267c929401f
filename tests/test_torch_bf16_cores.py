"""Every first-order core of the port at ``compute_dtype=torch.bfloat16``
against the JAX core at ``compute_dtype=jnp.bfloat16``: DQN, Double DQN,
C51, AL, PAL, DoublePAL, DPP, IQN, Double IQN, DDPG, TD3, SAC, PPO and
A2C; and TRPO, which refuses bf16 by name in both packages.

Each pair starts from a converted warm state (the JAX core's initial
weights after one JAX update at bf16, so the moments are non-zero), then
takes one and three updates on the same numpy batch or rollout with the
same draws. The JAX updates run under ``jax.disable_jit``: eagerly, each
op rounds to bf16 as the port's do (``test_torch_precision.py``); jitted,
XLA would keep float32 inside its fusions. Draws are matched by value as
in the float32 tests of each core (``Tape``/``install_tape``,
``give_jax``, ``jax_draws_by_value``).

Checked: every master parameter and every optimizer moment of the port
stays float32, and so do the loss, the per-sample errors and the outputs
of ``action_value`` / the policy; the layers see bf16 (a probe on the
first layer's input); the loss, errors and parameters agree with JAX.

Tolerances. The bf16 forwards are bit-equal (MLPs), so the first
update's loss and errors agree within 1e-6 relative (PPO's loss averages
its minibatch steps, which move the weights: 1e-4). The backwards are
not: torch differentiates the ops it ran (``exp`` and a division for the
softmax, ``1 - y**2`` rounded once for ``tanh``) where JAX applies its
own rules rounded op by op (softmax's custom JVP), and each rounds a bf16
gradient's float32 sums in its own order. Gradients then differ by bf16
ulps (2**-8 relative) here and there, and Adam's step normalizes the
difference: measured, each parameter tensor's total change after one and
three updates agrees with JAX's within 1.5% (L2, relative), and each
moment within 1.2% of its tensor's largest entry. Held: the change within
3%, moments within 3%, later losses 2e-3 relative and errors within 2e-3
of their largest. The float32 tests hold these cores at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_actor_critic_modules import JaxDetPolicy, JaxSACPolicy, np_tree
from test_torch_ppo import JaxGaussianPiV, JaxSoftmaxPiV, jax_draws_by_value, numpy_rollout, permutations
from test_torch_ppo import GivenDraws as PPODraws
from test_torch_sac import GivenDraws, give_jax, numpy_batch
from test_torch_value_modules import Tape, cartpole_obs, install_tape, jax_fc, jax_iqf, port_iqf, value_batch

from pfrl_tpu import q_functions as jq
from pfrl_tpu.agents import trpo as jtrpo
from pfrl_tpu.agents.a2c import A2CCore as JaxA2C
from pfrl_tpu.agents.al import ALCore as JaxAL
from pfrl_tpu.agents.categorical_dqn import CategoricalDQNCore as JaxCategorical
from pfrl_tpu.agents.ddpg import DDPGCore as JaxDDPG
from pfrl_tpu.agents.double_dqn import DoubleDQNCore as JaxDouble
from pfrl_tpu.agents.dpp import DPPCore as JaxDPP
from pfrl_tpu.agents.dqn import DQNCore as JaxDQN
from pfrl_tpu.agents.iqn import DoubleIQNCore as JaxDoubleIQN
from pfrl_tpu.agents.iqn import IQNCore as JaxIQN
from pfrl_tpu.agents.pal import DoublePALCore as JaxDoublePAL
from pfrl_tpu.agents.pal import PALCore as JaxPAL
from pfrl_tpu.agents.ppo import PPOCore as JaxPPO
from pfrl_tpu.agents.ppo import Rollout as JaxRollout
from pfrl_tpu.agents.soft_actor_critic import SACCore as JaxSAC
from pfrl_tpu.agents.td3 import TD3Core as JaxTD3
from pfrl_tpu.replay import TransitionBatch as JaxBatch
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import (
    A2CCore,
    ALCore,
    CategoricalDQNCore,
    DDPGCore,
    DoubleDQNCore,
    DoubleIQNCore,
    DoublePALCore,
    DPPCore,
    DQNCore,
    IQNCore,
    PALCore,
    PPOCore,
    SACCore,
    TD3Core,
    TRPOCore,
)
from pfrl_tpu_torch.agents.ppo import Rollout
from pfrl_tpu_torch.experiments import onpolicy
from pfrl_tpu_torch.experiments.mujoco_actor_critic import deterministic_policy, squashed_gaussian_policy
from pfrl_tpu_torch.experiments.onpolicy import GaussianPiV, SoftmaxPiV
from pfrl_tpu_torch.optimizers import Adam, ClipByGlobalNorm, RMSprop
from pfrl_tpu_torch.q_functions import (
    DistributionalFCStateQFunctionWithDiscreteAction,
    FCSAQFunction,
    FCStateQFunctionWithDiscreteAction,
)
from pfrl_tpu_torch.replay import TransitionBatch

torch.set_num_threads(1)

BF16 = torch.bfloat16
OBS, ACTIONS, HIDDEN = 4, 2, 16
AC_OBS, AC_ACT, AC_HIDDEN, AC_LR = 5, 3, 16, 3e-3
PPO_OBS, PPO_ACT, T, B, MB = 5, 3, 8, 8, 16
LR = 1e-3

VALUE = {  # kind -> (JAX core, port core, extra arguments, clip norm)
    "dqn": (JaxDQN, DQNCore, {}, 10.0),
    "double_dqn": (JaxDouble, DoubleDQNCore, {}, None),
    "categorical_dqn": (JaxCategorical, CategoricalDQNCore, {}, None),
    "al": (JaxAL, ALCore, dict(alpha=0.9), 10.0),
    "pal": (JaxPAL, PALCore, dict(alpha=0.7), None),
    "double_pal": (JaxDoublePAL, DoublePALCore, dict(alpha=0.9), None),
    "dpp": (JaxDPP, DPPCore, dict(eta=2.0), 10.0),
    "iqn": (JaxIQN, IQNCore, dict(quantile_thresholds_N=6, quantile_thresholds_N_prime=5,
                                  quantile_thresholds_K=4), None),
    "double_iqn": (JaxDoubleIQN, DoubleIQNCore, dict(quantile_thresholds_N=6, quantile_thresholds_N_prime=5,
                                                     quantile_thresholds_K=4), 1.0),
}
KINDS = [*VALUE, "ddpg", "td3", "sac", "ppo", "a2c"]


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- the pairs
class _Pair:
    """A JAX core and the port's at bf16, a warm JAX state and its port,
    and how to take one update on each side."""

    def __init__(self, kind):
        self.kind = kind
        self.family = "value" if kind in VALUE else ("onpolicy" if kind in ("ppo", "a2c") else "actor_critic")
        getattr(self, f"_build_{self.family}")(kind)

    # ---- the discrete value family
    def _build_value(self, kind):
        jcls, tcls, extra, max_norm = VALUE[kind]
        if max_norm is None:
            jopt, topt = optax.adam(LR), Adam(LR)
        else:
            jopt, topt = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(LR)), ClipByGlobalNorm(
                max_norm, Adam(LR))
        if "iqn" in kind:
            jm, tm = jax_iqf(), port_iqf()
        elif kind == "categorical_dqn":
            jm = jq.DistributionalFCStateQFunctionWithDiscreteAction(
                n_actions=ACTIONS, n_atoms=11, v_min=-10.0, v_max=10.0, n_hidden_channels=HIDDEN, n_hidden_layers=2)
            tm = DistributionalFCStateQFunctionWithDiscreteAction(OBS, ACTIONS, 11, -10.0, 10.0, 2, HIDDEN)
        else:
            jm, tm = jax_fc(), FCStateQFunctionWithDiscreteAction(OBS, ACTIONS, 2, HIDDEN)
        self.jcore = jcls(model=jm, optimizer=jopt, explorer=None, gamma=0.99, compute_dtype=jnp.bfloat16, **extra)
        self.tcore = tcls(model=tm, optimizer=topt, explorer=None, gamma=0.99, compute_dtype=BF16, **extra)
        obs0 = jnp.zeros((1, OBS))
        js = self.jcore.init(jax.random.PRNGKey(0), obs0)
        js = js.replace(target_params=self.jcore.init(jax.random.PRNGKey(1), obs0).params)
        with jax.disable_jit():
            self.jstate, _ = self.jcore.update(js, jax.random.PRNGKey(2), JaxBatch(**value_batch(0)))
        self.tstate = convert.dqn_state_from_flax(
            self.tcore, np_tree(self.jstate.params), np_tree(self.jstate.target_params),
            opt_state=np_tree(self.jstate.opt_state), n_updates=int(self.jstate.n_updates), device="cpu")
        self.clipped = max_norm is not None  # Adam's moments at ``opt_state[1][0]``
        self.nets = (("model", "params"), ("target_model", "target_params"))

    def _step_value(self, k, monkeypatch):
        b = value_batch(10 + k)
        tape = Tape(20 + k)
        self.tstate, taux = self.tcore.update(self.tstate, TransitionBatch(**{n: _t(v) for n, v in b.items()}), tape)
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            install_tape(mp, tape)
            self.jstate, jaux = self.jcore.update(self.jstate, jax.random.PRNGKey(4), JaxBatch(**b))
        assert not tape.log
        return taux, jaux

    def obs(self):
        return _t(cartpole_obs(np.random.RandomState(7), 8))

    # ---- off-policy actor-critic
    def _build_actor_critic(self, kind):
        jqf = lambda: jq.FCSAQFunction(n_hidden_layers=2, n_hidden_channels=AC_HIDDEN)  # noqa: E731
        tqf = lambda: FCSAQFunction(AC_OBS, AC_ACT, AC_HIDDEN, 2)  # noqa: E731
        adam = lambda: (optax.adam(AC_LR), Adam(AC_LR))  # noqa: E731
        (jp, tp), (j1, t1), (j2, t2) = adam(), adam(), adam()
        if kind == "sac":
            jt, tt = adam()
            self.jcore = JaxSAC(policy=JaxSACPolicy(), q_func1=jqf(), q_func2=jqf(), policy_optimizer=jp,
                                q_func1_optimizer=j1, q_func2_optimizer=j2, temperature_optimizer=jt, gamma=0.99,
                                entropy_target=-float(AC_ACT), initial_temperature=0.7, compute_dtype=jnp.bfloat16)
            self.tcore = SACCore(policy=squashed_gaussian_policy(AC_OBS, AC_ACT, AC_HIDDEN), q_func1=tqf(),
                                 q_func2=tqf(), policy_optimizer=tp, q_func1_optimizer=t1, q_func2_optimizer=t2,
                                 temperature_optimizer=tt, gamma=0.99, entropy_target=-float(AC_ACT),
                                 initial_temperature=0.7, compute_dtype=BF16)
            self.nets = (("policy", "policy_params"), ("q_func1", "q1_params"), ("q_func2", "q2_params"),
                         ("target_q_func1", "target_q1_params"), ("target_q_func2", "target_q2_params"))
            self.noises_per_update, convert_fn = 2, convert.sac_state_from_flax
        elif kind == "td3":
            self.jcore = JaxTD3(policy=JaxDetPolicy(), q_func1=jqf(), q_func2=jqf(), policy_optimizer=jp,
                                q_func1_optimizer=j1, q_func2_optimizer=j2, gamma=0.99, policy_update_delay=2,
                                compute_dtype=jnp.bfloat16)
            self.tcore = TD3Core(policy=deterministic_policy(AC_OBS, AC_ACT, AC_HIDDEN), q_func1=tqf(), q_func2=tqf(),
                                 policy_optimizer=tp, q_func1_optimizer=t1, q_func2_optimizer=t2, gamma=0.99,
                                 policy_update_delay=2, compute_dtype=BF16)
            self.nets = (("policy", "policy_params"), ("q_func1", "q1_params"), ("q_func2", "q2_params"),
                         ("target_policy", "target_policy_params"), ("target_q_func1", "target_q1_params"),
                         ("target_q_func2", "target_q2_params"))
            self.noises_per_update, convert_fn = 1, convert.td3_state_from_flax
        else:
            self.jcore = JaxDDPG(policy=JaxDetPolicy(), q_func=jqf(), policy_optimizer=jp, q_optimizer=j1,
                                 gamma=0.99, compute_dtype=jnp.bfloat16)
            self.tcore = DDPGCore(policy=deterministic_policy(AC_OBS, AC_ACT, AC_HIDDEN), q_func=tqf(),
                                  policy_optimizer=tp, q_optimizer=t1, gamma=0.99, compute_dtype=BF16)
            self.nets = (("policy", "policy_params"), ("q_func", "q_params"),
                         ("target_policy", "target_policy_params"), ("target_q_func", "target_q_params"))
            self.noises_per_update, convert_fn = 0, convert.actor_critic_state_from_flax
        js = self.jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, AC_OBS)), jnp.zeros((1, AC_ACT)))
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            give_jax(mp, *self._noise(100))
            self.jstate, _ = self.jcore.update(js, jax.random.PRNGKey(0), self._batches(100)[0])
        self.tstate = convert_fn(self.tcore, np_tree(self.jstate), device="cpu")
        opt = {"policy": "policy_opt_state", "q_func": "q_opt_state", "q_func1": "q1_opt_state",
               "q_func2": "q2_opt_state"}
        self.opt_fields = [(opt[a], a) for a, _ in self.nets if a in opt]

    def _noise(self, seed):
        rs = np.random.RandomState(seed)
        return [(rs.normal(size=(12, AC_ACT))).astype(np.float32) for _ in range(self.noises_per_update)]

    def _batches(self, seed):
        d = numpy_batch(seed, obs=AC_OBS, act=AC_ACT)
        jb = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()}, extras=FrozenDict())
        return jb, TransitionBatch(**{k: torch.from_numpy(v.copy()) for k, v in d.items()})

    def _step_actor_critic(self, k, monkeypatch):
        jb, tb = self._batches(10 + k)
        noise = self._noise(20 + k)
        draws = GivenDraws(*noise)
        self.tstate, taux = self.tcore.update(self.tstate, tb, draws)
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            give_jax(mp, *noise)
            self.jstate, jaux = self.jcore.update(self.jstate, jax.random.PRNGKey(0), jb)
        assert not draws.queue
        return taux, jaux

    # ---- on-policy
    def _build_onpolicy(self, kind):
        if kind == "ppo":
            kw = dict(epochs=2, minibatch_size=MB, entropy_coef=0.01)
            self.jcore = JaxPPO(JaxGaussianPiV(), optax.adam(3e-4), compute_dtype=jnp.bfloat16, **kw)
            self.tcore = PPOCore(GaussianPiV(PPO_OBS, PPO_ACT, 16), Adam(3e-4), compute_dtype=BF16, **kw)
        else:
            kw = dict(gamma=0.99, entropy_coeff=0.01, v_loss_coef=0.5, max_grad_norm=40.0)
            self.jcore = JaxA2C(JaxSoftmaxPiV(), optax.rmsprop(7e-4, decay=0.99, eps=1e-5),
                                compute_dtype=jnp.bfloat16, **kw)
            self.tcore = A2CCore(SoftmaxPiV(PPO_OBS, 2, 16), RMSprop(7e-4, decay=0.99, eps=1e-5),
                                 compute_dtype=BF16, **kw)
        js = self.jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, PPO_OBS)))
        self.jstate, _ = self._jax_update(js, 100)
        self.tstate = convert.ppo_state_from_flax(self.tcore, np_tree(self.jstate), device="cpu")
        self.nets = (("model", "params"),)

    def _rollout(self, seed, jparams):
        with jax.disable_jit():
            d = numpy_rollout(seed, self.jcore, jparams, discrete=self.kind == "a2c")
        return d, JaxRollout(**{k: jnp.asarray(v) for k, v in d.items()}), Rollout(
            **{k: torch.from_numpy(v.copy()) for k, v in d.items()})

    def _jax_update(self, js, seed):
        _, jr, _ = self._rollout(seed, js.params)
        perms = permutations(seed, 2, T * B)
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            if self.kind == "ppo":
                jax_draws_by_value(mp)
            return self.jcore.update(js, jnp.asarray(perms), jr)

    def _step_onpolicy(self, k, monkeypatch):
        _, jr, tr = self._rollout(10 + k, self.jstate.params)
        perms = permutations(10 + k, 2, T * B)
        draws = PPODraws(*perms) if self.kind == "ppo" else PPODraws()
        self.tstate, taux = self.tcore.update(self.tstate, draws, tr)
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            if self.kind == "ppo":
                jax_draws_by_value(mp)
            self.jstate, jaux = self.jcore.update(self.jstate, jnp.asarray(perms), jr)
        assert not draws.queue
        return taux, jaux

    # ---- shared
    def step(self, k, monkeypatch):
        return getattr(self, f"_step_{self.family}")(k, monkeypatch)

    def port_optimizer_states(self):
        """``(module, moments, JAX moments)`` of every optimizer."""
        s, j = self.tstate, self.jstate
        if self.family == "value":
            adam = j.opt_state[1][0] if self.clipped else j.opt_state[0]
            return [(s.model, s.opt_state.mu + s.opt_state.nu, [adam.mu, adam.nu])]
        if self.family == "onpolicy":
            if self.kind == "a2c":  # the clip + RMSprop chain: nu only
                return [(s.model, list(s.opt_state), [j.opt_state[1][0].nu])]
            return [(s.model, s.opt_state.mu + s.opt_state.nu, [j.opt_state[0].mu, j.opt_state[0].nu])]
        out = []
        for field, attr in self.opt_fields:
            t, adam = getattr(s, field), getattr(j, field)[0]
            out.append((getattr(s, attr), t.mu + t.nu, [adam.mu, adam.nu]))
        return out

    def first_layer(self):
        model = {"value": "model", "onpolicy": "model"}.get(self.family, "policy")
        return next(m for m in getattr(self.tstate, model).modules() if isinstance(m, torch.nn.Linear))


def _assert_close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=what)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_core_updates_match_jax_from_a_converted_state(monkeypatch, kind, n_updates):
    pair = _Pair(kind)
    before = {a: {n: p.detach().clone().numpy() for n, p in getattr(pair.tstate, a).named_parameters()}
              for a, _ in pair.nets}
    for k in range(n_updates):
        taux, jaux = pair.step(k, monkeypatch)
        assert taux["loss"].dtype == torch.float32 and taux["errors"].dtype == torch.float32
        rtol = (1e-4 if kind == "ppo" else 1e-6) if k == 0 else 2e-3
        _assert_close(taux["loss"], jaux["loss"], rtol, 1e-6, f"{kind} update {k} loss")
        if pair.family != "onpolicy":
            jerr = np.asarray(jaux["errors"])
            atol = 1e-6 if k == 0 else 2e-3 * float(np.abs(jerr).max())
            _assert_close(taux["errors"], jerr, 0, atol, f"{kind} update {k} errors")
    moved = 0
    for attr, field in pair.nets:
        module = getattr(pair.tstate, attr)
        want = convert.torch_arrays(module, np_tree(getattr(pair.jstate, field)))
        for name, p in module.named_parameters():
            assert p.dtype == torch.float32, name  # the masters stay float32
            start = before[attr][name]
            change, jchange = p.detach().numpy() - start, want[name] - start
            size = float(np.linalg.norm(jchange))
            assert float(np.linalg.norm(change - jchange)) <= 0.03 * size, f"{kind} {attr}.{name}"
            moved += size > 0
    assert moved > 0
    for module, moments, jtrees in pair.port_optimizer_states():
        names = [n for n, _ in module.named_parameters()]
        wants = [convert.torch_arrays(module, np_tree(tree)) for tree in jtrees]
        for i, m in enumerate(moments):
            assert m.dtype == torch.float32  # and so do the optimizer's moments
            want = wants[i // len(names)][names[i % len(names)]]
            _assert_close(m.numpy(), want, 0, 3e-2 * float(np.abs(want).max()) + 1e-12, f"{kind} moment {i}")


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_cores_compute_in_bf16_and_return_float32(kind):
    pair = _Pair(kind)
    seen = []
    hook = pair.first_layer().register_forward_pre_hook(lambda m, args: seen.append((args[0].dtype, m.weight.dtype)))
    core, state = pair.tcore, pair.tstate
    if pair.family == "value":
        out = core.action_value(state.model, pair.obs(), Tape(0))
        fields = [out.q_values]
    elif pair.family == "onpolicy":
        dist, value = core.forward(state.model, torch.zeros(4, PPO_OBS))
        fields = [value, *(getattr(dist, f) for f in ("loc", "scale", "logits") if hasattr(dist, f))]
    else:
        dist = core.policy_dist(state.policy, torch.zeros(4, AC_OBS))
        q = core.q_value(getattr(state, "q_func", getattr(state, "q_func1", None)), torch.zeros(4, AC_OBS),
                         torch.zeros(4, AC_ACT))
        fields = [q, dist.loc]
    hook.remove()
    assert seen and all(s == (BF16, BF16) for s in seen), seen
    assert all(f.dtype == torch.float32 for f in fields)
    assert core.compute_dtype is BF16


def test_trpo_refuses_bf16_by_name_as_the_jax_package_does():
    assert "compute_dtype" not in jtrpo.TRPOCore.__init__.__code__.co_varnames
    with pytest.raises(TypeError, match="compute_dtype"):
        TRPOCore(GaussianPiV(3, 1), FCSAQFunction(3, 1), Adam(1e-3), compute_dtype=BF16)
    with pytest.raises(ValueError, match="TRPO runs float32"):
        onpolicy.make_trpo_pendulum_runner(compute_dtype=BF16, device="cpu")
    assert onpolicy.make_trpo_pendulum_runner(device="cpu", num_envs=2, rollout_len=4).core is not None


@pytest.mark.parametrize("kind", ["td3", "sac"])
def test_fused_twin_apply_gives_the_numbers_of_two_separate_applies(kind):
    """The JAX cores evaluate identical twin critics as one vmapped apply
    over stacked parameters (``_apply_twin``); the port applies them one
    after the other. At bf16, eagerly, the two agree to the bit, and so
    does JAX's own unfused path."""
    pair = _Pair(kind)
    jcore, jstate, tcore, tstate = pair.jcore, pair.jstate, pair.tcore, pair.tstate
    assert jcore._twin_fused
    rs = np.random.RandomState(5)
    x = rs.normal(size=(12, AC_OBS)).astype(np.float32)
    a = rs.uniform(-1, 1, (12, AC_ACT)).astype(np.float32)
    with jax.disable_jit():
        fused = jcore._apply_twin(jstate.q1_params, jstate.q2_params, jnp.asarray(x), jnp.asarray(a))
        jcore._twin_fused = False
        separate = jcore._apply_twin(jstate.q1_params, jstate.q2_params, jnp.asarray(x), jnp.asarray(a))
    with torch.no_grad():
        port = [tcore.q_value(q, _t(x), _t(a)) for q in (tstate.q_func1, tstate.q_func2)]
    for j_fused, j_separate, t in zip(fused, separate, port):
        assert t.dtype == torch.float32 and str(j_fused.dtype) == "float32"
        np.testing.assert_array_equal(np.asarray(j_fused), np.asarray(j_separate))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j_fused))
