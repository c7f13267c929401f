"""The port's actor-critic shells (``DDPG``, ``TD3``, ``SoftActorCritic``
over ``ActorCriticShellAgent``) against the JAX package's.

Each shell runs through the same driver of its package
(``train_agent_with_evaluation``, or ``train_agent_batch_with_evaluation``
over a two-lane ``SerialVectorEnv``) over the same host env, a MujocoSim of
5 observations and 2 actions truncated at 30 steps (``HostJaxEnv`` and
``HostTorchEnv``; the port's env takes the JAX env's matrices). The JAX shell builds its initial state from a real key;
``convert.actor_critic_shell_from_flax`` hands it, optimizer moments
included, to the port's shell. Draws are matched by value (:class:`Tape`
and :func:`install_tape`, ROADMAP C29): the port logs seeded numpy draws
and the JAX run, under ``jax.disable_jit``, pops them in program order: the
resets, the explorer's noise or the policy's sample, the burn-in actions,
the ring's ids, TD3's smoothing noise and SAC's samples. The JAX core
draws its burn-in actions at every act and discards them from
``burnin_steps`` on, where the port's host comparison draws none, so the
tests' JAX burn-in function takes the tape's draw only while the shell's
``t`` is below ``burnin_steps``.

DDPG's hard-target run stops at 30 updates: at its 34th update, on this
seed, a first-layer ReLU unit of the policy that no sample had switched on
takes a gradient in one package and none in the other, and Adam turns that
into steps of about the learning rate (C54: its weights then drift 1.5e-5
apart per update). Nudges of the starting weights do not flip that unit,
so the longer run is not held here; the parameters agreed within 2.1e-7
through the 33rd update.

The burst path (``update_burst``, two updates per observe over two lanes)
runs the port's plain loop against the JAX shell's scan, whose per-iteration
key splits pop the same draws in the same order.

Tolerances: counts (``t``, updates, target syncs, Adam's count) and the
evaluation rows' columns but ``elapsed`` exactly; actions within 1e-5, or
4x what the nudges below move them (the networks' and the env's sums
differ by ulps, and the actions feed back through the env);
``average_critic_loss``
within 1e-4 relative; parameters, targets and first moments within 3e-6,
second moments within 1e-5 of their largest magnitude, or 4x what
1 +- 2**-23 nudges of the port's starting weights move each, where that is
more (C22, C54; :func:`assert_within_nudges`).
"""

import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_host_agents import NUDGES, new_log, record, scores
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import spaces as jspaces
from pfrl_tpu.agents.ddpg import DDPG as JaxDDPG
from pfrl_tpu.agents.soft_actor_critic import SoftActorCritic as JaxSAC
from pfrl_tpu.agents.td3 import TD3 as JaxTD3
from pfrl_tpu.envs import HostJaxEnv
from pfrl_tpu.envs import MujocoSim as JaxMujocoSim
from pfrl_tpu.envs import SerialVectorEnv as JaxSerialVectorEnv
from pfrl_tpu.experiments import train_agent_batch_with_evaluation as jax_train_batch
from pfrl_tpu.experiments import train_agent_with_evaluation as jax_train
from pfrl_tpu.models import MLP as JaxMLP
from pfrl_tpu.policies import DeterministicHead as JaxDeterministicHead
from pfrl_tpu.policies import SquashedGaussianHead as JaxSquashedGaussianHead
from pfrl_tpu.q_functions import FCSAQFunction as JaxFCSAQFunction
from pfrl_tpu.replay import ReplayBuffer as JaxReplayBuffer
from pfrl_tpu_torch import convert, spaces
from pfrl_tpu_torch.agents import DDPG, TD3, SoftActorCritic
from pfrl_tpu_torch.envs import HostTorchEnv, MujocoSim, SerialVectorEnv
from pfrl_tpu_torch.experiments import train_agent_batch_with_evaluation, train_agent_with_evaluation
from pfrl_tpu_torch.experiments.mujoco_actor_critic import MLPPolicy
from pfrl_tpu_torch.explorers import AdditiveGaussian
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.policies import DeterministicHead, SquashedGaussianHead
from pfrl_tpu_torch.q_functions import FCSAQFunction
from pfrl_tpu_torch.replay import ReplayBuffer
from pfrl_tpu_torch.utils.draws import uniform_between

torch.set_num_threads(1)

HIDDEN = 32
OBS, ACT = 5, 2
EPISODE = 30
BURNIN = 40


class JaxDeterministicPolicy(nn.Module):
    """``train_td3.py``'s and ``train_ddpg.py``'s ``Policy`` at a test width."""

    @nn.compact
    def __call__(self, x):
        h = JaxMLP(out_size=ACT, hidden_sizes=(HIDDEN, HIDDEN))(x)
        return JaxDeterministicHead()(jnp.tanh(h))


class JaxGaussianPolicy(nn.Module):
    """``train_soft_actor_critic.py``'s ``Policy`` at a test width."""

    @nn.compact
    def __call__(self, x):
        h = JaxMLP(out_size=2 * ACT, hidden_sizes=(HIDDEN, HIDDEN))(x)
        return JaxSquashedGaussianHead(action_size=ACT)(h)


def jax_burnin(jagent_ref, rng, batch):
    """Uniform burn-in actions, drawn only while the shell's ``t`` is below
    ``BURNIN`` (the port's draws; see the module docstring)."""
    if jagent_ref[0].t < BURNIN:
        return jax.random.uniform(rng, (batch, ACT), minval=-1.0, maxval=1.0)
    return jnp.zeros((batch, ACT), jnp.float32)


def port_burnin(draws, batch):
    return uniform_between(draws, -1.0, 1.0, (batch, ACT))


SETTINGS = dict(replay_start_size=32, minibatch_size=16, update_interval=1)


def jax_shell(kind, burst=False, hard=False):
    """The JAX shell with its initial state built from a real key."""
    ref = [None]
    kw = dict(SETTINGS, action_space=jspaces.box(-1.0, 1.0, (ACT,)), update_burst=burst,
              burnin_action_func=functools.partial(jax_burnin, ref), burnin_steps=BURNIN)
    qf = lambda: JaxFCSAQFunction(n_hidden_channels=HIDDEN, n_hidden_layers=2)  # noqa: E731
    buffer = JaxReplayBuffer(1000, gamma=0.9)
    if kind == "ddpg":
        jagent = JaxDDPG(JaxDeterministicPolicy(), qf(), optax.adam(1e-3), optax.adam(1e-3), buffer, 0.9,
                         jexplorers.AdditiveGaussian(0.1, low=-1.0, high=1.0),
                         target_update_method="hard" if hard else "soft", target_update_interval=10, **kw)
    elif kind == "td3":
        jagent = JaxTD3(JaxDeterministicPolicy(), qf(), qf(), optax.adam(1e-3), optax.adam(1e-3), optax.adam(1e-3),
                        buffer, 0.9, jexplorers.AdditiveGaussian(0.1, low=-1.0, high=1.0), **kw)
    else:
        jagent = JaxSAC(JaxGaussianPolicy(), qf(), qf(), optax.adam(1e-3), optax.adam(1e-3), optax.adam(1e-3),
                        buffer, 0.9, temperature_optimizer_lr=1e-3, **kw)
    ref[0] = jagent
    with jagent.eval_mode():
        jagent.batch_act(np.zeros((1, OBS), np.float32))
    return jagent


def port_shell(kind, jstate, draws, scale=1.0, burst=False, hard=False, device="cpu"):
    """The port's shell from the JAX shell's state ``jstate`` (its weights
    times ``scale``), drawing from ``draws``."""
    kw = dict(SETTINGS, action_space=spaces.box(-1.0, 1.0, (ACT,)), update_burst=burst,
              burnin_action_func=port_burnin, burnin_steps=BURNIN, device=device, draws=draws)
    qf = lambda: FCSAQFunction(OBS, ACT, HIDDEN, 2)  # noqa: E731
    det = lambda: MLPPolicy(OBS, ACT, (HIDDEN, HIDDEN), DeterministicHead(), squash=torch.tanh)  # noqa: E731
    buffer = ReplayBuffer(1000, gamma=0.9, device=device)
    if kind == "ddpg":
        tagent = DDPG(det(), qf(), Adam(1e-3), Adam(1e-3), buffer, 0.9, AdditiveGaussian(0.1, low=-1.0, high=1.0),
                      target_update_method="hard" if hard else "soft", target_update_interval=10, **kw)
    elif kind == "td3":
        tagent = TD3(det(), qf(), qf(), Adam(1e-3), Adam(1e-3), Adam(1e-3), buffer, 0.9,
                     AdditiveGaussian(0.1, low=-1.0, high=1.0), **kw)
    else:
        tagent = SoftActorCritic(MLPPolicy(OBS, 2 * ACT, (HIDDEN, HIDDEN), SquashedGaussianHead(ACT)), qf(), qf(),
                                 Adam(1e-3), Adam(1e-3), Adam(1e-3), buffer, 0.9, temperature_optimizer_lr=1e-3, **kw)
    convert.actor_critic_shell_from_flax(tagent, jstate)
    return scale_modules(tagent, scale)


def _modules(state):
    return {f: getattr(state, f) for f in vars(state) if isinstance(getattr(state, f), torch.nn.Module)}


def scale_modules(agent, scale):
    """``agent`` with every network and target times ``scale``."""
    with torch.no_grad():
        for module in _modules(agent.train_state).values():
            for p in module.parameters():
                p.mul_(scale)
    return agent


JAX_FIELD = {"policy": "policy_params", "q_func": "q_params", "q_func1": "q1_params", "q_func2": "q2_params",
             "target_policy": "target_policy_params", "target_q_func": "target_q_params",
             "target_q_func1": "target_q1_params", "target_q_func2": "target_q2_params"}
OPT_MODULE = {"policy_opt_state": "policy", "q_opt_state": "q_func", "q1_opt_state": "q_func1",
              "q2_opt_state": "q_func2"}


def port_tensors(agent):
    ts, out = agent.train_state, {}
    for field, module in _modules(ts).items():
        out.update({f"{field} {n}": p.detach().numpy().copy() for n, p in module.named_parameters()})
    for opt, field in OPT_MODULE.items():
        if hasattr(ts, opt):
            names = [n for n, _ in getattr(ts, field).named_parameters()]
            for k in ("mu", "nu"):
                out.update({f"{k} {field} {n}": m.numpy().copy() for n, m in zip(names, getattr(getattr(ts, opt), k))})
    if hasattr(ts, "log_temperature"):
        out["log_temperature"] = ts.log_temperature.detach().numpy().copy()
        out["mu log_temperature"] = ts.temperature_opt_state.mu[0].numpy().copy()
        out["nu log_temperature"] = ts.temperature_opt_state.nu[0].numpy().copy()
    return out


def jax_tensors(tagent, jagent):
    ts, js, out = tagent.train_state, jagent.train_state, {}
    for field, module in _modules(ts).items():
        arrays = convert.torch_arrays(module, np_tree(getattr(js, JAX_FIELD[field])))
        out.update({f"{field} {n}": a for n, a in arrays.items()})
    for opt, field in OPT_MODULE.items():
        if hasattr(ts, opt):
            adam = getattr(js, opt)[0]
            for k in ("mu", "nu"):
                arrays = convert.torch_arrays(getattr(ts, field), np_tree(getattr(adam, k)))
                out.update({f"{k} {field} {n}": a for n, a in arrays.items()})
    if hasattr(ts, "log_temperature"):
        out["log_temperature"] = np.asarray(js.log_temperature)
        out["mu log_temperature"] = np.asarray(js.temperature_opt_state[0].mu)
        out["nu log_temperature"] = np.asarray(js.temperature_opt_state[0].nu)
    return out


def assert_states_close(tagent, jagent, nudged, what):
    ts, js = tagent.train_state, jagent.train_state
    assert ts.n_updates == int(js.n_updates)
    for opt in OPT_MODULE:
        if hasattr(ts, opt):
            assert getattr(ts, opt).count == int(getattr(js, opt)[0].count), opt
    assert_within_nudges(port_tensors(tagent), jax_tensors(tagent, jagent), [port_tensors(a) for a in nudged], what)


def assert_within_nudges(got: dict, want: dict, nudged: list, what: str, mu_rel: float = 3e-6):
    """Parameters and targets within 3e-6 (C22), first moments within
    ``mu_rel`` of their largest magnitude where that exceeds 1 (a critic's
    gradients reach tens, and float32 rounds them at that scale), second
    moments within 1e-5 of their largest magnitude; or each within 4x the
    larger of what 1 + 2**-23 and 1 - 2**-23 nudges of the port's starting
    weights move it, where that is more (C54)."""
    for name, x in got.items():
        nudge = max(float(np.abs(x - n[name]).max()) for n in nudged)
        scale = float(np.abs(want[name]).max())
        floor = 1e-5 * scale if name.startswith("nu ") else mu_rel * max(1.0, scale) if name.startswith("mu ") else 3e-6
        bound = max(floor, 4 * nudge)
        diff = float(np.abs(x - want[name]).max())
        assert diff <= bound, f"{what} {name}: {diff} > {bound} (nudges move it {nudge}, largest {scale})"


def assert_actions_close(tlog, jlog, nudged_logs):
    """Every action within 1e-5, or 4x what the nudged runs move it."""
    assert len(tlog["actions"]) == len(jlog["actions"])
    for nlog in nudged_logs:
        assert len(nlog["actions"]) == len(tlog["actions"])
    for i, (got, want) in enumerate(zip(tlog["actions"], jlog["actions"])):
        assert got.shape == want.shape and got.dtype == np.float32
        nudge = max(float(np.abs(got - n["actions"][i]).max()) for n in nudged_logs)
        bound = max(1e-5, 4 * nudge)
        diff = float(np.abs(got - want).max())
        assert diff <= bound, f"action {i}: {diff} > {bound} (nudges move it {nudge})"


def assert_scores_close(tdir, jdir):
    theader, trows = scores(tdir)
    jheader, jrows = scores(jdir)
    assert theader == jheader and len(trows) == len(jrows) >= 1
    for trow, jrow in zip(trows, jrows):
        for col in theader:
            if col == "elapsed":
                continue
            if col.startswith("average_") or col in ("mean", "median", "stdev", "max", "min"):
                np.testing.assert_allclose(float(trow[col]), float(jrow[col]), rtol=1e-4, atol=1e-4, err_msg=col)
            else:
                assert trow[col] == jrow[col], (col, trow[col], jrow[col])


def assert_stats_close(tstats, jstats):
    assert [k for k, _ in tstats] == [k for k, _ in jstats] == ["average_critic_loss", "n_updates"]
    np.testing.assert_allclose(tstats[0][1], float(jstats[0][1]), rtol=1e-4)
    assert tstats[1][1] == jstats[1][1]


JAX_SIM = JaxMujocoSim(obs_dim=OBS, action_dim=ACT, episode_len=EPISODE)  # draws its matrices from a real key


def port_sim(tape):
    sim = MujocoSim(OBS, ACT, EPISODE, A=np.asarray(JAX_SIM._A), B=np.asarray(JAX_SIM._B), device="cpu")
    return HostTorchEnv(sim, draws=tape)


def _jax_env(lanes):
    return HostJaxEnv(JAX_SIM) if lanes == 1 else JaxSerialVectorEnv([HostJaxEnv(JAX_SIM) for _ in range(lanes)])


def _port_env(lanes, tape):
    return port_sim(tape) if lanes == 1 else SerialVectorEnv([port_sim(tape) for _ in range(lanes)])


RUNS = [  # (kind, lanes, burst, hard, steps)
    ("ddpg", 1, False, False, 90),
    ("ddpg", 2, True, True, 60),  # 30 updates, 6 hard syncs (see the module docstring)
    ("td3", 1, False, False, 79),  # 48 updates: the actor steps on 24 of them
    ("td3", 2, True, False, 90),
    ("sac", 1, False, False, 80),
    ("sac", 2, True, False, 90),
]


@pytest.mark.parametrize("kind,lanes,burst,hard,steps", RUNS)
def test_actor_critic_shell_matches_jax_through_the_drivers(tmp_path, kind, lanes, burst, hard, steps):
    jagent = jax_shell(kind, burst, hard)
    jstate = np_tree(jagent.train_state)
    if lanes == 1:
        port_driver, jax_driver = train_agent_with_evaluation, jax_train
        kw = dict(steps=steps, eval_n_steps=None, eval_n_episodes=2, eval_interval=40, train_max_episode_len=EPISODE)
    else:
        port_driver, jax_driver = train_agent_batch_with_evaluation, jax_train_batch
        kw = dict(steps=steps, eval_n_steps=None, eval_n_episodes=2, eval_interval=40, max_episode_len=EPISODE)

    def port_run(scale, outdir):
        tape, log = Tape(13), new_log()
        tagent = port_shell(kind, jstate, tape, scale, burst, hard)
        port_driver(record(tagent, log), _port_env(lanes, tape), outdir=outdir, eval_env=_port_env(lanes, tape), **kw)
        return tagent, tape, log

    tagent, tape, tlog = port_run(1.0, str(tmp_path / "port"))
    nudged_runs = [port_run(s, str(tmp_path / f"nudged{i}")) for i, s in enumerate(NUDGES)]
    nudged = [a for a, _, _ in nudged_runs]
    jlog = new_log()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jax_driver(record(jagent, jlog), _jax_env(lanes), outdir=str(tmp_path / "jax"), eval_env=_jax_env(lanes), **kw)
        assert not tape.log
    assert_actions_close(tlog, jlog, [log for _, _, log in nudged_runs])
    n_updates = (tagent.t - SETTINGS["replay_start_size"]) // 1 + 1 if lanes == 1 else (tagent.t - 32 + 2)
    assert tagent.t == jagent.t >= steps
    assert tagent.train_state.n_updates == int(jagent.train_state.n_updates)
    if kind != "td3":
        assert tagent.train_state.n_updates == n_updates
    if kind == "td3":
        # The port soft-copies on the actor's cycle only; the JAX core
        # computes the copy every update and selects it in on-cycle.
        assert jlog["syncs"] == tagent.train_state.n_updates
        assert tlog["syncs"] == (tagent.train_state.n_updates + 1) // 2
    else:
        assert tlog["syncs"] == jlog["syncs"]
    if hard:
        assert tlog["syncs"] == tagent.t // 10  # the hard method syncs on each crossing
    elif kind == "ddpg":
        assert tlog["syncs"] == n_updates  # the shell never syncs soft targets: the core's update does
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics())
    assert_scores_close(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_states_close(tagent, jagent, nudged, f"{kind} lanes={lanes}")


def test_td3_over_an_odd_number_of_updates_steps_the_actor_on_even_ones():
    """Three updates: the critics step three times, the actor and the
    targets twice (``n_updates`` 0 and 2); the statistics report the
    critic's loss only, ``n_updates`` from the core's host counter."""
    jagent = jax_shell("td3")
    tagent = port_shell("td3", np_tree(jagent.train_state), Tape(3))
    tagent.replay_start_size = 4
    rs = np.random.RandomState(0)
    policy_before = [p.detach().clone() for p in tagent.train_state.policy.parameters()]
    counts = []
    for _ in range(6):
        tagent.batch_act(rs.normal(size=(1, OBS)).astype(np.float32))
        tagent.batch_observe(rs.normal(size=(1, OBS)).astype(np.float32), np.ones(1), np.zeros(1, bool),
                             np.zeros(1, bool))
        counts.append(tagent.train_state.policy_opt_state.count)
    assert tagent.train_state.n_updates == 3
    assert counts == [0, 0, 0, 1, 1, 2]
    assert tagent.train_state.q1_opt_state.count == 3
    assert not all(torch.equal(a, b) for a, b in zip(policy_before, tagent.train_state.policy.parameters()))
    stats = tagent.get_statistics()
    assert [k for k, _ in stats] == ["average_critic_loss", "n_updates"] and stats[1][1] == 3


@pytest.mark.parametrize("kind", ["ddpg", "td3", "sac"])
def test_actor_critic_shell_save_load_round_trip(tmp_path, kind):
    """``save`` writes ``train_state.pt``; ``load`` into a fresh shell,
    before its first act, restores every network, target, moment and
    counter; the greedy actions then agree."""
    jstate = np_tree(jax_shell(kind).train_state)
    trained = port_shell(kind, jstate, Tape(5))
    train_agent_with_evaluation(trained, port_sim(Tape(6)), steps=60, eval_n_steps=None, eval_n_episodes=1,
                                eval_interval=10**6, outdir=str(tmp_path / "run"))
    assert trained.train_state.n_updates > 10
    trained.save(str(tmp_path / "agent"))
    assert sorted(os.listdir(tmp_path / "agent")) == ["train_state.pt"]
    fresh = port_shell(kind, jstate, Tape(9), scale=0.5)
    fresh.train_state = None
    fresh.load(str(tmp_path / "agent"))
    obs = np.random.RandomState(0).normal(size=(7, OBS)).astype(np.float32)
    with fresh.eval_mode(), trained.eval_mode():
        np.testing.assert_array_equal(fresh.batch_act(obs), trained.batch_act(obs))
    want, got = port_tensors(trained), port_tensors(fresh)
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert fresh.train_state.n_updates == trained.train_state.n_updates


def test_actor_critic_shell_builds_its_state_at_the_first_act_from_the_batch():
    """No state until the first act; then the networks from the seed's CPU
    generator, whatever the batch, and ``_last_obs`` kept only while
    training."""
    make = lambda seed: DDPG(  # noqa: E731
        MLPPolicy(OBS, ACT, (HIDDEN, HIDDEN), DeterministicHead(), squash=torch.tanh), FCSAQFunction(OBS, ACT, HIDDEN, 2),
        Adam(1e-3), Adam(1e-3), ReplayBuffer(100, gamma=0.9, device="cpu"), 0.9, AdditiveGaussian(0.1),
        action_space=spaces.box(-1.0, 1.0, (ACT,)), seed=seed, device="cpu")
    a, b = make(4), make(4)
    assert a.train_state is None
    with a.eval_mode():
        a.batch_act(np.zeros((3, OBS)))
    assert a._last_obs is None
    b.batch_act(np.zeros((5, OBS), np.float32))
    assert b._last_obs.shape == (5, OBS) and b._last_obs.dtype == torch.float32
    for p, q in zip(port_tensors(a).values(), port_tensors(b).values()):
        np.testing.assert_array_equal(p, q)
