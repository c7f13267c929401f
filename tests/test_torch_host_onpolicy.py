"""The port's on-policy shells (``PPO``, ``A2C``, ``TRPO`` over
``OnPolicyShellAgent``) against the JAX package's.

Each shell runs through the same driver of its package over the same host
envs: a MujocoSim of 5 observations and 2 actions truncated at 30 steps
(PPO, TRPO) and CartPole limited to 500 steps with episodes cut at 50
(A2C), behind ``HostJaxEnv`` and ``HostTorchEnv``. The JAX shell builds its
state from a real key and ``convert.onpolicy_shell_from_flax`` hands it to
the port's shell. Draws are matched by value (``Tape``/``install_tape``,
C29, plus ``permutation``): the resets, the acts' samples (a Gaussian's
normals, a categorical's uniforms), and one permutation per PPO epoch or
TRPO value-function epoch; the JAX shells run under ``jax.disable_jit``.

Tolerances: actions within 1e-5, or 4x what 1 +- 2**-23 nudges of the
port's starting weights move them; ``t``, the updates and Adam's count
exactly; ``average_value`` and ``average_entropy`` within 1e-5 relative,
``average_loss`` within 1e-4 relative or 1e-6 absolute (a mean of
near-cancelling surrogate terms); parameters and first moments within 3e-6
(of their largest magnitude where that exceeds 1), second moments within
1e-5 of their largest magnitude, or 4x what the nudges move each (C22,
C54; TRPO's conjugate gradient amplifies float32 rounding, C21/C44, which
the nudges measure).
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_host_actor_critic import JAX_SIM, assert_actions_close, assert_within_nudges, port_sim
from test_torch_host_agents import NUDGES, new_log, record, scores
from test_torch_ppo import JaxGaussianPi, JaxGaussianPiV, JaxSoftmaxPiV
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu.agents.a2c import A2C as JaxA2C
from pfrl_tpu.agents.ppo import PPO as JaxPPO
from pfrl_tpu.agents.trpo import TRPO as JaxTRPO
from pfrl_tpu.envs import CartPole as JaxCartPole
from pfrl_tpu.envs import HostJaxEnv
from pfrl_tpu.envs import SerialVectorEnv as JaxSerialVectorEnv
from pfrl_tpu.envs import TimeLimit as JaxTimeLimit
from pfrl_tpu.experiments import train_agent_batch_with_evaluation as jax_train_batch
from pfrl_tpu.experiments import train_agent_with_evaluation as jax_train
from pfrl_tpu.models import MLP as JaxMLP
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import A2C, PPO, TRPO
from pfrl_tpu_torch.envs import CartPole, HostTorchEnv, SerialVectorEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments import train_agent_batch_with_evaluation, train_agent_with_evaluation
from pfrl_tpu_torch.experiments.onpolicy import GaussianPiV, GaussianPolicy, SoftmaxPiV
from pfrl_tpu_torch.models import MLP
from pfrl_tpu_torch.optimizers import Adam

torch.set_num_threads(1)

HIDDEN = 32
OBS, ACT = 5, 2


class PermutationTape(Tape):
    def permutation(self, n):
        return self._record("permutation", self.rs.permutation(n)).to(torch.int64)


def install_permutation_tape(monkeypatch, tape):
    """``install_tape`` plus ``jax.random.permutation`` popping the tape's
    permutations."""
    install_tape(monkeypatch, tape)

    def permutation(key, x, axis=0, independent=False):
        kind, values = tape.log.pop(0)
        assert kind == "permutation" and values.size == x, (kind, values.shape, x)
        return jax.numpy.asarray(values.astype(np.int32))

    monkeypatch.setattr(jax.random, "permutation", permutation)


def jax_shell(kind, update_interval):
    if kind == "ppo":
        jagent = JaxPPO(JaxGaussianPiV(act_dim=ACT, hidden=HIDDEN, mean_scale=1e-4), optax.adam(1e-3), gamma=0.99,
                        lambd=0.97, update_interval=update_interval, minibatch_size=8, epochs=2, entropy_coef=0.0)
        obs = np.zeros((1, OBS), np.float32)
    elif kind == "a2c":
        jagent = JaxA2C(JaxSoftmaxPiV(n_actions=2, hidden=HIDDEN), optax.adam(1e-3), 0.99, 2, update_steps=5)
        obs = np.zeros((1, 4), np.float32)
    else:
        jagent = JaxTRPO(JaxGaussianPi(act_dim=ACT, hidden=HIDDEN, mean_scale=1e-2),
                         JaxMLP(out_size=1, hidden_sizes=(HIDDEN, HIDDEN)), optax.adam(1e-3), gamma=0.995, lambd=0.97,
                         update_interval=update_interval, vf_epochs=2, vf_batch_size=8,
                         conjugate_gradient_max_iter=20)
        obs = np.zeros((1, OBS), np.float32)
    with jagent.eval_mode():
        jagent.batch_act(obs)
    return jagent


def port_shell(kind, update_interval, jstate, draws, scale=1.0, device="cpu"):
    kw = dict(device=device, draws=draws)
    if kind == "ppo":
        tagent = PPO(GaussianPiV(OBS, ACT, HIDDEN, mean_scale=1e-4), Adam(1e-3), gamma=0.99, lambd=0.97,
                     update_interval=update_interval, minibatch_size=8, epochs=2, entropy_coef=0.0, **kw)
    elif kind == "a2c":
        tagent = A2C(SoftmaxPiV(4, 2, HIDDEN), Adam(1e-3), 0.99, 2, update_steps=5, **kw)
    else:
        tagent = TRPO(GaussianPolicy(OBS, ACT, HIDDEN, mean_scale=1e-2), MLP(OBS, 1, (HIDDEN, HIDDEN)), Adam(1e-3),
                      gamma=0.995, lambd=0.97, update_interval=update_interval, vf_epochs=2, vf_batch_size=8,
                      conjugate_gradient_max_iter=20, **kw)
    convert.onpolicy_shell_from_flax(tagent, jstate)
    with torch.no_grad():
        for module in _modules(tagent.train_state).values():
            for p in module.parameters():
                p.mul_(scale)
    return tagent


def _modules(state):
    return {f: getattr(state, f) for f in vars(state) if isinstance(getattr(state, f), torch.nn.Module)}


JAX_FIELD = {"model": "params", "policy": "policy_params", "vf": "vf_params"}
OPT = {"opt_state": "model", "vf_opt_state": "vf"}


def port_tensors(agent):
    ts, out = agent.train_state, {}
    for field, module in _modules(ts).items():
        out.update({f"{field} {n}": p.detach().numpy().copy() for n, p in module.named_parameters()})
    for opt, field in OPT.items():
        if hasattr(ts, opt):
            names = [n for n, _ in getattr(ts, field).named_parameters()]
            for k in ("mu", "nu"):
                out.update({f"{k} {field} {n}": m.numpy().copy() for n, m in zip(names, getattr(getattr(ts, opt), k))})
    return out


def jax_tensors(tagent, jagent):
    ts, js, out = tagent.train_state, jagent.train_state, {}
    for field, module in _modules(ts).items():
        arrays = convert.torch_arrays(module, np_tree(getattr(js, JAX_FIELD[field])))
        out.update({f"{field} {n}": a for n, a in arrays.items()})
    for opt, field in OPT.items():
        if hasattr(ts, opt):
            adam = getattr(js, opt)[0]
            for k in ("mu", "nu"):
                arrays = convert.torch_arrays(getattr(ts, field), np_tree(getattr(adam, k)))
                out.update({f"{k} {field} {n}": a for n, a in arrays.items()})
    return out


def assert_stats_close(tstats, jstats):
    assert [k for k, _ in tstats] == [k for k, _ in jstats] == [
        "average_value", "average_entropy", "average_loss", "n_updates"]
    for (k, tv), (_, jv) in zip(tstats[:2], jstats[:2]):
        np.testing.assert_allclose(tv, float(jv), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tstats[2][1], float(jstats[2][1]), rtol=1e-4, atol=1e-6)
    assert tstats[3][1] == jstats[3][1]


def assert_scores_close(tdir, jdir):
    theader, trows = scores(tdir)
    jheader, jrows = scores(jdir)
    assert theader == jheader and len(trows) == len(jrows) >= 1
    for trow, jrow in zip(trows, jrows):
        for col in theader:
            if col == "elapsed":
                continue
            if col == "average_loss":
                np.testing.assert_allclose(float(trow[col]), float(jrow[col]), rtol=1e-4, atol=1e-6, err_msg=col)
            elif col.startswith("average_") or col in ("mean", "median", "stdev", "max", "min"):
                np.testing.assert_allclose(float(trow[col]), float(jrow[col]), rtol=1e-4, atol=1e-4, err_msg=col)
            else:
                assert trow[col] == jrow[col], (col, trow[col], jrow[col])


def _envs(kind, lanes, tape=None):
    """The JAX env (``tape`` None) or the port's, one lane or ``lanes``."""
    if kind == "a2c":
        make = ((lambda: HostJaxEnv(JaxTimeLimit(JaxCartPole(), 500))) if tape is None
                else (lambda: HostTorchEnv(TimeLimit(CartPole(device="cpu"), 500), draws=tape)))
    else:
        make = (lambda: HostJaxEnv(JAX_SIM)) if tape is None else (lambda: port_sim(tape))
    if lanes == 1:
        return make()
    return (JaxSerialVectorEnv if tape is None else SerialVectorEnv)([make() for _ in range(lanes)])


RUNS = [  # (kind, lanes, update_interval, steps): updates = steps // update_interval
    ("ppo", 1, 32, 96),
    ("ppo", 2, 32, 96),
    ("a2c", 2, None, 100),
    ("trpo", 1, 40, 80),
]


@pytest.mark.parametrize("kind,lanes,update_interval,steps", RUNS)
def test_onpolicy_shell_matches_jax_through_the_drivers(tmp_path, kind, lanes, update_interval, steps):
    jagent = jax_shell(kind, update_interval)
    jstate = np_tree(jagent.train_state)
    cut = 50 if kind == "a2c" else 30
    if lanes == 1:
        port_driver, jax_driver = train_agent_with_evaluation, jax_train
        kw = dict(steps=steps, eval_n_steps=None, eval_n_episodes=2, eval_interval=steps // 2,
                  train_max_episode_len=cut)
    else:
        port_driver, jax_driver = train_agent_batch_with_evaluation, jax_train_batch
        kw = dict(steps=steps, eval_n_steps=None, eval_n_episodes=2, eval_interval=steps // 2, max_episode_len=cut)

    def port_run(scale, outdir):
        tape, log = PermutationTape(21), new_log()
        tagent = port_shell(kind, update_interval, jstate, tape, scale)
        port_driver(record(tagent, log), _envs(kind, lanes, tape), outdir=outdir, eval_env=_envs(kind, lanes, tape),
                    **kw)
        return tagent, tape, log

    tagent, tape, tlog = port_run(1.0, str(tmp_path / "port"))
    nudged_runs = [port_run(s, str(tmp_path / f"nudged{i}")) for i, s in enumerate(NUDGES)]
    jenv, jeval = _envs(kind, lanes), _envs(kind, lanes)
    jlog = new_log()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_permutation_tape(mp, tape)
        jax_driver(record(jagent, jlog), jenv, outdir=str(tmp_path / "jax"), eval_env=jeval, **kw)
        assert not tape.log
    if kind == "a2c":
        assert tlog["actions"] and all(a.dtype == np.int64 for a in tlog["actions"])
        for got, want in zip(tlog["actions"], jlog["actions"]):
            np.testing.assert_array_equal(got, want)
        assert len(tlog["actions"]) == len(jlog["actions"])
    else:
        assert_actions_close(tlog, jlog, [log for _, _, log in nudged_runs])
    interval = update_interval or 10
    assert tagent.t == jagent.t == steps
    assert tagent._ptr == jagent._ptr == (steps % interval) // lanes
    n_calls = steps // interval
    assert tagent.train_state.n_updates == int(jagent.train_state.n_updates)
    if kind == "ppo":
        assert tagent.train_state.n_updates == n_calls * 2 * (interval // 8)  # epochs x minibatches
        assert tagent.train_state.opt_state.count == int(jagent.train_state.opt_state[0].count)
    else:
        assert tagent.train_state.n_updates == n_calls
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics())
    assert_scores_close(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_within_nudges(port_tensors(tagent), jax_tensors(tagent, jagent),
                         [port_tensors(a) for a, _, _ in nudged_runs], f"{kind} lanes={lanes}")


@pytest.mark.parametrize("kind", ["ppo", "a2c", "trpo"])
def test_onpolicy_shell_refuses_a_batch_that_does_not_divide_the_interval(kind):
    """``update_interval % num_envs`` must be 0 (``ppo.py:308``); the JAX
    shell asserts it."""
    interval = 30 if kind != "a2c" else None
    jagent = jax_shell(kind, interval)
    tagent = port_shell(kind, interval, np_tree(jagent.train_state), PermutationTape(0))
    lanes = 4  # A2C's interval is 5 x 2 = 10; the others' 30
    obs = np.zeros((lanes, 4 if kind == "a2c" else OBS), np.float32)
    flags = np.zeros(lanes, bool)
    tagent.batch_act(obs)
    with pytest.raises(ValueError, match="must divide by num_envs 4"):
        tagent.batch_observe(obs, np.zeros(lanes), flags, flags)
    with jax.disable_jit():
        jagent.batch_act(obs)
        with pytest.raises(AssertionError, match="must divide by num_envs 4"):
            jagent.batch_observe(obs, np.zeros(lanes), flags, flags)


def test_a2c_update_interval_is_update_steps_times_processes():
    """``pi_loss_coef`` is accepted and dropped, as the JAX shell drops it."""
    for steps, processes in ((5, 2), (8, 3)):
        tagent = A2C(SoftmaxPiV(4, 2, HIDDEN), Adam(1e-3), 0.99, processes, update_steps=steps, pi_loss_coef=0.3,
                     device="cpu")
        jagent = JaxA2C(JaxSoftmaxPiV(n_actions=2, hidden=HIDDEN), optax.adam(1e-3), 0.99, processes,
                        update_steps=steps, pi_loss_coef=0.3)
        assert tagent.update_interval == jagent.update_interval == steps * processes


def test_trpo_shell_takes_no_compute_dtype():
    """As in JAX, the TRPO shell has no ``compute_dtype``: it runs float32."""
    with pytest.raises(TypeError, match="compute_dtype"):
        TRPO(GaussianPolicy(OBS, ACT, HIDDEN), MLP(OBS, 1, (HIDDEN, HIDDEN)), Adam(1e-3),
             compute_dtype=torch.bfloat16, device="cpu")
    with pytest.raises(TypeError, match="compute_dtype"):
        JaxTRPO(JaxGaussianPi(act_dim=ACT, hidden=HIDDEN), JaxMLP(out_size=1, hidden_sizes=(HIDDEN,)),
                optax.adam(1e-3), compute_dtype="bfloat16")


@pytest.mark.parametrize("kind", ["ppo", "a2c", "trpo"])
def test_onpolicy_shell_save_load_round_trip(tmp_path, kind):
    """``save`` writes ``train_state.pt``; ``load`` into a fresh shell before
    its first act restores the networks, the moments and ``n_updates``; the
    greedy actions then agree."""
    interval = 20 if kind != "a2c" else None
    jstate = np_tree(jax_shell(kind, interval).train_state)
    trained = port_shell(kind, interval, jstate, PermutationTape(5))
    train_agent_with_evaluation(trained, _envs(kind, 1, PermutationTape(6)), steps=60, eval_n_steps=None,
                                eval_n_episodes=1, eval_interval=10**6, outdir=str(tmp_path / "run"),
                                train_max_episode_len=30)
    assert trained.train_state.n_updates >= 3
    trained.save(str(tmp_path / "agent"))
    assert sorted(os.listdir(tmp_path / "agent")) == ["train_state.pt"]
    fresh = port_shell(kind, interval, jstate, PermutationTape(9), scale=0.5)
    fresh.train_state = None
    fresh.load(str(tmp_path / "agent"))
    obs = np.random.RandomState(0).normal(size=(7, 4 if kind == "a2c" else OBS)).astype(np.float32)
    with fresh.eval_mode(), trained.eval_mode():
        np.testing.assert_array_equal(fresh.batch_act(obs), trained.batch_act(obs))
    want, got = port_tensors(trained), port_tensors(fresh)
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert fresh.train_state.n_updates == trained.train_state.n_updates
