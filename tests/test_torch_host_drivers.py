"""The port's host training drivers against the JAX package's:
``train_agent`` and ``train_agent_batch`` with their ``*_with_evaluation``,
``Evaluator`` and the evaluation functions, the step and evaluation hooks,
``prepare_output_dir`` and ``is_return_code_zero``.

The same scripted numpy agent and the same scripted numpy envs go through
both packages' drivers (the agent on each package's ``BatchAgent``, the
vector envs each package's ``SerialVectorEnv``). Held exactly: the
sequence of every act, observe, reset mask, step hook and evaluation hook
call, the saves, the training history, and the rows of ``scores.txt``
(all but ``elapsed``, a wall time).
"""

import os

import numpy as np
import pytest

from pfrl_tpu import agent as jax_agent
from pfrl_tpu import experiments as jexp
from pfrl_tpu.envs import SerialVectorEnv as JaxSerialVectorEnv
from pfrl_tpu.utils.is_return_code_zero import is_return_code_zero as jax_is_return_code_zero
from pfrl_tpu_torch import agent as port_agent
from pfrl_tpu_torch import env as port_env
from pfrl_tpu_torch import experiments as texp
from pfrl_tpu_torch.envs import SerialVectorEnv
from pfrl_tpu_torch.utils.is_return_code_zero import is_return_code_zero

N_ACTIONS = 3


class ScriptEnv(port_env.Env):
    """Seeded numpy episodes: a wrong guess of ``int(10 * obs[0]) % 3``
    ends the episode (``done``) a third of the time, and every 7th step of
    an episode is a truncation (``info["needs_reset"]``)."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.t = 0
        self.obs = None

    def reset(self):
        self.t = 0
        self.obs = self.rs.normal(size=4).astype(np.float32)
        return self.obs

    def step(self, action):
        self.t += 1
        good = int(action) == int(abs(self.obs[0]) * 10) % N_ACTIONS
        self.obs = self.rs.normal(size=4).astype(np.float32)
        done = (not good) and self.rs.uniform() < 1 / 3
        info = {"needs_reset": True} if self.t % 7 == 0 and not done else {}
        return self.obs, float(good) + 0.25 * float(self.obs[1]), done, info


def scripted_agent(base):
    """A numpy agent on ``base`` (either package's ``BatchAgent``) that
    logs each call. It acts ``int(100 * |obs[0]|) % 3`` in training and
    ``int(10 * |obs[1]|) % 3`` in evaluation."""

    class Scripted(base):
        def __init__(self):
            self.log = []
            self.t = 0
            self.saves = []

        def batch_act(self, batch_obs):
            obs = np.asarray(batch_obs, np.float32)
            column, scale = (0, 100) if self.training else (1, 10)
            actions = (np.abs(obs[:, column]) * scale).astype(np.int64) % N_ACTIONS
            self.log.append(("act", self.training, obs.round(6).tolist(), actions.tolist()))
            return actions

        def batch_observe(self, batch_obs, batch_reward, batch_done, batch_reset):
            self.log.append(("observe", self.training, np.asarray(batch_obs, np.float32).round(6).tolist(),
                             np.asarray(batch_reward, np.float64).round(6).tolist(),
                             np.asarray(batch_done, bool).tolist(), np.asarray(batch_reset, bool).tolist()))
            if self.training:
                self.t += len(batch_reward)

        def get_statistics(self):
            return [("acts", float(sum(1 for e in self.log if e[0] == "act"))), ("t", self.t)]

        def save(self, dirname):
            os.makedirs(dirname, exist_ok=True)
            self.saves.append(os.path.basename(dirname))

        def load(self, dirname):
            pass

    return Scripted()


def _logging_vector_env(venv, log):
    reset = venv.reset

    def logged_reset(mask=None):
        log.append(("reset", None if mask is None else np.asarray(mask, bool).tolist()))
        return reset(mask)

    venv.reset = logged_reset
    return venv


def _step_hook(log):
    def hook(env, agent, step):
        log.append(("step_hook", step))
    return hook


def _eval_hook(log):
    def hook(env, agent, evaluator, step, eval_stats, agent_stats, env_stats):
        log.append(("eval_hook", step, sorted(eval_stats.items()), list(agent_stats)))
    return hook


def _scores(outdir):
    lines = open(os.path.join(outdir, "scores.txt")).read().splitlines()
    header = lines[0].split("\t")
    drop = header.index("elapsed")
    return header, [[v for i, v in enumerate(line.split("\t")) if i != drop] for line in lines[1:]]


def _assert_same_run(tdir, jdir, tagent, jagent, thist, jhist):
    assert tagent.log == jagent.log and len(tagent.log) > 100
    assert tagent.saves == jagent.saves
    assert thist == jhist and len(thist) >= 2
    assert _scores(tdir) == _scores(jdir)
    header = open(os.path.join(tdir, "scores.txt")).readline().split()
    assert header == ["steps", "episodes", "elapsed", "mean", "median", "stdev", "max", "min", "acts", "t"]


@pytest.mark.parametrize("eval_during_episode", [False, True])
def test_serial_driver_matches_jax(tmp_path, eval_during_episode):
    runs = {}
    for name, base, train in (("port", port_agent.BatchAgent, texp.train_agent_with_evaluation),
                              ("jax", jax_agent.BatchAgent, jexp.train_agent_with_evaluation)):
        agent, calls = scripted_agent(base), []
        agent.log = calls
        outdir = str(tmp_path / name)
        _, history = train(agent, ScriptEnv(1), steps=300, eval_n_steps=None, eval_n_episodes=4, eval_interval=70,
                           outdir=outdir, checkpoint_freq=100, train_max_episode_len=20, eval_env=ScriptEnv(2),
                           step_hooks=[_step_hook(calls)], evaluation_hooks=[_eval_hook(calls)],
                           eval_during_episode=eval_during_episode)
        runs[name] = (outdir, agent, history)
    (tdir, tagent, thist), (jdir, jagent, jhist) = runs["port"], runs["jax"]
    _assert_same_run(tdir, jdir, tagent, jagent, thist, jhist)
    assert "300_finish" in tagent.saves and "100_checkpoint" in tagent.saves and "best" in tagent.saves


def test_batch_driver_matches_jax(tmp_path):
    runs = {}
    for name, base, train, venv in (
        ("port", port_agent.BatchAgent, texp.train_agent_batch_with_evaluation, SerialVectorEnv),
        ("jax", jax_agent.BatchAgent, jexp.train_agent_batch_with_evaluation, JaxSerialVectorEnv),
    ):
        agent, calls = scripted_agent(base), []
        agent.log = calls
        outdir = str(tmp_path / name)
        env = _logging_vector_env(venv([ScriptEnv(10 + i) for i in range(3)]), calls)
        eval_env = _logging_vector_env(venv([ScriptEnv(20 + i) for i in range(3)]), calls)
        _, history = train(agent, env, steps=300, eval_n_steps=None, eval_n_episodes=5, eval_interval=60,
                           outdir=outdir, checkpoint_freq=90, max_episode_len=12, eval_env=eval_env, log_interval=30,
                           step_hooks=[_step_hook(calls)], evaluation_hooks=[_eval_hook(calls)])
        runs[name] = (outdir, agent, history)
    (tdir, tagent, thist), (jdir, jagent, jhist) = runs["port"], runs["jax"]
    _assert_same_run(tdir, jdir, tagent, jagent, thist, jhist)
    assert any(e[0] == "reset" and e[1] is not None and not all(e[1]) for e in tagent.log)


def test_successful_score_stops_both_drivers_alike(tmp_path):
    """The run stops at the first evaluation that reaches the score; the
    agent is saved as ``<t>_finish``."""
    out = {}
    for name, base, train in (("port", port_agent.BatchAgent, texp.train_agent_with_evaluation),
                              ("jax", jax_agent.BatchAgent, jexp.train_agent_with_evaluation)):
        agent = scripted_agent(base)
        _, history = train(agent, ScriptEnv(3), steps=10**6, eval_n_steps=None, eval_n_episodes=3,
                           eval_interval=40, outdir=str(tmp_path / name), eval_env=ScriptEnv(4),
                           successful_score=-100.0)
        out[name] = (agent.log, agent.saves, history)
    assert out["port"] == out["jax"]
    assert len(out["port"][2]) == 1 and out["port"][1][-1].endswith("_finish")


def test_a_failure_saves_the_agent_as_except_in_both(tmp_path):
    saves = {}
    for name, base, train in (("port", port_agent.BatchAgent, texp.train_agent),
                              ("jax", jax_agent.BatchAgent, jexp.train_agent)):
        agent = scripted_agent(base)

        def failing_hook(env, agent, step):
            if step == 13:
                raise RuntimeError("scripted failure")

        with pytest.raises(RuntimeError, match="scripted failure"):
            train(agent, ScriptEnv(5), steps=50, outdir=str(tmp_path / name), step_hooks=[failing_hook])
        saves[name] = agent.saves
    assert saves["port"] == saves["jax"] == ["13_except"]


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("n_steps,n_episodes", [(None, 5), (40, None)])
def test_evaluation_functions_match_jax(vector, n_steps, n_episodes):
    """``eval_performance`` over a host env or a vector env (the first
    ``n`` started episodes scored), by episodes or by steps."""
    stats = {}
    for name, base, exp, venv in (("port", port_agent.BatchAgent, texp, SerialVectorEnv),
                                  ("jax", jax_agent.BatchAgent, jexp, JaxSerialVectorEnv)):
        agent = scripted_agent(base)
        env = venv([ScriptEnv(30 + i) for i in range(3)]) if vector else ScriptEnv(30)
        stats[name] = (exp.eval_performance(env, agent, n_steps, n_episodes, max_episode_len=9), agent.log)
    assert stats["port"] == stats["jax"]
    assert stats["port"][0]["episodes"] >= (n_episodes or 1)


def test_evaluator_schedule_and_best_save_match_jax(tmp_path):
    """``evaluate_if_necessary`` from a step offset, the rows it writes and
    the ``best`` saves."""
    out = {}
    for name, base, exp in (("port", port_agent.BatchAgent, texp), ("jax", jax_agent.BatchAgent, jexp)):
        agent = scripted_agent(base)
        os.makedirs(tmp_path / name)
        evaluator = exp.Evaluator(agent, ScriptEnv(40), n_steps=None, n_episodes=3, eval_interval=50,
                                  outdir=str(tmp_path / name), step_offset=120)
        scores = [evaluator.evaluate_if_necessary(t, episodes=t // 10) for t in range(120, 400, 17)]
        out[name] = (scores, agent.saves, evaluator.prev_eval_t, evaluator.max_score)
    assert out["port"] == out["jax"]
    assert _scores(str(tmp_path / "port")) == _scores(str(tmp_path / "jax"))
    assert sum(s is not None for s in out["port"][0]) >= 4


def test_linear_interpolation_hook_matches_jax():
    seen = {"port": [], "jax": []}
    hooks = {
        "port": texp.LinearInterpolationHook(100, 1.0, 0.1, lambda env, agent, v: seen["port"].append(v)),
        "jax": jexp.LinearInterpolationHook(100, 1.0, 0.1, lambda env, agent, v: seen["jax"].append(v)),
    }
    for step in (0, 1, 37, 99, 100, 250):
        for name, hook in hooks.items():
            hook(None, None, step)
    assert seen["port"] == seen["jax"] and seen["port"][-1] == 0.1
    assert issubclass(texp.LinearInterpolationHook, texp.StepHook)
    assert texp.EvaluationHook.support_train_agent_batch and not texp.EvaluationHook.support_train_agent_async


def test_prepare_output_dir_matches_jax(tmp_path):
    args = {"env": "CartPole-v1", "seed": 3, "lr": 1e-3}
    made = {}
    for name, prepare in (("port", texp.prepare_output_dir), ("jax", jexp.prepare_output_dir)):
        made[name] = prepare(args, str(tmp_path / name), exp_id="run", argv=["train.py", "--seed", "3"])
    for name, outdir in made.items():
        assert outdir == str(tmp_path / name / "run") and os.path.isdir(outdir)
    tfiles, jfiles = sorted(os.listdir(made["port"])), sorted(os.listdir(made["jax"]))
    assert tfiles == jfiles and {"args.txt", "command.txt", "environ.txt"} <= set(tfiles)
    for f in ("args.txt", "command.txt"):
        assert open(os.path.join(made["port"], f)).read() == open(os.path.join(made["jax"], f)).read()
    assert ("git-head.txt" in tfiles) == is_return_code_zero(["git", "rev-parse"])


def test_is_return_code_zero_matches_jax():
    for args in (["true"], ["false"], ["no-such-command-anywhere"]):
        assert is_return_code_zero(args) == jax_is_return_code_zero(args)
    assert is_return_code_zero(["true"]) and not is_return_code_zero(["false"])
