"""Every script of ``examples/`` through the port's command line.

- Flags: each example's ``ArgumentParser`` (caught by replacing
  ``parse_args`` while the script runs as ``__main__``) against the port
  module's, run the same way with ``runpy.run_module``, as ``python -m
  pfrl_tpu_torch.experiments.<module>`` runs it: every flag of the example
  with the same default, type, action and choices.
- Recipes: each new or extended command line run with its driver or loop
  replaced builds what the example's ``main`` builds (lanes, capacities,
  intervals, modes), on the CPU.
- The ALE refusals of the three ``--sim``-only scripts and optuna's
  refusal carry the examples' messages; IQN without ``--sim`` runs AtariSim.
- ``optuna_dqn_cartpole.objective`` with a stand-in trial reports what the
  JAX example's ``objective`` reports on the same draws.
"""

import argparse
import glob
import os
import runpy
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# examples/<script> -> (port module, the words before the example's flags)
SCRIPTS = {
    "atari/reproduction/a3c/train_a3c.py": ("atari_a3c", ()),
    "atari/reproduction/dqn/train_dqn.py": ("atari_dqn_reproduction", ()),
    "atari/reproduction/iqn/train_iqn.py": ("atari_iqn", ()),
    "atari/reproduction/rainbow/train_rainbow.py": ("atari_rainbow", ()),
    "atari/train_a2c_ale.py": ("atari_onpolicy_ale", ("a2c",)),
    "atari/train_acer_ale.py": ("acer", ()),
    "atari/train_categorical_dqn_ale.py": ("atari_c51", ()),
    "atari/train_dqn_ale.py": ("atari_dqn_ale", ()),
    "atari/train_dqn_batch_ale.py": ("atari_dqn_batch", ()),
    "atari/train_dqn_pipeline_ale.py": ("atari_pipeline", ()),
    "atari/train_drqn_ale.py": ("recurrent", ()),
    "atari/train_ppo_ale.py": ("atari_onpolicy_ale", ("ppo",)),
    "atlas/train_soft_actor_critic_atlas.py": ("sac_atlas", ()),
    "grasping/train_dqn_batch_grasping.py": ("grasping_dqn_batch", ()),
    "gym/train_categorical_dqn_gym.py": ("categorical_dqn_gym", ()),
    "gym/train_dqn_cartpole.py": ("cartpole_value", ()),
    "gym/train_dqn_gym.py": ("dqn_gym", ()),
    "gym/train_ppo_pendulum.py": ("ppo_pendulum", ()),
    "gym/train_reinforce_gym.py": ("reinforce_gym", ()),
    "mujoco/reproduction/ddpg/train_ddpg.py": ("mujoco_host", ("ddpg",)),
    "mujoco/reproduction/ppo/train_ppo.py": ("mujoco_host", ("ppo",)),
    "mujoco/reproduction/soft_actor_critic/train_soft_actor_critic.py": ("mujoco_host", ("sac",)),
    "mujoco/reproduction/td3/train_td3.py": ("mujoco_host", ("td3",)),
    "mujoco/reproduction/trpo/train_trpo.py": ("mujoco_host", ("trpo",)),
    "optuna/optuna_dqn_cartpole.py": ("optuna_dqn_cartpole", ()),
    "quickstart/quickstart.py": ("quickstart", ()),
    "slimevolley/train_rainbow.py": ("slimevolley_rainbow", ()),
}
# A flag the port has beyond its example's: the PPO script's host Pendulum,
# whose --jax-env means the device runner there.
PORT_ONLY = {"mujoco/reproduction/ppo/train_ppo.py": {"--torch-env"}}


class Caught(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _catching(monkeypatch):
    def parse_args(self, args=None, namespace=None):
        raise Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    # Neither this machine nor the card's has optuna: the examples import it
    # before they build their parser.
    monkeypatch.setitem(sys.modules, "optuna", types.ModuleType("optuna"))


def example_parser(script, monkeypatch):
    """``examples/<script>``'s parser, caught as its ``__main__`` parses."""
    _catching(monkeypatch)
    monkeypatch.setattr(sys, "argv", [script])
    with pytest.raises(Caught) as caught:
        runpy.run_path(os.path.join(REPO, "examples", script), run_name="__main__")
    return caught.value.parser


def port_parser(module, words, monkeypatch):
    """The parser that ``python -m pfrl_tpu_torch.experiments.<module>
    <words>`` parses its flags with."""
    _catching(monkeypatch)
    monkeypatch.setattr(sys, "argv", [module, *words])
    with pytest.raises(Caught) as caught:
        runpy.run_module(f"pfrl_tpu_torch.experiments.{module}", run_name="__main__", alter_sys=True)
    return caught.value.parser


def _flags(parser):
    return {a.option_strings[0] if a.option_strings else a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def _describe(action):
    return (type(action).__name__, action.default, action.type, action.nargs,
            None if action.choices is None else list(action.choices), action.const)


def test_every_example_has_a_port_module():
    found = {os.path.relpath(p, os.path.join(REPO, "examples"))
             for p in glob.glob(os.path.join(REPO, "examples", "**", "*.py"), recursive=True)}
    assert found == set(SCRIPTS) and len(found) == 27


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_parser_has_the_examples_flags(script, monkeypatch):
    want = _flags(example_parser(script, monkeypatch))
    module, words = SCRIPTS[script]
    got = {}
    for action in _flags(port_parser(module, words, monkeypatch)).values():
        for option in action.option_strings:
            got[option] = action
    assert want, script
    for flag, action in want.items():
        assert flag in got, f"{script}: {flag} missing"
        assert _describe(got[flag]) == _describe(action), (script, flag)
    extra = {a.option_strings[0] for a in got.values() if not set(a.option_strings) & set(want)}
    assert extra <= PORT_ONLY.get(script, set()), (script, extra)


# ------------------------------------------------ recipes of the device loops
class Kept(Exception):
    pass


ATTRS = {
    "config": ("num_envs", "replay_start_size", "update_interval", "n_times_update", "target_update_interval",
               "minibatch_size"),
    "buffer": ("capacity", "num_lanes", "store_next_obs", "gamma", "num_steps", "alpha", "beta0", "beta_add", "eps",
               "tree_capacity", "max_episodes", "max_episode_len", "subseq_len", "fused_dequant_scale"),
    "core": ("gamma", "batch_accumulator", "beta", "epochs", "minibatch_size", "use_gae", "tau", "clip_eps",
             "entropy_coef", "entropy_coeff", "v_loss_coef", "lambd", "burn_in", "truncation_threshold",
             "trust_region_delta", "use_trust_region", "quantile_thresholds_N", "quantile_thresholds_N_prime",
             "quantile_thresholds_K", "standardize_advantages", "max_grad_norm"),
    "explorer": ("start_epsilon", "end_epsilon", "decay_steps", "epsilon", "n_actions"),
    "env": ("n_actions", "frame_shape", "mean_episode_len", "max_episode_steps"),
    "runner": ("num_envs", "rollout_len"),
}


def _same_attrs(kind, got, want, where):
    shared = [n for n in ATTRS[kind] if hasattr(got, n) and hasattr(want, n)]
    for name in shared:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, float) or isinstance(g, float):
            assert g == pytest.approx(float(w), rel=1e-7), (where, kind, name, g, w)
        else:
            assert g == w, (where, kind, name, g, w)
    return shared


def _catch_runners(monkeypatch, store):
    """Both packages' runners keep themselves at ``init`` and raise: the
    recipe is built, nothing is allocated; the port's evaluation loops are
    kept as they are built."""
    import pfrl_tpu.experiments as jexperiments
    from pfrl_tpu_torch.experiments import onpolicy_runner, runner

    def keep(side):
        def init(self, *args, **kwargs):
            store[side] = self
            raise Kept

        return init

    for cls in (jexperiments.OffPolicyRunner, jexperiments.OnPolicyRunner):
        monkeypatch.setattr(cls, "init", keep("jax"))
    for cls in (runner.OffPolicyRunner, onpolicy_runner.OnPolicyRunner):
        monkeypatch.setattr(cls, "init", keep("port"))
    built = runner.EvalLoop.__init__

    def eval_init(self, env, core, num_episodes, max_steps, *args, **kwargs):
        built(self, env, core, num_episodes, max_steps, *args, **kwargs)
        store["eval"] = (num_episodes, max_steps)

    monkeypatch.setattr(runner.EvalLoop, "__init__", eval_init)


def _jax_env(runner):
    return runner.env.env


# script -> (argv, the port's call, the evaluation loop (episodes, steps))
DEVICE_LOOPS = {
    "atari/reproduction/dqn/train_dqn.py": (["--sim"], "atari_dqn_reproduction", (5, 500)),
    "atari/reproduction/rainbow/train_rainbow.py": (["--sim"], "atari_rainbow", (5, 500)),
    "atari/reproduction/iqn/train_iqn.py": ([], "atari_iqn", (5, 500)),
    "atari/reproduction/a3c/train_a3c.py": (["--sim"], "atari_a3c", (5, 500)),
    "atari/train_a2c_ale.py": (["--sim", "--use-gae", "--lr", "1e-3"], ("atari_onpolicy_ale", "a2c"), (5, 500)),
    "atari/train_ppo_ale.py": (["--sim", "--bf16"], ("atari_onpolicy_ale", "ppo"), (5, 500)),
    "atari/train_acer_ale.py": (["--sim", "--t-max", "40", "--beta", "0.02"], "acer", (5, 500)),
    "atari/train_categorical_dqn_ale.py": (["--sim", "--n-atoms", "41", "--batch-size", "16"], "atari_c51",
                                           (5, 500)),
    "atari/train_drqn_ale.py": (["--sim", "--burn-in", "4", "--episodic-update-len", "16"], "recurrent", (5, 500)),
    "gym/train_dqn_cartpole.py": (["--gamma", "0.95", "--update-per", "16"], "cartpole_value", (16, 500)),
    "mujoco/reproduction/ppo/train_ppo.py": (["--jax-env", "pendulum", "--num-envs", "32"], ("mujoco_host", "ppo"),
                                             (10, 200)),
}


def _port_call(target, argv):
    import importlib

    module, word = (target, None) if isinstance(target, str) else target
    mod = importlib.import_module(f"pfrl_tpu_torch.experiments.{module}")
    fn = {"a2c": "run_a2c_ale", "ppo": "run_ppo_ale" if module == "atari_onpolicy_ale" else "run_ppo",
          None: "run"}[word]
    return getattr(mod, fn)(argv, device="cpu")


@pytest.mark.parametrize("script", sorted(DEVICE_LOOPS))
def test_device_command_line_builds_the_examples_recipe(script, monkeypatch):
    import torch

    argv, target, evaluation = DEVICE_LOOPS[script]
    store = {}
    _catch_runners(monkeypatch, store)
    monkeypatch.setattr(sys, "argv", [script, *argv])
    with pytest.raises(Kept):
        runpy.run_path(os.path.join(REPO, "examples", script), run_name="__main__")
    with pytest.raises(Kept):
        _port_call(target, argv)
    jrunner, trunner = store["jax"], store["port"]
    assert type(trunner).__name__ == type(jrunner).__name__
    assert type(trunner.core).__name__ == type(jrunner.core).__name__
    if hasattr(jrunner.core, "explorer"):
        assert type(trunner.core.explorer).__name__ == type(jrunner.core.explorer).__name__
        _same_attrs("explorer", trunner.core.explorer, jrunner.core.explorer, script)
    env, jenv = trunner.env.env, _jax_env(jrunner)
    assert type(env).__name__ == type(jenv).__name__
    assert _same_attrs("env", env, jenv, script)
    _same_attrs("core", trunner.core, jrunner.core, script)
    if hasattr(jrunner, "config"):
        assert _same_attrs("config", trunner.config, jrunner.config, script)
        assert type(trunner.buffer).__name__ == type(jrunner.buffer).__name__
        assert len(_same_attrs("buffer", trunner.buffer, jrunner.buffer, script)) >= 3
    else:
        assert _same_attrs("runner", trunner, jrunner, script) == ["num_envs", "rollout_len"]
    assert trunner.env.num_envs == jrunner.env.num_envs
    assert store["eval"] == evaluation
    want_dtype = torch.bfloat16 if "--bf16" in argv else None
    assert getattr(trunner.core, "compute_dtype", None) == want_dtype
    if "--lr" in argv:
        optimizer = trunner.core.optimizer
        assert getattr(optimizer, "inner", optimizer).learning_rate == float(argv[argv.index("--lr") + 1])


# ------------------------------------------------------- the host commands
def _load_example(script):
    import importlib.util

    spec = importlib.util.spec_from_file_location("example_" + os.path.basename(script)[:-3],
                                                  os.path.join(REPO, "examples", script))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mode", [[], ["--actor-learner"], ["--multihost", "localhost:1"]])
def test_dqn_batch_command_line_dispatches_as_the_example(mode, monkeypatch):
    from pfrl_tpu_torch.experiments import atari_dqn_batch

    script = "atari/train_dqn_batch_ale.py"
    argv = [*mode, "--env", "PongNoFrameskip-v4", "--steps", "777", "--num-envs", "4", "--eval-interval", "99",
            "--replay-start-size", "55", "--lr", "1e-3", "--outdir", "somewhere", "--bf16"]
    example, got = _load_example(script), {}
    for name in ("run_batch", "run_actor_learner", "run_multihost"):
        monkeypatch.setattr(example, name, lambda args, name=name: got.setdefault("jax", (name, args)))
        monkeypatch.setattr(atari_dqn_batch, name, lambda *a, name=name, **kw: got.setdefault("port", (name, a, kw)))
    monkeypatch.setattr(sys, "argv", [script, *argv])
    example.main()
    atari_dqn_batch.run(argv, device="cpu")
    (jname, args), (name, pargs, kwargs) = got["jax"], got["port"]
    assert name == jname
    if name == "run_multihost":
        assert pargs == (argv, "cpu")
        return
    import torch

    assert kwargs.pop("make_env") is None
    assert kwargs.pop("load", None) is None and kwargs.pop("demo", False) is False
    assert kwargs == dict(
        outdir=args.outdir, steps=args.steps, eval_interval=args.eval_interval, num_envs=args.num_envs,
        seed=args.seed, device="cpu", env_id=args.env, capacity=args.replay_capacity,
        replay_start_size=args.replay_start_size, update_interval=args.update_interval,
        target_update_interval=args.target_update_interval, minibatch_size=args.batch_size, lr=args.lr,
        compute_dtype=torch.bfloat16)


def _keep_driver(store):
    def driver(*args, **kwargs):
        store.update(kwargs, args=args)
        raise Kept

    return driver


def test_reinforce_command_line_trains_as_the_example(monkeypatch, tmp_path):
    import importlib

    import pfrl_tpu.experiments as jexperiments

    from pfrl_tpu_torch.experiments import reinforce_gym

    train_agent = importlib.import_module("pfrl_tpu_torch.experiments.train_agent")

    script = "gym/train_reinforce_gym.py"
    argv = ["--steps", "321", "--batchsize", "3", "--beta", "0.01", "--eval-n-runs", "4", "--eval-interval", "50",
            "--outdir", str(tmp_path)]
    jstore, tstore = {}, {}
    monkeypatch.setattr(jexperiments, "train_agent_with_evaluation", _keep_driver(jstore))
    monkeypatch.setattr(train_agent, "train_agent_with_evaluation", _keep_driver(tstore))
    monkeypatch.setattr(sys, "argv", [script, *argv])
    with pytest.raises(Kept):
        _load_example(script).main()
    with pytest.raises(Kept):
        reinforce_gym.run(argv, device="cpu")
    jagent, agent = jstore.pop("agent"), tstore.pop("agent")
    for name in ("batchsize", "max_episode_len"):
        assert getattr(agent, name) == getattr(jagent, name), name
    for name in ("beta", "gamma", "baseline"):
        assert getattr(agent.core, name) == getattr(jagent.core, name), name
    jenv, env = jstore.pop("env"), tstore.pop("env")
    assert env.observation_space.shape == jenv.observation_space.shape and env.action_space.n == jenv.action_space.n
    for store in (jstore, tstore):
        store.pop("eval_env")
        assert os.path.dirname(store.pop("outdir")) == str(tmp_path)
    assert tstore == jstore == dict(steps=321, eval_n_steps=None, eval_n_episodes=4, eval_interval=50,
                                    train_max_episode_len=500, args=())


@pytest.mark.parametrize("script,module", [("atari/train_acer_ale.py", "acer"),
                                           ("atari/train_categorical_dqn_ale.py", "atari_c51"),
                                           ("atari/train_drqn_ale.py", "recurrent"),
                                           ("optuna/optuna_dqn_cartpole.py", "optuna_dqn_cartpole")])
def test_refusals_carry_the_examples_messages(script, module, monkeypatch):
    import importlib

    monkeypatch.setitem(sys.modules, "optuna", None)  # not installed, here or on the card
    monkeypatch.setattr(sys, "argv", [script])
    with pytest.raises(SystemExit) as want:
        _load_example(script).main()
    with pytest.raises(SystemExit) as got:
        importlib.import_module(f"pfrl_tpu_torch.experiments.{module}").run([], device="cpu")
    assert str(got.value) == str(want.value) and ("ALE" in str(want.value) or "optuna" in str(want.value))


def test_flagship_command_line_trains_saves_and_demos_a_loaded_state(tmp_path, capsys):
    """``train_dqn.py --sim`` small on the CPU: it stops at the first turn
    past ``--steps``, its updates ran, and ``--load --demo`` evaluates the
    saved state."""
    import torch

    from pfrl_tpu_torch.experiments import atari_dqn_reproduction

    small = ["--sim", "--num-envs", "4", "--replay-capacity", "256", "--replay-start-size", "16",
             "--target-update-interval", "24"]
    out = atari_dqn_reproduction.run(small + ["--steps", "40", "--save-to", str(tmp_path)], device="cpu", chunk=3)
    state = out["state"]
    assert state.t == 48 and out["turns"] == 4 and state.train_state.n_updates == 9
    loaded = atari_dqn_reproduction.run(small + ["--load", str(tmp_path), "--demo"], device="cpu")
    for name, p in state.train_state.model.named_parameters():
        assert torch.equal(p, dict(loaded["state"].train_state.model.named_parameters())[name]), name
    assert loaded["demo_returns"].shape == (5,) and "n_episodes: 5" in capsys.readouterr().out


# ------------------------------------------------------------ optuna
class StandInTrial:
    """What ``objective`` asks of an optuna trial: fixed suggestions, the
    reports kept, never pruned."""

    def __init__(self, number, values):
        self.number, self.values, self.reports = number, values, []

    def suggest_float(self, name, low, high, log=False):
        assert low <= self.values[name] <= high
        return self.values[name]

    def suggest_categorical(self, name, choices):
        assert self.values[name] in choices
        return self.values[name]

    suggest_int = suggest_float

    def report(self, value, step):
        self.reports.append((float(value), int(step)))

    def should_prune(self):
        return False


SUGGESTED = dict(lr=1e-3, n_hidden_channels=32, n_hidden_layers=1, update_per=32, final_epsilon=0.05, gamma=0.99)
# 5 reports of 2 scan steps of 32 lanes (before the replay start of 1,024:
# eager JAX takes ~0.15 s a step), evaluations cut to 15 steps on both sides (the
# untrained greedy policy's episodes end in about 9).
OBJECTIVE_STEPS, EVAL_STEPS = 320, 15


def test_objective_reports_what_the_examples_objective_reports_on_the_same_draws(monkeypatch):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from flax.core import FrozenDict
    from test_torch_cartpole_value_slice import TapeEnv, port_state
    from test_torch_value_modules import Tape, install_tape

    from pfrl_tpu.experiments import JaxEvalLoop
    from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
    from pfrl_tpu.experiments.runner import RunnerState as JaxRunnerState
    from pfrl_tpu.replay import Transition as JaxTransition
    from pfrl_tpu_torch.experiments import optuna_dqn_cartpole as port

    example = _load_example("optuna/optuna_dqn_cartpole.py")
    args = types.SimpleNamespace(steps=OBJECTIVE_STEPS, bf16=False)

    jcore = None

    class CoreKept(JaxRunner):
        def __init__(self, env, core, *rest, **kw):
            nonlocal jcore
            jcore = core
            raise Kept

    monkeypatch.setattr(example, "OffPolicyRunner", CoreKept)
    with pytest.raises(Kept):
        example.objective(StandInTrial(3, SUGGESTED), args)
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((port.NUM_ENVS, 4)))

    class ConvertedRunner(port.OffPolicyRunner):
        def init(self, seed, draws=None):
            state = super().init(seed, draws=draws)
            state.train_state = port_state(self.core, jtrain)
            return state

    tape = Tape(0)
    monkeypatch.setattr(port, "OffPolicyRunner", ConvertedRunner)
    monkeypatch.setattr(port, "EVAL_STEPS", EVAL_STEPS)
    trial = StandInTrial(3, SUGGESTED)
    score = port.objective(trial, args, device="cpu", draws=tape)

    class TapeRunner(JaxRunner):
        def __init__(self, env, core, buffer, config, **kw):
            super().__init__(env, core, buffer, config, **kw)
            self.env = TapeEnv(env, config.num_envs, tape)

        def init(self, key):
            env_states, obs = self.env.reset(None)
            example_t = JaxTransition(obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()),
                                      next_obs=obs[0], terminated=jnp.zeros((), bool), done=jnp.zeros((), bool),
                                      extras=FrozenDict())
            return JaxRunnerState(
                env_states=env_states, obs=obs, train_state=jtrain, replay_state=self.buffer.init(example_t),
                rng=jnp.zeros((2,), jnp.uint32), t=jnp.int32(0), episode_return=jnp.zeros(self.env.num_envs),
                recent_returns=jnp.zeros(self.return_window), recent_count=jnp.int32(0))

    class TapeEvalLoop(JaxEvalLoop):
        def __init__(self, env, core, num_episodes, max_steps):
            super().__init__(env, core, num_episodes=num_episodes, max_steps=EVAL_STEPS)
            self.env = TapeEnv(env, num_episodes, tape)

    monkeypatch.setattr(example, "OffPolicyRunner", TapeRunner)
    monkeypatch.setattr(example, "JaxEvalLoop", TapeEvalLoop)
    jtrial = StandInTrial(3, SUGGESTED)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jscore = example.objective(jtrial, args)
    assert not tape.log  # every draw the port made was replayed
    assert [t for _, t in trial.reports] == [t for _, t in jtrial.reports] == [64, 128, 192, 256, 320]
    np.testing.assert_array_equal([v for v, _ in trial.reports], [v for v, _ in jtrial.reports])
    assert score == float(jscore) == trial.reports[-1][0] > 0
