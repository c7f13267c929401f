"""The learning-curve entry point, ``pfrl_tpu_torch/experiments/record_curves.py``,
against the JAX tool ``tools/record_curves.py`` on the CPU.

The JAX tool is imported as ``tests/test_record_curves_resume.py`` imports
it, with ``REPO`` monkeypatched to a temporary directory, so that nothing
is written into the tree. Its 21 recipes are run with ``_curve_loop`` and
``train_agent_with_evaluation`` replaced by recorders, which keep the
runner, the evaluator and the loop's arguments (or the agent, the envs and
the driver's arguments) and train nothing.

- (i) Each port recipe has the JAX recipe's settings: the loop's arguments,
  the lanes and ``RunnerConfig`` (or the rollout), the buffer's kind and
  its scalar settings, the evaluation's episodes and steps, the env's
  wrappers, the core's and the explorer's scalar settings, every optimizer
  (three steps of each package's on the same gradients, once with a global
  norm past every clip and once with gradients small enough that ``eps``
  shows; 1e-5 relative) and the whole train state's tree and shapes after
  ``convert.state_to_flax`` against the JAX state's, from ``jax.eval_shape``.
- (ii) ``ScoreWriter``'s header and row equal the JAX class's, ``elapsed``
  aside, for 1 and for 10 returns.
- (iii) A tiny deterministic ABC DQN runner (8 lanes, FC 8, a 512-slot
  ring, updates from 16, evaluations every 32 transitions) through the port's ``curve_loop`` and through the JAX
  ``_curve_loop``, from the port's converted initial parameters, the JAX
  runner under ``jax.disable_jit`` drawing the port's logged draws
  (``install_tape``): two evaluations with the same ``steps`` and
  ``episodes``, the return columns within 1e-6.
- (iv) The port's loop paused after an evaluation and resumed writes the
  rows and the zoo entry of the uninterrupted loop, ``elapsed`` aside; a
  resumed run whose later evaluations are worse keeps the best from before
  the pause.
- (v) The best checkpoint the port writes loads in the JAX package
  (``pfrl_tpu.replay.persistent.load_state``) into the tiny recipe's train
  state and into each device recipe's, leaf for leaf the port's values,
  and gives the port's greedy actions on the CPU.
- (vi) The entry point raises without a card unless given ``device="cpu"``,
  and writes only under its ``--outdir``.
"""

import dataclasses
import inspect
import json
import os
import shutil
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_value_modules import Tape, install_tape

import pfrl_tpu.experiments as jexperiments
from pfrl_tpu.agents import DQNCore as JaxDQN
from pfrl_tpu.envs import ABC as JaxABC
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
from pfrl_tpu.experiments import RunnerConfig as JaxConfig
from pfrl_tpu.explorers import ConstantEpsilonGreedy as JaxEps
from pfrl_tpu.q_functions import FCStateQFunctionWithDiscreteAction as JaxFC
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay.persistent import load_state as jax_load_state
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import DQNCore
from pfrl_tpu_torch.envs import ABC
from pfrl_tpu_torch.experiments import record_curves as rc
from pfrl_tpu_torch.experiments import zoo
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers import ConstantEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction
from pfrl_tpu_torch.replay import ReplayBuffer
from pfrl_tpu_torch.replay.persistent import load_state
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import record_curves as jrc  # noqa: E402  (tools/record_curves.py)

NAMES = list(jrc.RUNS)
DEVICE_NAMES = [n for n in NAMES if n != "reinforce_cartpole"]


# ------------------------------------------------------ the JAX recipes
class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_recipes(tmp_path_factory):
    """name -> the arguments each JAX recipe hands its loop or its driver."""
    captured = {}

    def curve_loop(name, runner, evaluator, **kwargs):
        captured[name] = dict(runner=runner, evaluator=evaluator, **kwargs)
        return 0.0

    def train_agent_with_evaluation(agent, env, **kwargs):
        captured["reinforce_cartpole"] = dict(agent=agent, env=env, **kwargs)
        raise _Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrc, "REPO", str(tmp_path_factory.mktemp("jax_tool")))
        mp.setattr(jrc, "_curve_loop", curve_loop)
        mp.setattr(jexperiments, "train_agent_with_evaluation", train_agent_with_evaluation)
        for name, recipe in jrc.RUNS.items():
            try:
                recipe()
            except _Stop:
                pass
    assert list(captured) == NAMES
    return captured


def _scalars(obj) -> dict:
    return {k: v for k, v in vars(obj).items()
            if not k.startswith("_") and isinstance(v, (bool, int, float, str, type(None)))}


def assert_same_scalars(jax_obj, port_obj, what: str, must=()) -> None:
    """Every scalar setting both objects name is equal; ``must`` are named."""
    a, b = _scalars(jax_obj), _scalars(port_obj)
    assert type(jax_obj).__name__ == type(port_obj).__name__, what
    assert set(must) <= set(a) & set(b), (what, set(must) - (set(a) & set(b)))
    diff = {k: (a[k], b[k]) for k in set(a) & set(b) if a[k] != b[k]}
    assert not diff, (what, diff)


def _dtype_name(dtype) -> str:
    return "float32" if dtype is None else str(getattr(dtype, "dtype", dtype)).replace("torch.", "")


def _env_chain(env) -> list:
    """Each wrapper's class name and scalar settings, outside in, to the
    single env (a vector env's ``num_envs`` aside)."""
    out = []
    while env is not None:
        if type(env).__name__ not in ("VectorJaxEnv", "VectorTorchEnv"):
            out.append((type(env).__name__, {k: v for k, v in _scalars(env).items() if k not in ("num_envs",)}))
        env = getattr(env, "env", None)
    return out


def assert_same_optimizer(jax_tx, port_opt, what: str) -> None:
    """Three steps from the same parameters on the same gradients, once with
    a global norm past every clip (~120) and once with gradients of 1e-4,
    where an optimizer's ``eps`` shows."""
    for scale in (30.0, 1e-4):
        rs = np.random.RandomState(0)
        shapes = [(3, 4), (4,)]
        start = [rs.normal(size=s).astype(np.float32) for s in shapes]
        jp, tp = [jnp.asarray(p) for p in start], [torch.tensor(p) for p in start]
        js, ts = jax_tx.init(jp), port_opt.init(tp)
        for _ in range(3):
            grads = [(rs.normal(size=s) * scale).astype(np.float32) for s in shapes]
            updates, js = jax_tx.update([jnp.asarray(g) for g in grads], js, jp)
            jp = optax.apply_updates(jp, updates)
            port_opt.update(tp, [torch.tensor(g) for g in grads], ts)
        for want, got in zip(jp, tp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9,
                                       err_msg=f"{what} at gradient scale {scale}")


def _optimizers(core) -> dict:
    return {k: v for k, v in vars(core).items() if isinstance(v, optax.GradientTransformation)}


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def assert_same_core(jcore, pcore, what: str) -> None:
    assert_same_scalars(jcore, pcore, what)
    dtypes = [_dtype_name(getattr(core, "compute_dtype", None)) for core in (jcore, pcore)]  # TRPO has none
    assert dtypes[0] == dtypes[1], (what, dtypes)
    explorer = getattr(jcore, "explorer", None)
    if explorer is not None:
        assert_same_scalars(explorer, pcore.explorer, f"{what} explorer")
    jopt = _optimizers(jcore)
    assert jopt, what
    for name, tx in jopt.items():
        assert_same_optimizer(tx, getattr(pcore, name), f"{what} {name}")


def assert_same_state_tree(jax_state, pcore, pstate, what: str) -> None:
    want = {k: tuple(np.shape(v)) for k, v in _flat(flax.serialization.to_state_dict(jax_state)).items()}
    got = {k: tuple(np.shape(v)) for k, v in _flat(convert.state_to_flax(pcore, pstate)).items()}
    assert got == want, (what, set(got) ^ set(want), {k: (got[k], want[k]) for k in got if got.get(k) != want.get(k)})


_SHAPES = {}


def jax_train_state_shapes(name, jax_runner):
    """The JAX recipe's initial train state, abstract (``jax.eval_shape``)."""
    if name not in _SHAPES:
        _SHAPES[name] = jax.eval_shape(jax_runner.init, jax.random.PRNGKey(0)).train_state
    return _SHAPES[name]


def _check_device_recipe(name, c):
    pc = rc.RUNS[name]("cpu")
    loop = dict(steps=pc.steps, eval_every=pc.eval_every, zoo_entry=pc.zoo_entry,
                successful_score=pc.successful_score, min_rows=pc.min_rows, seed=pc.seed)
    assert loop == {k: c.get(k, dict(successful_score=None, min_rows=1, seed=0).get(k)) for k in loop}, name
    chunk = c.get("run_chunk")
    assert pc.iters_per_eval == (None if chunk is None else inspect.getclosurevars(chunk).nonlocals["iters_per_eval"])
    jr, pr = c["runner"], pc.runner
    jev, pev = c["evaluator"], pc.evaluator
    assert (jev.env.num_envs, jev.max_steps) == (pev.env.num_envs, pev.max_steps), name
    assert _env_chain(jev.env) == _env_chain(pev.env), name
    assert _env_chain(jr.env) == _env_chain(pr.env), name
    if hasattr(jr, "config"):
        assert dataclasses.asdict(jr.config) == dataclasses.asdict(pr.config), name
        must = ("max_episodes", "max_episode_len", "subseq_len") if hasattr(jr.buffer, "max_episodes") else (
            "capacity", "num_steps", "gamma")
        assert_same_scalars(jr.buffer, pr.buffer, f"{name} buffer", must)
    else:
        assert (jr.num_envs, jr.rollout_len) == (pr.num_envs, pr.rollout_len), name
    assert_same_core(jr.core, pr.core, name)
    assert_same_state_tree(jax_train_state_shapes(name, jr), pr.core, pr.init(0).train_state, name)


def _check_host_recipe(c):
    pc = rc.RUNS["reinforce_cartpole"]("cpu")
    driver = {k: c[k] for k in ("steps", "eval_n_steps", "eval_n_episodes", "eval_interval", "successful_score",
                                "train_max_episode_len")}
    assert driver == dict(steps=pc.steps, eval_n_steps=None, eval_n_episodes=pc.eval_n_episodes,
                          eval_interval=pc.eval_interval, successful_score=pc.successful_score,
                          train_max_episode_len=pc.train_max_episode_len)
    assert os.path.basename(c["outdir"]) == "reinforce_cartpole" and pc.zoo_entry == ("reinforce", "cartpole")
    # HostJaxEnv keeps PRNGKey(seed) = [0, seed]; HostTorchEnv a generator seeded with it.
    jax_seeds = tuple(int(env._rng[1]) for env in (c["env"], c["eval_env"]))
    assert jax_seeds == (1, 2)
    for env, seed in zip((pc.env, pc.eval_env), jax_seeds):
        assert _env_chain(env.env) == _env_chain(c["env"].env)  # HostTorchEnv and HostJaxEnv over them
        assert torch.equal(env.draws.state_dict()["generator"], Draws(torch.Generator().manual_seed(seed))
                           .state_dict()["generator"])
    jagent, pagent = c["agent"], pc.agent
    assert (jagent.batchsize, jagent.max_episode_len) == (pagent.batchsize, pagent.max_episode_len)
    assert int(jagent.rng[1]) == pc.seed == pagent.seed == 0
    assert_same_core(jagent.core, pagent.core, "reinforce_cartpole")
    obs = torch.zeros((1, 4))
    assert_same_state_tree(jax.eval_shape(jagent.core.init, jax.random.PRNGKey(0), jnp.zeros((1, 4))),
                           pagent.core, pagent.core.init(torch.Generator().manual_seed(0), obs), "reinforce")


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", NAMES)
def test_recipe_settings_equal_the_jax_recipes(jax_recipes, name):
    assert list(rc.RUNS) == NAMES
    if name == "reinforce_cartpole":
        _check_host_recipe(jax_recipes[name])
    else:
        _check_device_recipe(name, jax_recipes[name])


@pytest.mark.parametrize("n", [1, 10])
def test_score_writer_writes_the_jax_header_and_row(tmp_path, n):
    returns = np.random.RandomState(n).normal(100.0, 30.0, n).astype(np.float32)
    lines = {}
    for key, cls in (("jax", jrc.ScoreWriter), ("port", rc.ScoreWriter)):
        writer = cls(str(tmp_path / key))
        mean = writer.record(1234, 56, returns)
        cls(str(tmp_path / key), resume=True).record(2345, 67, returns[:1])  # appends: no second header
        lines[key] = ((tmp_path / key / "scores.txt").read_text().splitlines(), mean)
    (jax_lines, jax_mean), (port_lines, port_mean) = lines["jax"], lines["port"]
    assert port_lines[0] == jax_lines[0] == "\t".join(rc.COLUMNS) and port_mean == jax_mean
    assert len(port_lines) == len(jax_lines) == 3
    for got, want in zip(port_lines[1:], jax_lines[1:]):
        got, want = got.split("\t"), want.split("\t")
        assert got[:2] + got[3:] == want[:2] + want[3:]
    if n == 1:
        assert port_lines[1].split("\t")[5] == "0.0"  # stdev of one return


# ------------------------------------------------------- the tiny loop
TINY_LANES, TINY_EVERY, TINY_START = 8, 32, 16


def tiny_port(eval_draws=None):
    env = ABC(discrete=True, episodic=True, deterministic=True, device="cpu")
    core = DQNCore(model=FCStateQFunctionWithDiscreteAction(env.n_dim_obs, 2, n_hidden_layers=1, n_hidden_channels=8),
                   optimizer=Adam(1e-2), explorer=ConstantEpsilonGreedy(0.3, 2), gamma=0.9)
    runner = OffPolicyRunner(env, core, ReplayBuffer(512, gamma=0.9, num_lanes=TINY_LANES, device="cpu"),
                             RunnerConfig(num_envs=TINY_LANES, replay_start_size=TINY_START, update_interval=8,
                                          target_update_interval=64, minibatch_size=8), device="cpu")
    return runner, EvalLoop(env, core, 4, 4, device="cpu")


def tiny_jax():
    env = JaxABC(discrete=True, episodic=True, deterministic=True)
    core = JaxDQN(model=JaxFC(n_actions=2, n_hidden_channels=8, n_hidden_layers=1), optimizer=optax.adam(1e-2),
                  explorer=JaxEps(0.3, 2), gamma=0.9)
    runner = JaxRunner(env, core, JaxReplay(512, gamma=0.9, num_lanes=TINY_LANES),
                       JaxConfig(num_envs=TINY_LANES, replay_start_size=TINY_START, update_interval=8,
                                 target_update_interval=64, minibatch_size=8))
    return runner, JaxEvalLoop(env, core, num_episodes=4, max_steps=4)


def _rows(path) -> list:
    """scores.txt's rows without ``elapsed``."""
    rows = [line.split("\t") for line in open(path).read().splitlines()[1:]]
    return [r[:2] + r[3:] for r in rows]


class SavedTape(Tape):
    """The logged draws, with the ``state_dict`` a runner snapshot needs."""

    def state_dict(self):
        return {}


def test_curve_loop_matches_the_jax_curve_loop_on_the_same_draws(tmp_path, monkeypatch):
    jrunner, jeval = tiny_jax()
    jtrain = jrunner.core.init(jax.random.PRNGKey(3), jnp.zeros((TINY_LANES, 4)))
    runner, evaluator = tiny_port()
    port_init = runner.init

    def init_from_jax(seed, draws=None):
        state = port_init(seed, draws=draws)
        state.train_state = convert.dqn_state_from_flax(
            runner.core, jax.device_get(jtrain.params), jax.device_get(jtrain.target_params),
            opt_state=jax.device_get(jtrain.opt_state), n_updates=0, device="cpu")
        return state

    runner.init = init_from_jax
    tape = SavedTape(0)
    got = rc.curve_loop("toy", runner, evaluator, steps=2 * TINY_EVERY, eval_every=TINY_EVERY,
                        outdir=str(tmp_path / "port"), draws=lambda seed: tape)
    assert got["rows"] == 2 and not got["paused"] and not (tmp_path / "port/toy/.resume").exists()

    start = jrunner.init(jax.random.PRNGKey(0)).replace(train_state=jtrain)  # before the tape: draws its own
    jrunner.init = lambda key: start
    monkeypatch.setattr(jrc, "REPO", str(tmp_path / "jax"))
    jitted = jax.jit(jrunner.core.update)

    def update(state, rng, batch):  # draws nothing: jitted inside the eager runner
        with jax.disable_jit(False):
            return jitted(state, rng, batch)

    jrunner.core.update = update
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jrc._curve_loop("toy", jrunner, jeval, steps=2 * TINY_EVERY, eval_every=TINY_EVERY)
    assert not tape.log  # every draw of the port's loop was the JAX loop's
    port_rows = _rows(tmp_path / "port/toy/scores.txt")
    jax_rows = _rows(tmp_path / "jax/benchmarks/curves/toy/scores.txt")
    assert [r[:2] for r in port_rows] == [r[:2] for r in jax_rows]
    assert [r[0] for r in port_rows] == [str(TINY_EVERY), str(2 * TINY_EVERY)] and int(port_rows[1][1]) > 0
    assert [float(r[2]) for r in port_rows] == [1.0, 0.0]  # the greedy agent solves the chain, then does not
    np.testing.assert_allclose(np.asarray(port_rows, float)[:, 2:], np.asarray(jax_rows, float)[:, 2:], rtol=0,
                               atol=1e-6)


def _tiny_loop(outdir, pause=None, evaluator=None):
    runner, ev = tiny_port()
    return rc.curve_loop("toy", runner, evaluator or ev, steps=4 * TINY_EVERY, eval_every=TINY_EVERY,
                         outdir=str(outdir), zoo_entry=("dqn", "toy"), seed=3, pause=pause), runner


def test_resumed_loop_writes_the_uninterrupted_rows_and_keeps_a_better_best(tmp_path):
    whole, _ = _tiny_loop(tmp_path / "whole")
    first, _ = _tiny_loop(tmp_path / "cut", pause=lambda n: n >= 2)
    assert first["paused"] and first["rows"] == 2 and (tmp_path / "cut/toy/.resume/runner_state.pt").exists()
    assert not (tmp_path / "cut/zoo").exists()
    rest, _ = _tiny_loop(tmp_path / "cut")
    assert not rest["paused"] and rest["rows"] == whole["rows"] == 4 and rest["t"] == whole["t"]
    assert _rows(tmp_path / "cut/toy/scores.txt") == _rows(tmp_path / "whole/toy/scores.txt")
    entry = "zoo/dqn/toy/best/train_state.msgpack"
    assert (tmp_path / "cut" / entry).read_bytes() == (tmp_path / "whole" / entry).read_bytes()
    assert not (tmp_path / "cut/toy/.resume").exists()

    class Scripted:  # the first evaluation is the best; those after the pause are worse
        means = iter([5.0, 1.0, 2.0, 3.0])

        def evaluate(self, train_state, draws):
            return np.full(4, next(self.means), np.float32)

    evaluator = Scripted()
    _tiny_loop(tmp_path / "best", pause=lambda n: n >= 1, evaluator=evaluator)
    with open(tmp_path / "best/toy/.resume/best.json") as f:
        assert json.load(f) == {"best": 5.0}
    shutil.copy(tmp_path / "best/toy/.resume/best_train_state.pt", tmp_path / "first_best.pt")
    out, runner = _tiny_loop(tmp_path / "best", evaluator=evaluator)
    assert out["best"] == 5.0 and out["last"] == 3.0
    first_state = load_state(runner.init(3).train_state, str(tmp_path / "first_best.pt"))
    want = convert.state_to_flax(runner.core, first_state)
    got = convert.state_to_flax(runner.core, convert.load_flax_checkpoint(runner.core, str(tmp_path / "best" / entry),
                                                                          device="cpu"))
    got = _flat(got)
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _jax_greedy(jcore, jstate, obs):
    return np.asarray(jcore.select_action(jstate, jax.random.PRNGKey(0), jnp.asarray(obs), 0, False))


def test_best_checkpoint_loads_in_the_jax_package(tmp_path, jax_recipes):
    out, runner = _tiny_loop(tmp_path)
    path = str(tmp_path / "zoo/dqn/toy/best/train_state.msgpack")
    jrunner, _ = tiny_jax()
    template = jrunner.core.init(jax.random.PRNGKey(0), jnp.zeros((TINY_LANES, 4)))
    restored = jax_load_state(template, path)
    port = convert.load_flax_checkpoint(runner.core, path, device="cpu")
    obs = np.random.RandomState(0).uniform(0, 1, (32, 4)).astype(np.float32)
    obs[np.arange(32), np.random.RandomState(1).randint(0, 3, 32)] = 1.0
    np.testing.assert_array_equal(zoo.greedy_actions(runner.core, port, torch.from_numpy(obs)).numpy(),
                                  _jax_greedy(jrunner.core, restored, obs))
    # Each device recipe's train state, written by the port, read by the JAX
    # package into the recipe's own state: the port's values, leaf for leaf.
    for name in DEVICE_NAMES:
        pc = rc.RUNS[name]("cpu")
        state = pc.runner.init(0).train_state
        entry = rc.save_zoo(pc.runner.core, state, *pc.zoo_entry, root=str(tmp_path / "recipes"))
        jr = jax_recipes[name]["runner"]
        shapes = jax_train_state_shapes(name, jr)
        template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        got = _flat(flax.serialization.to_state_dict(jax_load_state(template, os.path.join(entry,
                                                                                           "train_state.msgpack"))))
        want = _flat(convert.state_to_flax(pc.runner.core, state))
        assert set(got) == set(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=f"{name} {k}")
        if name in ("dqn_cartpole", "c51_cartpole", "al_cartpole"):
            obs = zoo.observations(name.replace("_cartpole", "/cartpole"), 64, 0)
            np.testing.assert_array_equal(
                zoo.greedy_actions(pc.runner.core, state, torch.from_numpy(obs)).numpy(),
                _jax_greedy(jr.core, jax_load_state(template, os.path.join(entry, "train_state.msgpack")), obs),
                err_msg=name)


def test_entry_point_needs_a_card_and_writes_only_under_its_outdir(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rc.main(["rppo_delayed_cue"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rc.run("acer_abc")
    with pytest.raises(SystemExit):
        rc.main(["no_such_recipe"], device="cpu")
    before = {d: sorted(os.walk(os.path.join(REPO, d))) for d in ("benchmarks", "zoo")}
    monkeypatch.chdir(tmp_path)
    out = rc.run("rppo_delayed_cue", rc.DEFAULT_OUTDIR, "cpu", seed=5, pause=lambda n: n >= 1)
    assert out["paused"] and out["rows"] == 1 and out["seed"] == 5 and out["t"] == 16 * 24
    assert out["steps"] == 120_000 and out["zoo_entry"] == ["rppo", "delayed_cue"]
    assert os.listdir(tmp_path) == ["results"]
    assert sorted(os.listdir(tmp_path / rc.DEFAULT_OUTDIR / "rppo_delayed_cue")) == [".resume", "scores.txt"]
    assert {d: sorted(os.walk(os.path.join(REPO, d))) for d in ("benchmarks", "zoo")} == before
