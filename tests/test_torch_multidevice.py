"""The port's multi-device path on the CPU: ``parallel/mesh.py``,
``parallel/data_parallel.py``, ``parallel/multihost.py`` and the runners'
mesh branches, over Gloo.

- In this process, a group of one rank: ``local_lane_slice``,
  ``is_primary``, ``make_mesh``, ``shard_batch``, ``replicate``,
  ``all_gather``, ``pmean_grads`` and ``data_parallel_update``; and the
  runners with a mesh of one rank equal the runners without one to the
  bit (DQN-CartPole over the uniform ring and over 3-step PER, PPO on
  MujocoSim). The group is torn down after each test.
- Two spawned Gloo ranks (``tests/torch_mesh_worker.py``, each process
  under its own 240 s timeout, so that a hang fails the test and not the
  suite) run the same three configurations: 4 lanes split 2 + 2, a 40-slot
  ring that wraps, batch 8 split 4 + 4, 18 updates and a target sync at
  24 (PPO: 3 iterations of 64 transitions, 2 epochs of batch 16 split 8 +
  8, 24 Adam steps). The ranks' weights, optimizer moments, PER trees and
  beta are **equal to the bit**; each rank's ring rows equal the rows of
  its lanes in the single-process run, and the observations of both
  ranks, side by side, equal its observations (so every draw is global).
  Weights and moments lie within 2e-6 of the single-process port run: the
  mean of two half-batch gradients rounds apart from the mean over the
  whole batch, and Adam's steps carry that (ROADMAP C22; measured 1.6e-7).
  They lie within 2e-5 of the JAX package's runner with
  ``make_mesh(("dp",), (2,))`` over two of the virtual CPU devices of
  ``conftest.py``, on the port's draws (the tolerance of the
  single-device runner tests over as many updates: C22, and CartPole's
  ``sin``/``cos`` an ulp apart, C28): the JAX off-policy runner under
  ``jax.disable_jit`` with ``install_tape``, its state placed by its own
  ``_state_shardings``; the JAX on-policy runner jitted with its shardings
  and a ``ScriptedKey``.
"""

import copy
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax.core import FrozenDict
from test_torch_actor_critic_modules import np_tree
from test_torch_cartpole_value_slice import TapeEnv, jax_core, port_state
from test_torch_onpolicy_slice import ScriptedKey, _reset_keys, _setup, install_scripted_keys
from test_torch_sac import assert_network
from test_torch_value_modules import install_tape
from torch_mesh_worker import (BATCH, CAPACITY, DECAY, HIDDEN, ITERATIONS, LANES, LIMIT, PER, PPO_ROLLOUT, START,
                               STEPS, SYNC_EVERY, NumpyDraws, build, run)

from pfrl_tpu import envs as jenvs
from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
from pfrl_tpu.experiments import RunnerConfig as JaxConfig
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunner as JaxOnPolicyRunner
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunnerState as JaxOnPolicyState
from pfrl_tpu.experiments.runner import RunnerState as JaxRunnerState
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.parallel import make_mesh as jax_make_mesh
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.parallel.data_parallel import (AllReduceGradients, data_parallel_core, data_parallel_update,
                                                   pmean_grads)
from pfrl_tpu_torch.parallel.mesh import all_gather, all_gather_rows, make_mesh, replicate, shard_batch
from pfrl_tpu_torch.parallel.multihost import global_mesh, initialize_multihost, is_primary, local_lane_slice, shutdown
from pfrl_tpu_torch.utils.draws import per_parameter, per_row

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
SCENARIOS = ("uniform", "per", "ppo")
RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank():
    """A Gloo group of one rank in this process, torn down after the test."""
    initialize_multihost(f"localhost:{_free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        yield make_mesh(("dp",))
    finally:
        shutdown()


# ------------------------------------------------------------ one process
def test_lane_slice_and_primary_without_a_group():
    assert not dist.is_initialized()
    assert is_primary() and local_lane_slice(8) == slice(0, 8)
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(("dp",))
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(None, 2, 0, device="cpu")


def test_the_environment_names_the_job(monkeypatch):
    monkeypatch.setenv("PFRL_TPU_COORDINATOR", f"localhost:{_free_port()}")
    monkeypatch.setenv("PFRL_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("PFRL_TPU_PROCESS_ID", "0")
    try:
        assert initialize_multihost(device="cpu") == torch.device("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = global_mesh()
        assert (mesh.axis_names, mesh.shape, mesh.rank, mesh.size) == (("dp",), (1,), 0, 1)
    finally:
        shutdown()


def test_mesh_helpers_over_one_rank(one_rank):
    mesh = one_rank
    assert is_primary() and local_lane_slice(6) == slice(0, 6)
    assert make_mesh(("dp", "mp"), (1, 1)).shape == (1, 1)
    with pytest.raises(ValueError, match="shape"):
        make_mesh(("dp",), (2,))
    batch = {"x": torch.arange(6.0).reshape(3, 2), "flag": torch.tensor([True, False, True]), "n": 3}
    share = shard_batch(mesh, batch)
    assert torch.equal(share["x"], batch["x"]) and share["n"] == 3
    gathered = all_gather(mesh, batch["flag"])
    assert gathered.dtype == torch.bool and torch.equal(gathered[0], batch["flag"])
    assert torch.equal(all_gather_rows(mesh, batch)["x"], batch["x"])
    module = torch.nn.Linear(3, 2)
    before = [p.detach().clone() for p in module.parameters()]
    assert replicate(mesh, {"m": module})["m"] is module
    assert all(torch.equal(a, b) for a, b in zip(before, module.parameters()))
    grads = [torch.randn(3, generator=torch.Generator().manual_seed(0))]
    assert torch.equal(pmean_grads(grads, mesh)[0], grads[0])
    assert torch.equal(pmean_grads(grads, mesh, "sum")[0], grads[0])
    with pytest.raises(ValueError):
        pmean_grads(grads, mesh, "max")


def test_data_parallel_update_reduces_the_metrics_and_refuses_draws(one_rank):
    mesh = one_rank
    runner = build("uniform", None)
    core = data_parallel_core(runner.core, mesh)
    assert isinstance(core.optimizer, AllReduceGradients) and core.optimizer.op == "mean"
    assert core.mesh is mesh and not isinstance(runner.core.optimizer, AllReduceGradients)
    core.batch_accumulator = "sum"
    assert data_parallel_core(core, mesh).optimizer.op == "sum"

    seen = {}

    def update(state, batch, draws):
        # A flat draw that names no kind is refused; a per-row and a
        # per-parameter draw are drawn whole from the shared source.
        seen["rows"] = batch.reward.shape[0]
        with pytest.raises(TypeError, match="in a data-parallel update names no kind"):
            draws.uniform(3)
        seen["row"] = per_row(draws, "uniform", (4, 2))
        seen["param"] = per_parameter(draws, "normal", 3)
        return state, {"loss": batch.reward.sum(), "errors": batch.reward * 2, "count": 7}

    batch = type("Batch", (), {})()
    batch.reward = torch.arange(4.0)
    wrapped = data_parallel_update(mesh, update)
    _, aux = wrapped(None, batch, NumpyDraws(3))
    assert seen["rows"] == 4 and float(aux["loss"]) == 6.0 and aux["count"] == 7
    assert torch.equal(aux["errors"], torch.arange(4.0) * 2)
    want = NumpyDraws(3)
    assert torch.equal(seen["row"], want.uniform(8).reshape(4, 2)) and torch.equal(seen["param"], want.normal(3))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_a_mesh_of_one_rank_equals_no_mesh_to_the_bit(one_rank, scenario):
    setup = _setup_for(scenario)
    plain = run(scenario, copy.deepcopy(setup))
    meshed = run(scenario, copy.deepcopy(setup), one_rank)
    assert plain["draws"] == meshed["draws"] and plain["n_updates"] == meshed["n_updates"] > 0
    for key, value in plain["params"].items():
        assert torch.equal(value, meshed["params"][key]), key
    for key, value in plain["metrics"].items():
        assert torch.equal(value, meshed["metrics"][key]), key
    assert torch.equal(plain["recent_returns"], meshed["recent_returns"])
    if scenario == "per":
        for key, value in plain["trees"].items():
            assert torch.equal(value, meshed["trees"][key]), key


# ------------------------------------------------------------ two ranks
_SETUPS = {}


def _setup_for(scenario):
    """The starting state of a scenario, converted from the JAX package's
    init: ``{"train_state", "A", "B"}`` (and the JAX core and env)."""
    if scenario in _SETUPS:
        return _SETUPS[scenario]
    if scenario == "ppo":
        jenv, jcore, runner, from_flax, obs_dim, *_ = _setup("ppo")
        jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, obs_dim)))
        train = from_flax(runner.core, np_tree(jtrain), device="cpu")
        setup = {"train_state": train, "A": np.asarray(jenv._A), "B": np.asarray(jenv._B)}
    else:
        jcore = jax_core("dqn", HIDDEN, DECAY)
        jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, 4)))
        setup = {"train_state": port_state(build(scenario, None).core, jtrain), "A": None, "B": None}
        jenv = None
    _SETUPS[scenario] = setup
    _SETUPS[f"{scenario}-jax"] = (jenv, jcore, jtrain)
    return setup


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every scenario's single-process run, and its two ranks' runs (all six
    processes at once, each under its own timeout)."""
    tmp = tmp_path_factory.mktemp("mesh")
    out, procs = {}, []
    for scenario in SCENARIOS:
        setup = _setup_for(scenario)
        torch.save(setup, tmp / f"{scenario}.pt")
        port = _free_port()
        for rank in range(2):
            path = tmp / f"{scenario}-{rank}.pt"
            cmd = [sys.executable, WORKER, scenario, str(tmp / f"{scenario}.pt"), str(path), str(rank), "2", str(port)]
            procs.append((scenario, rank, path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                                 stderr=subprocess.STDOUT, text=True)))
    for scenario in SCENARIOS:
        out[scenario] = {"single": run(scenario, copy.deepcopy(_setup_for(scenario)))}
    failed = []
    for scenario, rank, path, proc in procs:
        try:
            log, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.append(f"{scenario} rank {rank} timed out:\n{log[-2000:]}")
            continue
        if proc.returncode:
            failed.append(f"{scenario} rank {rank} exited {proc.returncode}:\n{log[-2000:]}")
            continue
        out[scenario][rank] = torch.load(path, weights_only=False)
    assert not failed, "\n".join(failed)
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_gloo_ranks_hold_the_replicated_state_equal_to_the_bit(two_ranks, scenario):
    runs = two_ranks[scenario]
    a, b = runs[0], runs[1]
    assert (a["lanes"], b["lanes"]) == (slice(0, 2), slice(2, 4)) and (a["primary"], b["primary"]) == (True, False)
    assert (a["mesh"].rank, b["mesh"].rank, a["mesh"].size) == (0, 1, 2)
    assert a["draws"] == b["draws"] == runs["single"]["draws"]  # every draw is global
    assert a["n_updates"] == b["n_updates"] == runs["single"]["n_updates"] > 0
    for key, value in a["params"].items():
        assert torch.equal(value, b["params"][key]), key
    for key in ("recent_returns", "recent_count", "episode_return"):
        assert torch.equal(a[key], b[key]), key
    if scenario == "per":
        for key, value in a["trees"].items():
            assert torch.equal(value, b["trees"][key]), key


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_gloo_ranks_match_the_single_process_run(two_ranks, scenario):
    runs = two_ranks[scenario]
    single = runs["single"]
    torch.testing.assert_close(torch.cat([runs[0]["obs"], runs[1]["obs"]]), single["obs"], rtol=0, atol=0)
    for key, value in single["params"].items():
        torch.testing.assert_close(runs[0]["params"][key], value, rtol=0, atol=2e-6, msg=key)
    if scenario == "ppo":
        assert runs[0]["t"] == single["t"] == ITERATIONS * PPO_ROLLOUT * LANES
        return
    assert runs[0]["cursor"] == single["cursor"] == STEPS * LANES > CAPACITY
    for key, rows in single["ring"].items():
        # Each rank holds its lanes' rows: [slots / lanes, lanes / 2] each.
        whole = rows.reshape(CAPACITY // LANES, LANES, *rows.shape[1:])
        for rank in range(2):
            mine = runs[rank]["ring"][key].reshape(CAPACITY // LANES, LANES // 2, *rows.shape[1:])
            assert torch.equal(mine, whole[:, rank * 2:(rank + 1) * 2]), (key, rank)
    assert torch.equal(runs[0]["metrics"]["done_count"], single["metrics"]["done_count"])
    torch.testing.assert_close(runs[0]["metrics"]["loss"], single["metrics"]["loss"], rtol=1e-5, atol=1e-7)
    if scenario == "per":
        for key, value in single["trees"].items():
            torch.testing.assert_close(runs[0]["trees"][key], value, rtol=1e-5, atol=1e-6, msg=key)


def _jax_offpolicy(scenario, tape, mesh):
    jenv, jcore, jtrain = _SETUPS[f"{scenario}-jax"]
    buffer = JaxPER(CAPACITY, **PER) if scenario == "per" else JaxReplay(CAPACITY, gamma=0.99, num_lanes=LANES)
    jenv = jenvs.TimeLimit(jenvs.CartPole(), LIMIT)
    config = JaxConfig(num_envs=LANES, replay_start_size=START, update_interval=2,
                       target_update_interval=SYNC_EVERY, minibatch_size=BATCH)
    jrunner = JaxRunner(jenv, jcore, buffer, config, mesh=mesh)
    jrunner.env = TapeEnv(jenv, LANES, tape)
    env_states, obs = jrunner.env.reset(None)
    example = JaxTransition(obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()), next_obs=obs[0],
                            terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict())
    state = JaxRunnerState(
        env_states=env_states, obs=obs, train_state=jtrain, replay_state=buffer.init(example),
        rng=jnp.zeros((2,), jnp.uint32), t=jnp.int32(0), episode_return=jnp.zeros(LANES),
        recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0),
    )
    state = jax.device_put(state, jrunner._state_shardings(state))
    with jax.disable_jit():
        state, _ = jrunner.run_chunk(state, STEPS)
    assert not tape.log
    return state


def _jax_onpolicy(tape, mesh, monkeypatch):
    jenv, jcore, jtrain = _SETUPS["ppo-jax"]
    *_, resets, act, n_update = _setup("ppo")
    install_scripted_keys(monkeypatch)
    jrunner = JaxOnPolicyRunner(jenv, jcore, LANES, PPO_ROLLOUT, mesh=mesh)
    env_states, obs = VectorJaxEnv(jenv, LANES).reset(_reset_keys(tape, resets))
    acts, envs, updates = [], [], []
    for _ in range(ITERATIONS):
        for _ in range(PPO_ROLLOUT):
            acts.append(tape.take(act[0])[0].reshape(LANES, act[1]))
            reset = np.asarray(_reset_keys(tape, resets))
            envs.append(np.concatenate([np.zeros_like(reset), reset]))
        updates.append(np.stack(tape.take(*["permutation"] * n_update)).astype(np.int32))
    assert not tape.log
    key = ScriptedKey(step=jnp.int32(0), iteration=jnp.int32(0), act=jnp.asarray(np.stack(acts)),
                      env=jnp.asarray(np.stack(envs)), update=jnp.asarray(np.stack(updates)))
    state = JaxOnPolicyState(
        env_states=env_states, obs=obs, train_state=jtrain, rng=key, t=jnp.int32(0),
        episode_return=jnp.zeros(LANES), recent_returns=jnp.zeros(jrunner.return_window),
        recent_count=jnp.int32(0),
    )
    state = jax.tree.map(lambda x: jnp.array(x, copy=True), state)
    state = jax.device_put(state, jrunner._state_shardings(state))
    state, _ = jrunner.run_iterations(state, ITERATIONS)
    return state


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_gloo_ranks_match_the_jax_runner_on_a_two_device_mesh(two_ranks, scenario):
    runs = two_ranks[scenario]
    tape = NumpyDraws(0)
    tape.log = list(runs["single"]["log"])
    mesh = jax_make_mesh(("dp",), (2,), devices=jax.devices()[:2])
    with pytest.MonkeyPatch.context() as mp:
        if scenario == "ppo":
            jstate = _jax_onpolicy(tape, mesh, mp)
        else:
            install_tape(mp, tape)
            jstate = _jax_offpolicy(scenario, tape, mesh)
    jts = jstate.train_state
    assert int(jstate.t) == runs[0]["t"]
    train = copy.deepcopy(_SETUPS[scenario]["train_state"])
    with torch.no_grad():
        for name, p in train.model.named_parameters():
            p.copy_(runs[0]["params"][f"model.{name}"])
    assert_network(train.model, jts.params, 2e-5, f"{scenario} on two ranks against JAX on two devices")
    if scenario != "ppo":
        with torch.no_grad():
            for name, p in train.target_model.named_parameters():
                p.copy_(runs[0]["params"][f"target.{name}"])
        for name, want in convert.torch_arrays(train.target_model, np_tree(jts.target_params)).items():
            np.testing.assert_allclose(runs[0]["params"][f"target.{name}"].numpy(), want, rtol=0, atol=2e-5)
        np.testing.assert_allclose(runs[0]["recent_returns"].numpy(), np.asarray(jstate.recent_returns),
                                   rtol=1e-5, atol=1e-5)
    if scenario == "per":
        np.testing.assert_allclose(runs[0]["trees"]["tree"].numpy(), np.asarray(jstate.replay_state.tree),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(float(runs[0]["trees"]["beta"]), float(jstate.replay_state.beta), rtol=1e-6)


# ------------------------------------------------------------ run_multihost
class _Kept(Exception):
    pass


def test_run_multihost_is_the_examples_over_a_mesh_of_one_rank(monkeypatch):
    """``train_dqn_batch_ale.py --multihost``'s runner (its settings kept by
    a replaced ``OffPolicyRunner``) against the port's ``run_multihost`` over
    one Gloo rank: two scan steps, the job left at the end."""
    import importlib.util

    import pfrl_tpu.experiments as jexperiments
    import pfrl_tpu.parallel as jparallel
    from pfrl_tpu_torch.experiments import atari_dqn_batch
    from pfrl_tpu_torch.experiments.runner import OffPolicyRunner
    from pfrl_tpu_torch.parallel.lane_sharding import LaneShardedBuffer

    spec = importlib.util.spec_from_file_location(
        "example_dqn_batch_ale", os.path.join(os.path.dirname(WORKER), "..", "examples", "atari",
                                              "train_dqn_batch_ale.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    kept = {}

    class Runner:
        def __init__(self, env, core, buffer, cfg, mesh=None):
            kept.update(core=core, buffer=buffer, cfg=cfg, mesh=mesh)
            raise _Kept

    monkeypatch.setattr(jexperiments, "OffPolicyRunner", Runner)
    monkeypatch.setattr(jparallel, "initialize_multihost", lambda *a, **k: None)
    monkeypatch.setattr(jparallel, "global_mesh", lambda names: jax_make_mesh(names, (1,), devices=jax.devices()[:1]))
    monkeypatch.setattr(sys, "argv", ["train_dqn_batch_ale.py", "--multihost", "localhost:1"])
    with pytest.raises(_Kept):
        module.main()
    jcore, jbuffer, jcfg = kept["core"], kept["buffer"], kept["cfg"]
    assert kept["mesh"] is not None

    chunks = []
    run_chunk = OffPolicyRunner.run_chunk

    def two_steps(self, state, num_steps):
        chunks.append(num_steps)
        return run_chunk(self, state, 2)

    monkeypatch.setattr(OffPolicyRunner, "run_chunk", two_steps)
    out = atari_dqn_batch.run_multihost(["--multihost", f"localhost:{_free_port()}", "--replay-capacity", "4096",
                                         "--steps", "16"], device="cpu")
    assert not dist.is_initialized() and chunks == [500]
    runner, state, mesh = out["runner"], out["state"], out["mesh"]
    assert (mesh.axis_names, mesh.size) == (("dp",), 1) and state.t == 16 and runner.mesh is mesh
    cfg, core, buf = runner.config, runner.core, runner.buffer
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
            cfg.minibatch_size) == (jcfg.num_envs, jcfg.replay_start_size, jcfg.update_interval,
                                    jcfg.target_update_interval, jcfg.minibatch_size) == (8, 50_000, 4, 10_000, 32)
    assert core.batch_accumulator == jcore.batch_accumulator == "sum" and core.gamma == jcore.gamma == 0.99
    assert isinstance(core.optimizer, AllReduceGradients) and core.optimizer.op == "sum"
    assert (core.optimizer.inner.learning_rate, core.optimizer.inner.eps) == (2.5e-4, 1.5e-4)
    ex, jex = core.explorer, jcore.explorer
    assert (ex.start_epsilon, ex.end_epsilon, ex.decay_steps) == (jex.start_epsilon, jex.end_epsilon,
                                                                  jex.decay_steps) == (1.0, 0.01, 10**6)
    assert isinstance(buf, LaneShardedBuffer) and jbuffer.capacity == 10**6
    assert (buf.buffer.fused_dequant_scale, buf.buffer.store_next_obs) == (jbuffer.fused_dequant_scale,
                                                                           jbuffer.store_next_obs) == (1 / 255, False)
