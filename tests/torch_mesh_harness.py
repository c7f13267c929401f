"""The harness of ``test_torch_mesh_*.py`` (not a test module): each core of
the mesh's later branches run by ``torch_mesh_worker.py`` without a mesh,
over one Gloo rank in this process and over two spawned Gloo ranks, and
the JAX package's runner on ``make_mesh(("dp",), (2,))`` over two of the
virtual CPU devices of ``conftest.py``, on the port's logged draws.

Each scenario starts from the JAX core's initial state, converted. The JAX
runs reuse the single-device parity harnesses of
``test_torch_recurrent_slice.py``, ``test_torch_acer_slice.py``,
``test_torch_cartpole_value_slice.py``, ``test_torch_actor_critic_slice.py``
and ``test_torch_onpolicy_slice.py`` with their runner class replaced by one
that takes the mesh and places its state by its own ``_state_shardings``
(the lanes, the carry and the buffer's storage sharded, the rest
replicated). SAC's harness is a module loop over the JAX core: its jitted
update gets the batch constrained to rows sharded over the mesh.

**The bound of a two-rank run** against the single-process run (ROADMAP
C77): 2e-6, or 4x what scaling the initial weights by 1 +- 2**-23 moves a
tensor of the single-process run, or 4 float32 ulps at the tensor's largest
magnitude, where that is larger (C54): the mean or
sum of two half-batch gradients rounds apart from the whole batch's, and a
core that amplifies rounding (ACER's continuous trust region, C47-C48;
TRPO's conjugate gradient, C21) carries it further. Against the JAX
runner: 2e-5, or that same nudge bound where larger (the single-device
parity tests' rule for those cores).
"""

import copy
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_acer_cores import LR, SDN_FREE_BIAS, install_acer_tape
from test_torch_onpolicy_slice import ScriptedKey, install_scripted_keys
from test_torch_recurrent_cores import np_tree
from test_torch_recurrent_modules import install_recurrent_tape
from test_torch_value_modules import install_tape

import test_torch_acer_slice as acer_slice
import test_torch_actor_critic_slice as ac_slice
import test_torch_cartpole_value_slice as value_slice
import test_torch_onpolicy_slice as onpolicy_slice
import test_torch_recurrent_slice as recurrent_slice
import torch_mesh_worker as worker
from pfrl_tpu import envs as jenvs
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunner as JaxOnPolicyRunner
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunnerState as JaxOnPolicyState
from pfrl_tpu.parallel import make_mesh as jax_make_mesh
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.parallel.multihost import initialize_multihost, shutdown
from pfrl_tpu_torch.parallel.mesh import make_mesh

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
RANK_TIMEOUT_S = 240
NUDGES = (1.0 + 2.0**-23, 1.0 - 2.0**-23)
PER = dict(alpha=0.5, beta0=0.4, betasteps=100, num_steps=3, gamma=0.99, num_lanes=worker.LANES)
# scenario -> (port attribute, JAX attribute) of each network compared with the JAX runner
NETS = {
    "drqn": (("model", "params"), ("target_model", "target_params")),
    "drqn-per": (("model", "params"), ("target_model", "target_params")),
    "riqn": (("model", "params"), ("target_model", "target_params")),
    "iqn": (("model", "params"), ("target_model", "target_params")),
    "rainbow": (("model", "params"), ("target_model", "target_params")),
    "acer": (("model", "params"), ("avg_model", "avg_params")),
    "acer-continuous": (("model", "params"), ("avg_model", "avg_params")),
    "sac": ac_slice.NETS["sac"],
    "trpo": (("policy", "policy_params"), ("vf", "vf_params")),
    "rtrpo": (("policy", "policy_params"), ("vf", "vf_params")),
    "rppo": (("model", "params"),),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank():
    """A Gloo group of one rank in this process, torn down after the test."""
    initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        yield make_mesh(("dp",))
    finally:
        shutdown()


# ---------------------------------------------------------------- setups
_SETUPS = {}


def setup_for(scenario):
    """``{"train_state", "A", "B"}``: the JAX core's initial state converted
    to the port's (kept with the JAX context in ``_SETUPS``)."""
    if scenario in _SETUPS:
        return _SETUPS[scenario]["setup"]
    core = worker.build_core(scenario, {"A": np.eye(17, dtype=np.float32),
                                        "B": np.zeros((6, 17), np.float32)}).core
    A = B = None
    key = jax.random.PRNGKey(1)
    if scenario in ("drqn", "drqn-per", "riqn"):
        jcore = recurrent_slice.setup_offpolicy(f"{scenario[:4]}-delayedcue")[2]
        jtrain = jcore.init(key, jnp.zeros((worker.LANES, 13)))
        train = convert.dqn_state_from_flax(core, np_tree(jtrain.params), np_tree(jtrain.target_params),
                                            np_tree(jtrain.opt_state), device="cpu")
    elif scenario.startswith("acer"):
        jcore = acer_slice.setup("acer-abc" if scenario == "acer" else "acer-continuous-abc")[2]
        example = (jnp.zeros((worker.LANES, 5)),) if scenario == "acer" else (
            jnp.zeros((worker.LANES, 4)), jnp.zeros((worker.LANES, 2)))
        jtrain = jcore.init(key, *example)
        train = convert.acer_state_from_flax(core, np_tree(jtrain), device="cpu")
    elif scenario in ("iqn", "rainbow"):
        jcore = value_slice.jax_core(scenario, worker.HIDDEN, worker.DECAY, worker.FEATURES, worker.TAUS)
        jtrain = jcore.init(key, jnp.zeros((worker.LANES, 4)))
        train = value_slice.port_state(core, jtrain)
    elif scenario == "sac":
        jenv, jcore, _, obs_dim, act_dim, from_flax = ac_slice._setup("sac")
        A, B = np.asarray(jenv._A), np.asarray(jenv._B)
        jtrain = jcore.init(key, jnp.zeros((worker.LANES, obs_dim)), jnp.zeros((worker.LANES, act_dim)))
        train = from_flax(core, np_tree(jtrain), device="cpu")
        _SETUPS["sac-env"] = (jenv, jcore)
    elif scenario == "trpo":
        _, jcore, _, from_flax, obs_dim, *_ = onpolicy_slice._setup("trpo")
        jtrain = jcore.init(key, jnp.zeros((worker.LANES, obs_dim)))
        train = from_flax(core, np_tree(jtrain), device="cpu")
    else:
        _, _, jcore, from_flax, _ = recurrent_slice.setup_onpolicy(f"{scenario}-delayedcue")
        jtrain = jcore.init(key, jnp.zeros((worker.LANES, 13)))
        train = from_flax(core, np_tree(jtrain), device="cpu")
    setup = {"train_state": train, "A": A, "B": B}
    _SETUPS[scenario] = {"setup": setup, "jtrain": jtrain}
    return setup


def nudged(setup, factor):
    """``setup`` with every weight of its train state's networks scaled."""
    out = copy.deepcopy(setup)
    train = out["train_state"]
    for f in dataclasses.fields(train):
        module = getattr(train, f.name)
        if isinstance(module, torch.nn.Module):
            with torch.no_grad():
                for p in module.parameters():
                    p.mul_(factor)
    return out


def nudge_moves(scenario, single) -> dict:
    """Per learned tensor, what the two nudges of the initial weights move
    the single-process run, at most."""
    moves = {}
    for factor in NUDGES:
        run = worker.run_core(scenario, nudged(setup_for(scenario), factor))
        for k, v in single["learned"].items():
            if v.is_floating_point() and v.numel():
                moves[k] = max(moves.get(k, 0.0), float((run["learned"][k] - v).abs().max()))
    return moves


# ------------------------------------------------------------- two ranks
def spawn_two_ranks(scenarios, tmp) -> dict:
    """Every scenario's two ranks (all started at once, each under its own
    timeout), its single-process run and the nudge moves of that run."""
    procs, out = [], {}
    for scenario in scenarios:
        setup = dict(setup_for(scenario)) if scenario != "snapshot" else {"A": None, "B": None}
        setup["snapshot_dir"] = str(tmp / f"{scenario}-snapshot")
        torch.save(setup, tmp / f"{scenario}.pt")
        port = free_port()
        for rank in range(2):
            path = tmp / f"{scenario}-{rank}.pt"
            cmd = [sys.executable, WORKER, scenario, str(tmp / f"{scenario}.pt"), str(path), str(rank), "2", str(port)]
            procs.append((scenario, rank, path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                                 text=True)))
    for scenario in scenarios:
        out[scenario] = {}
        if scenario != "snapshot":
            single = worker.run_core(scenario, copy.deepcopy(setup_for(scenario)))
            out[scenario].update(single=single, moves=nudge_moves(scenario, single))
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


def assert_equal_runs(a, b, parts=("learned", "metrics", "replicated", "local"), what=""):
    """Every tensor of ``parts`` of two runs equal to the bit."""
    for part in parts:
        assert a[part].keys() == b[part].keys(), (what, part)
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), f"{what} {part} {k}"


def assert_one_rank_equals_no_mesh(scenario, mesh):
    setup = setup_for(scenario)
    plain = worker.run_core(scenario, copy.deepcopy(setup))
    meshed = worker.run_core(scenario, copy.deepcopy(setup), mesh)
    assert plain["draws"] == meshed["draws"] and plain["n_updates"] == meshed["n_updates"] > 0
    assert_equal_runs(plain, meshed, what=scenario)
    if "eval" in plain:  # EvalLoop under the mesh
        assert torch.equal(plain["eval"], meshed["eval"])


def assert_ranks_equal(runs, scenario):
    a, b = runs[0], runs[1]
    assert a["draws"] == b["draws"] == runs["single"]["draws"]  # every draw is global
    assert a["n_updates"] == b["n_updates"] == runs["single"]["n_updates"] > 0
    assert_equal_runs(a, b, ("learned", "metrics", "replicated"), scenario)
    if "eval" in a:  # each rank evaluated its 4 of the 8 episodes; the returns all-gathered
        assert torch.equal(a["eval"], b["eval"]) and torch.equal(a["eval"], runs["single"]["eval"])


def bound(runs, key, floor=2e-6) -> float:
    """``floor``, 4x what the nudges move the tensor ``key``, or 4 float32
    ulps at its largest magnitude (an optimizer moment of 48 has an ulp of
    3.8e-6), whichever is largest."""
    value = runs["single"]["learned"].get(key)
    ulp = float(value.abs().max()) * 2.0**-23 if value is not None and value.numel() else 0.0
    return max(floor, 4 * runs["moves"].get(key, 0.0), 4 * ulp)


def assert_within_the_single_run(runs, scenario):
    single = runs["single"]
    # Each rank's lanes, side by side, are the single run's lanes: exactly,
    # but where a continuous action is a GEMM's output on the rank's lanes
    # (its rows round as the batch of 2 does, not of 4).
    obs_tol = 1e-5 if scenario in ("trpo", "sac", "acer-continuous") else 0.0
    torch.testing.assert_close(torch.cat([runs[0]["local"]["obs"], runs[1]["local"]["obs"]]),
                               single["local"]["obs"], rtol=0, atol=obs_tol)
    for key, value in single["learned"].items():
        if value.is_floating_point():
            tol = bound(runs, key)
            if scenario == "acer-continuous" and key.endswith(f"model.{SDN_FREE_BIAS}"):
                tol = max(tol, 2 * single["n_updates"] * LR)  # ROADMAP C48: two Adam runs part by 2 n lr
            torch.testing.assert_close(runs[0]["learned"][key], value, rtol=0, atol=tol, msg=key)
        else:
            assert torch.equal(runs[0]["learned"][key], value), key
    for key in ("replay.ep_len", "replay.finished", "replay.lane_row", "replay.n_started"):
        if key in single["replicated"]:
            assert torch.equal(runs[0]["replicated"][key], single["replicated"][key]), key
    storage = [k for k in single["local"] if ".storage." in k and k.split(".")[-1] in ("done", "terminated",
                                                                                       "action")]
    for key in storage if scenario in ("drqn", "drqn-per", "riqn", "acer") else ():
        # Each rank holds its lanes' blocks of rows: the single run's rows, halved.
        whole = single["local"][key]
        half = whole.shape[0] // 2
        for rank in range(2):
            assert torch.equal(runs[rank]["local"][key], whole[rank * half:(rank + 1) * half]), (key, rank)


# --------------------------------------------------------------- the JAX side
def meshed(cls, mesh):
    """``cls`` (the JAX off- or on-policy runner) over ``mesh``, its state
    placed by its own shardings before it runs."""

    class Meshed(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, mesh=mesh, **kwargs)

        def _placed(self, state):
            return jax.device_put(state, self._state_shardings(state))

        def run_chunk(self, state, n):
            return super().run_chunk(self._placed(state), n)

        def run_iterations(self, state, n):
            return super().run_iterations(self._placed(state), n)

    return Meshed


class _RowShardedUpdate:
    """A JAX core whose update takes its batch sharded by rows over ``mesh``."""

    def __init__(self, core, mesh):
        self._core, self._rows = core, NamedSharding(mesh, P("dp"))

    def __getattr__(self, name):
        return getattr(self._core, name)

    def update(self, state, key, batch):
        batch = jax.tree.map(lambda x: jax.lax.with_sharding_constraint(x, self._rows), batch)
        return self._core.update(state, key, batch)


def _jax_recurrent_onpolicy(scenario, tape, mesh, mp):
    jcore = recurrent_slice.setup_onpolicy(f"{scenario}-delayedcue")[2]
    lanes, rollout, iterations = worker.LANES, worker.ON_ROLLOUT, worker.CORES[scenario]
    install_scripted_keys(mp)
    mp.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None: key < p)
    jenv = jenvs.DelayedCue(12, 8)
    jrunner = JaxOnPolicyRunner(jenv, jcore, lanes, rollout, mesh=mesh)
    env_states, obs = VectorJaxEnv(jenv, lanes).reset(jnp.asarray(tape.take("uniform")[0]))
    acts, envs, updates = [], [], []
    for _ in range(iterations):
        for _ in range(rollout):
            acts.append(tape.take("uniform")[0].reshape(lanes, 2))
            (u,) = tape.take("uniform")
            envs.append(np.concatenate([np.zeros_like(u), u]))
        updates.append(np.stack(tape.take("permutation", "permutation")).astype(np.int32))
    key = ScriptedKey(step=jnp.int32(0), iteration=jnp.int32(0), act=jnp.asarray(np.stack(acts)),
                      env=jnp.asarray(np.stack(envs)), update=jnp.asarray(np.stack(updates)))
    state = JaxOnPolicyState(
        env_states=env_states, obs=obs, train_state=_SETUPS[scenario]["jtrain"], rng=key, t=jnp.int32(0),
        episode_return=jnp.zeros(lanes), recent_returns=jnp.zeros(jrunner.return_window),
        recent_count=jnp.int32(0), act_state=jcore.init_act_state(lanes),
    )
    state = jax.tree.map(lambda x: jnp.array(x, copy=True), state)
    state = jax.device_put(state, jrunner._state_shardings(state))
    state, _ = jrunner.run_iterations(state, iterations)
    return state.train_state


def jax_train_state(scenario, log):
    """The JAX runner's final train state on a two-device mesh, on the draws
    of ``log``."""
    mesh = jax_make_mesh(("dp",), (2,), devices=jax.devices()[:2])
    tape = worker.NumpyDraws(0)
    tape.log = list(log)
    jtrain = _SETUPS[scenario]["jtrain"]
    with pytest.MonkeyPatch.context() as mp:
        if scenario in ("drqn", "drqn-per", "riqn"):
            _, _, jcore, jenv, env_kind, _ = recurrent_slice.setup_offpolicy(f"{scenario[:4]}-delayedcue")
            mp.setattr(recurrent_slice, "JaxRunner", meshed(recurrent_slice.JaxRunner, mesh))
            install_recurrent_tape(mp, tape)
            sizes = dict(worker.CUE, replay_start_size=84) if scenario == "riqn" else worker.CUE
            _, state, _ = recurrent_slice._run_jax_offpolicy(jcore, jenv, env_kind, sizes, jtrain, tape,
                                                             worker.CORES[scenario], scenario == "drqn-per")
            train = state.train_state
        elif scenario.startswith("acer"):
            kind = "acer-abc" if scenario == "acer" else "acer-continuous-abc"
            _, _, jcore, jenv, env_kind, _ = acer_slice.setup(kind)
            mp.setattr(acer_slice, "JaxRunner", meshed(acer_slice.JaxRunner, mesh))
            install_acer_tape(mp, tape)
            runner = worker.build_core(scenario, None)
            _, state, _ = acer_slice._run_jax(jcore, jenv, env_kind, runner, jtrain, tape, worker.CORES[scenario])
            train = state.train_state
        elif scenario in ("iqn", "rainbow"):
            jcore = value_slice.jax_core(scenario, worker.HIDDEN, worker.DECAY, worker.FEATURES, worker.TAUS)
            buffer = JaxPER(worker.CAPACITY, **PER) if scenario == "rainbow" else JaxReplay(
                worker.CAPACITY, gamma=0.99, num_lanes=worker.LANES)
            mp.setattr(value_slice, "JaxRunner", meshed(value_slice.JaxRunner, mesh))
            install_tape(mp, tape)
            _, state, _ = value_slice._run_jax(jcore, jtrain, buffer, tape)
            train = state.train_state
        elif scenario == "sac":
            jenv, jcore = _SETUPS["sac-env"]
            updates = worker.build_core("sac", _SETUPS["sac"]["setup"]).config.updates_per_step
            train = ac_slice._run_jax(mp, "sac", jenv, _RowShardedUpdate(jcore, mesh), jtrain, tape, 17, 6,
                                      updates)[2]
        elif scenario == "trpo":
            jenv, jcore, _, _, _, resets, act, n_update = onpolicy_slice._setup("trpo")
            mp.setattr(onpolicy_slice, "JaxOnPolicyRunner", meshed(onpolicy_slice.JaxOnPolicyRunner, mesh))
            train = onpolicy_slice._run_jax(mp, jenv, jcore, jtrain, tape, resets, act, n_update,
                                            worker.PPO_ROLLOUT)[1].train_state
        else:
            train = _jax_recurrent_onpolicy(scenario, tape, mesh, mp)
    assert not tape.log  # every draw the port made was replayed
    return train


def assert_matches_the_jax_runner(runs, scenario):
    jts = jax_train_state(scenario, runs["single"]["log"])
    train = copy.deepcopy(setup_for(scenario)["train_state"])
    learned = runs[0]["learned"]
    for attr, jattr in NETS[scenario]:
        module = getattr(train, attr)
        got = {name: learned[f"train.{attr}.{name}"] for name, _ in module.named_parameters()}
        for name, want in convert.torch_arrays(module, np_tree(getattr(jts, jattr))).items():
            tol = bound(runs, f"train.{attr}.{name}", 2e-5)
            if scenario == "acer-continuous" and name == SDN_FREE_BIAS:
                tol = max(tol, 2 * runs[0]["n_updates"] * LR)  # ROADMAP C48
            np.testing.assert_allclose(got[name].numpy(), want, rtol=0, atol=tol, err_msg=f"{scenario} {attr} {name}")
