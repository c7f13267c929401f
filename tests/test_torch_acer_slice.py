"""ACER's slice as a whole at a small width: the two ``tools/record_curves.py``
recipes of ``experiments/acer.py`` (``run_acer_abc``, discrete, and
``run_acer_continuous_abc``, the SDN head) through the port's
``OffPolicyRunner.run_chunk`` against the JAX package's own, and
``EvalLoop`` against ``JaxEvalLoop``. The narrow ACER-AtariSim run and the
A2C and PPO AtariSim iterations are in ``test_torch_acer_atari_slice.py``,
through the same functions.

The JAX runner runs under ``jax.disable_jit`` with ``install_acer_tape``
(``test_torch_acer_cores.py``): every draw it makes pops the port's next
logged draw (kind and size checked), so each act step's sample, each
window sample (rows, offsets) and each continuous update's SDN and
correction draws are the port's; the discrete update, which draws nothing,
runs jitted inside it. The behaviour distribution rides in each
transition's ``extras``; the runner's target interval (10^9 in the recipes)
is cut to 32 transitions here, so the runners cross it without a target to
sync (ACER has none).

Sizes: 4 lanes, hidden 16; rows of 5 (ABC) or 4 (continuous ABC), 3 per
lane, every lane's ring wrapping; one batch-4 update of whole rows per
scan step from replay start (16 transitions) on, 14 scan steps: 11 updates.

Tolerances: counters, flags, rows, actions exact; stored observations and
behaviour statistics 1e-5; losses 2e-5 relative; parameters and the
average model 2e-5 absolute (Adam over 11 updates, ROADMAP C22);
evaluation returns exact. The SDN's advantage network gets cancellation
noise for much of its gradient (ROADMAP C48), which Adam amplifies: on the
continuous recipe a 1 + 2**-23 nudge of the port's initial weights moves
its first layer by 5.0e-3 and the losses by 2.2e-4 over the run (JAX lies
2.4e-3 and 1.0e-4 away), so its parameters and the losses are held to 4x
what the nudge moves, measured in the test, and its output bias, which
has no gradient at all, to ``2 n lr``; the policy and the value function
agree within 1.8e-6 and are held at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_acer_cores import LR, SDN_FREE_BIAS, JaxPiQ, install_acer_tape, jax_sdn
from test_torch_recurrent_cores import np_tree
from test_torch_recurrent_slice import TapeEnv, _logging_rows, assert_eval_matches, load_example
from test_torch_sac import assert_network
from test_torch_value_modules import Tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu.agents.acer import ACERContinuousCore as JaxACERContinuous
from pfrl_tpu.agents.acer import ACERCore as JaxACER
from pfrl_tpu.experiments import OffPolicyRunner as JaxRunner
from pfrl_tpu.experiments import RunnerConfig as JaxConfig
from pfrl_tpu.experiments.runner import RunnerState as JaxRunnerState
from pfrl_tpu.replay import EpisodicReplayBuffer as JaxEpisodic
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.experiments import acer as acer_recipes

torch.set_num_threads(1)

LANES, HIDDEN = 4, 16
SMALL = dict(num_envs=LANES, max_episodes=12, replay_start_size=16, update_interval=4, minibatch_size=4)
SYNC_INTERVAL = 32
STEPS = {"acer-abc": 14, "acer-continuous-abc": 14, "acer-atarisim": 25}


def setup(kind):
    """(port runner, eval loop, JAX core, JAX env, env kind, sizes, the
    example observation's shape and dtype)."""
    if kind == "acer-abc":
        runner, loop = acer_recipes.make_acer_abc_runner(hidden=HIDDEN, device="cpu", **SMALL)
        jcore = JaxACER(model=JaxPiQ(n_actions=3, hidden=HIDDEN), optimizer=optax.adam(5e-3), gamma=0.9, beta=1e-2,
                        use_trust_region=True)
        return runner, loop, jcore, jenvs.ABC(size=3, deterministic=True), "abc", ((5,), jnp.float32)
    if kind == "acer-continuous-abc":
        runner, loop = acer_recipes.make_acer_continuous_abc_runner(hidden=HIDDEN, device="cpu", **SMALL)
        jcore = JaxACERContinuous(model=jax_sdn(hidden=HIDDEN), optimizer=optax.adam(5e-3), gamma=0.9, beta=1e-3,
                                  use_trust_region=True)
        jenv = jenvs.ABC(size=2, discrete=False, episodic=True, deterministic=True)
        return runner, loop, jcore, jenv, "abc", ((4,), jnp.float32)
    example = load_example("examples/atari/train_acer_ale.py")
    sizes = dict(SMALL, max_episode_len=8, replay_start_size=32)
    runner, loop = acer_recipes.make_acer_atarisim_runner(device="cpu", **sizes)
    jcore = JaxACER(model=example.PiQ(n_actions=6), optimizer=optax.rmsprop(7e-4, decay=0.99, eps=1e-2), gamma=0.99,
                    beta=1e-2, truncation_threshold=10.0, use_trust_region=True, trust_region_delta=0.1,
                    phi=example.phi)
    return runner, loop, jcore, jenvs.AtariSim(n_actions=6, mean_episode_len=50), "atari", ((84, 84, 4), jnp.uint8)


def _example_extras(continuous, n):
    if continuous:
        return FrozenDict({"mu_mean": jnp.zeros((n,)), "mu_std": jnp.zeros((n,))})
    return FrozenDict({"mu_logits": jnp.zeros((n,))})


def _run_jax(jcore, jenv, env_kind, runner, jtrain, tape, steps):
    """The JAX package's ``OffPolicyRunner.run_chunk`` on the port's draws."""
    cfg, buf = runner.config, runner.buffer
    config = JaxConfig(num_envs=LANES, replay_start_size=cfg.replay_start_size, update_interval=cfg.update_interval,
                       target_update_interval=SYNC_INTERVAL, minibatch_size=cfg.minibatch_size)
    buffer = JaxEpisodic(buf.max_episodes, buf.max_episode_len, num_lanes=LANES)
    buffer.sample_episodes = _logging_rows(buffer.sample_episodes)
    continuous = isinstance(jcore, JaxACERContinuous)
    if not continuous:  # the discrete update draws nothing: jitted inside the eager runner
        jitted = jax.jit(jcore.update_episodic)

        def update_episodic(state, rng, batch):
            with jax.disable_jit(False):
                return jitted(state, rng, batch)

        jcore.update_episodic = update_episodic
    jrunner = JaxRunner(jenv, jcore, buffer, config)
    jrunner.env = TapeEnv(jenv, LANES, tape, env_kind)
    env_states, obs = jrunner.env.reset(None)
    if continuous:
        d = jenv.action_space.shape[0]
        action, extras = jnp.zeros((d,), jnp.float32), _example_extras(True, d)
    else:
        action, extras = jnp.zeros((), jnp.int32), _example_extras(False, jenv.action_space.n)
    example = JaxTransition(obs=obs[0], action=action, reward=jnp.zeros(()), next_obs=obs[0],
                            terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=extras)
    state = JaxRunnerState(
        env_states=env_states, obs=obs, train_state=jtrain, replay_state=buffer.init(example),
        rng=jnp.zeros((2,), jnp.uint32), t=jnp.int32(0), episode_return=jnp.zeros(LANES),
        recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0),
    )
    with jax.disable_jit():
        state, metrics = jrunner.run_chunk(state, steps)
    return jrunner, state, metrics


def _port_run(kind, jtrain, scale=1.0):
    """The port's recipe from the JAX initial state, its weights scaled by
    ``scale``: (runner, eval loop, state, metrics, its draw log)."""
    runner, loop = setup(kind)[:2]
    runner.config.target_update_interval = SYNC_INTERVAL
    runner.buffer.sample_episodes = _logging_rows(runner.buffer.sample_episodes)
    tape = Tape(0)
    state = runner.init(0, draws=tape)
    state.train_state = convert.acer_state_from_flax(runner.core, np_tree(jtrain), device="cpu")
    with torch.no_grad():
        for p in state.train_state.model.parameters():
            p.mul_(scale)
    state, metrics = runner.run_chunk(state, STEPS[kind])
    return runner, loop, state, metrics, tape


def small_acer(kind):
    _, _, jcore, jenv, env_kind, (obs_shape, obs_dtype) = setup(kind)
    continuous = isinstance(jcore, JaxACERContinuous)
    example = (jnp.zeros((LANES,) + obs_shape, obs_dtype),) + ((jnp.zeros((LANES, 2)),) if continuous else ())
    jtrain = jcore.init(jax.random.PRNGKey(1), *example)
    runner, loop, state, metrics, tape = _port_run(kind, jtrain)
    kinds = [(k, v.size) for k, v in tape.log]
    with pytest.MonkeyPatch.context() as mp:
        install_acer_tape(mp, tape)
        jax_run = _run_jax(jcore, jenv, env_kind, runner, jtrain, tape, STEPS[kind])
    assert not tape.log  # every draw the port made was replayed
    # What scaling the initial weights by 1 + 2**-23 moves the port's own run.
    nudged = _port_run(kind, jtrain, 1.0 + 2.0**-23)[2:4] if continuous else None
    return dict(runner=runner, loop=loop, state=state, metrics=metrics, kinds=kinds, jax=jax_run, jcore=jcore,
                jenv=jenv, env_kind=env_kind, continuous=continuous, nudged=nudged)


def _close(got, want, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=what)


def assert_acer_matches(run, kind):
    runner, state, metrics = run["runner"], run["state"], run["metrics"]
    jrunner, jstate, jmetrics = run["jax"]
    cfg, steps = runner.config, STEPS[kind]
    assert state.t == int(jstate.t) == steps * LANES > SYNC_INTERVAL  # the interval was crossed
    update_steps = sum(1 for k in range(1, steps + 1) if k * LANES >= cfg.replay_start_size)
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates) == update_steps * cfg.updates_per_step >= 5
    rows, jrows = runner.buffer.sample_episodes.rows, jrunner.buffer.sample_episodes.rows
    assert len(rows) == len(jrows) == ts.n_updates
    for i, (got, want) in enumerate(zip(rows, jrows)):
        np.testing.assert_array_equal(got, want, err_msg=f"rows of update {i}")
    # Per scan step: the act draw; per update: the rows and offsets, and the
    # continuous update's SDN and correction normals.
    act = ("normal", LANES * 2) if run["continuous"] else ("uniform", LANES * runner.env.action_space.n)
    assert sum(1 for k in run["kinds"] if k == act) == steps
    if run["continuous"]:
        B, T = cfg.minibatch_size, runner.buffer.max_episode_len
        assert run["kinds"].count(("normal", 5 * B * T * 2)) == run["kinds"].count(("normal", B * T * 2)) \
            == ts.n_updates

    replay, jreplay = state.replay_state, jstate.replay_state
    for name in ("ep_len", "finished", "lane_row", "n_started"):
        np.testing.assert_array_equal(getattr(replay, name).numpy(), np.asarray(getattr(jreplay, name)), err_msg=name)
    rows_per_lane = runner.buffer.max_episodes // LANES
    assert int(replay.n_started) - LANES >= LANES * rows_per_lane  # every lane's ring wrapped
    for name in ("terminated", "done", "reward"):
        want = np.asarray(getattr(jreplay.storage, name))
        np.testing.assert_array_equal(replay.storage[name].numpy().reshape(want.shape), want, err_msg=name)
    want = np.asarray(jreplay.storage.action)
    if run["continuous"]:
        _close(replay.storage["action"].numpy(), want, 1e-5, "action")
    else:
        np.testing.assert_array_equal(replay.storage["action"].numpy(), want)
    for name in ("obs", "next_obs"):
        want = np.asarray(getattr(jreplay.storage, name))
        _close(replay.storage[name].numpy().reshape(want.shape), want, 1e-5, name)
    extras = replay.storage["extras"]
    assert set(extras) == set(jreplay.storage.extras)
    for name, stored in extras.items():
        _close(stored.numpy(), jreplay.storage.extras[name], 1e-5, name)

    np.testing.assert_array_equal(metrics["done_count"].numpy(), np.asarray(jmetrics["done_count"]))
    assert int(state.recent_count) == int(jstate.recent_count) > 0
    if not run["continuous"]:
        _close(metrics["loss"].numpy(), jmetrics["loss"], 1e-7, "loss", rtol=2e-5)
        for module, tree, what in ((ts.model, jts.params, "params"), (ts.avg_model, jts.avg_params, "avg")):
            assert_network(module, tree, 2e-5, f"{kind} {what}")
        return
    # The SDN's advantage network only ever enters as A(s, a) - mean_i
    # A(s, a_i): whatever of it is a function of the state alone (the output
    # bias always, the first layer's state weights of a unit that no sample
    # switches off) gets cancellation noise for a gradient, which Adam makes
    # into steps (ROADMAP C48). Its parameters, and through them the losses,
    # are held to 4x what a 1 + 2**-23 nudge of the weights moves the port's
    # own run, the output bias to the 2 n lr two Adam runs can part by; the
    # policy and the value function as the discrete recipe's.
    nstate, nmetrics = run["nudged"]
    loss_tol = max(2e-5 * float(metrics["loss"].abs().max()), 4 * float((metrics["loss"] - nmetrics["loss"]).abs().max()))
    _close(metrics["loss"].numpy(), jmetrics["loss"], loss_tol, "loss")
    for attr, tree in (("model", jts.params), ("avg_model", jts.avg_params)):
        module, nudged = getattr(ts, attr), dict(getattr(nstate.train_state, attr).named_parameters())
        got = dict(module.named_parameters())
        for name, want in convert.torch_arrays(module, np_tree(tree)).items():
            if name == SDN_FREE_BIAS:
                tol = 2 * ts.n_updates * LR
            elif name.startswith("adv."):
                tol = max(2e-5, 4 * float((got[name] - nudged[name]).detach().abs().max()))
            else:
                tol = 2e-5
            _close(got[name].detach().numpy(), want, tol, f"{attr} {name}")


KINDS = ("acer-abc", "acer-continuous-abc")


@pytest.fixture(scope="module")
def trained():
    return {kind: small_acer(kind) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_acer_recipe_matches_the_jax_runner(trained, kind):
    assert_acer_matches(trained[kind], kind)


@pytest.mark.parametrize("kind", KINDS)
def test_eval_loop_matches_jax_eval_loop(trained, kind):
    assert_eval_matches(trained[kind])
