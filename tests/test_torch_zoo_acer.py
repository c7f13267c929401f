"""The converted-zoo gate for ACER's two checkpoints in ``zoo/``
(``train_state.msgpack``, written by ``tools/record_curves.py``):
``acer/abc`` (``run_acer_abc``: discrete, Dense 64) and
``acer_continuous/abc`` (``run_acer_continuous_abc``: the SDN head, width
32). Each is restored by the JAX package as ``tests/test_zoo.py`` restores
it, handed to ``convert.acer_state_from_flax`` as a numpy tree (the
weights, the average model, Adam's moments and count, ``n_updates``) and
run on the recipe of ``experiments/acer.py``.

(a) The converted state is the whole state: a trained ``n_updates`` and
    Adam count, every parameter of the model and of the average model equal
    to the checkpoint's.
(b) ``EvalLoop`` against ``JaxEvalLoop`` (un-jitted) lane by lane,
    exactly, on the recipes' evaluation (10 lanes x 5 steps, 10 x 4): both
    act by the policy's mode and the deterministic ABC draws nothing. The
    recipes' gate is a mean return of 1.0 (``successful_score``).
(c) The policy's greedy actions on every observation the chain has agree
    with JAX's, and so do the behaviour statistics it would store.

Only this test reads msgpack; the port never does.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_acer_cores import JaxPiQ, jax_sdn
from test_torch_recurrent_cores import np_tree
from test_torch_sac import assert_network

from pfrl_tpu import envs as jenvs
from pfrl_tpu.agents.acer import ACERContinuousCore as JaxACERContinuous
from pfrl_tpu.agents.acer import ACERCore as JaxACER
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.replay.persistent import load_state
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.experiments import acer as acer_recipes
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zoo")
NAMES = ("acer/abc", "acer_continuous/abc")


@functools.lru_cache(maxsize=None)
def checkpoint(name):
    """(JAX core, JAX env, restored JAX state, port runner and eval loop,
    converted state)."""
    if name == "acer/abc":
        jcore = JaxACER(model=JaxPiQ(n_actions=3, hidden=64), optimizer=optax.adam(5e-3), gamma=0.9, beta=1e-2,
                        use_trust_region=True)
        jenv = jenvs.ABC(size=3, deterministic=True)
        template = jcore.init(jax.random.PRNGKey(0), np.zeros((1, 5), np.float32))
        runner, loop = acer_recipes.make_acer_abc_runner(device="cpu")
    else:
        jcore = JaxACERContinuous(model=jax_sdn(hidden=32), optimizer=optax.adam(5e-3), gamma=0.9, beta=1e-3,
                                  use_trust_region=True)
        jenv = jenvs.ABC(size=2, discrete=False, episodic=True, deterministic=True)
        template = jcore.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.float32), np.zeros((1, 2), np.float32))
        runner, loop = acer_recipes.make_acer_continuous_abc_runner(device="cpu")
    jstate = load_state(jax.device_get(template), os.path.join(ZOO, name, "best", "train_state.msgpack"))
    tstate = convert.acer_state_from_flax(runner.core, np_tree(jstate), device="cpu")
    return jcore, jenv, jstate, runner, loop, tstate


@pytest.mark.parametrize("name", NAMES)
def test_converted_checkpoint_carries_the_whole_state(name):
    _, _, jstate, _, _, tstate = checkpoint(name)
    assert tstate.n_updates == int(jstate.n_updates) > 1  # a trained state, not the template
    assert tstate.opt_state.count == int(jstate.opt_state[0].count) == int(jstate.n_updates)
    assert_network(tstate.model, jstate.params, 0.0, "model")
    assert_network(tstate.avg_model, jstate.avg_params, 0.0, "avg")
    diff = max(float((p - q).detach().abs().max()) for p, q in zip(tstate.model.parameters(), tstate.avg_model.parameters()))
    assert diff > 0  # the average model is a state of its own


@pytest.mark.parametrize("name", NAMES)
def test_eval_loop_matches_jax_lane_by_lane_and_clears_the_gate(name):
    jcore, jenv, jstate, runner, loop, tstate = checkpoint(name)
    got = loop.evaluate(tstate, Draws(torch.Generator().manual_seed(1)))
    with jax.disable_jit():
        want = JaxEvalLoop(jenv, jcore, loop.env.num_envs, loop.max_steps).evaluate(jstate, jax.random.PRNGKey(1))
    print(f"{name}: port {got.mean():.3f}, JAX {want.mean():.3f}")
    assert got.shape == want.shape == (10,)
    np.testing.assert_array_equal(got, want)
    assert got.mean() >= 1.0, got  # the recipe's successful_score
    assert isinstance(loop, EvalLoop)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_actions_and_behaviour_statistics_match_jax(name):
    jcore, jenv, jstate, runner, _, tstate = checkpoint(name)
    n = runner.env.env.n_dim_obs
    obs = np.eye(n, dtype=np.float32)  # every state of the chain (and the terminal one)
    key = jnp.zeros((2,), jnp.uint32)
    got = runner.core.select_action(tstate, None, torch.from_numpy(obs), 0, False).numpy()
    want = np.asarray(jcore.select_action(jstate, key, jnp.asarray(obs), 0, False))
    _, extras = runner.core.select_action_with_extras(tstate, Draws(torch.Generator().manual_seed(0)),
                                                      torch.from_numpy(obs), 0, True)
    _, jextras = jcore.select_action_with_extras(jstate, jax.random.PRNGKey(0), jnp.asarray(obs), 0, True)
    if name == "acer/abc":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.argmax(np.clip(got, -1, 1), -1), np.argmax(np.clip(want, -1, 1), -1))
    for k, v in extras.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jextras[k]), rtol=0, atol=1e-6, err_msg=k)
