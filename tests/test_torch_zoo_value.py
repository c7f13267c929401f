"""The converted-zoo gate for the five CartPole checkpoints of the discrete
value family in ``zoo/`` (``train_state.msgpack``, written by
``tools/record_curves.py``): DQN, C51, AL, IQN and Rainbow-CartPole. Each
is restored by the JAX package, handed to ``convert.dqn_state_from_flax``
as a numpy tree (the whole optimizer state: Adam, or Adam after
``clip_by_global_norm``) and held against the JAX core on the recipe of
``experiments/cartpole_value.py``. This file also holds the AL and IQN
recipes' small runs against the JAX runner (the checks of
``test_torch_cartpole_value_slice.py``; xdist hands out whole files).

(a) Greedy actions on 256 seeded observations are equal where the two
    best Q-values lie more than 1e-3 apart (away from ties). IQN acts on
    its fixed tau grid; Rainbow-CartPole's noise is logged from flax and
    handed to the port by value.
(b) ``EvalLoop`` 10 x 501 on ``TimeLimit(CartPole(), 500)`` from the start
    states of ``JaxEvalLoop`` on a real key, against that JAX run: DQN,
    C51, AL and IQN evaluate without draws, and every lane's return is
    equal. Rainbow-CartPole draws noise on every step: the port draws its
    own, both means are printed, and the port's is held to 475, the score
    at which ``run_rainbow_cartpole`` stops its curve as solved
    (``tools/record_curves.py:1013``).

Only this test reads msgpack; the port never does.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cartpole_value_slice import (
    assert_eval_matches_jax,
    assert_matches_jax_runner,
    jax_core,
    port_recipe,
    port_state,
    small_run,
)
from test_torch_rainbow_modules import ReplayedNormals, np_tree, record_normals
from test_torch_value_modules import cartpole_obs

from pfrl_tpu import envs as jenvs
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.replay.persistent import load_state
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.experiments.runner import EvalLoop

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zoo")
KINDS = ("dqn", "c51", "al", "iqn", "rainbow")
LANES, MAX_STEPS = 10, 501
RAINBOW_BOUND = 475.0


@functools.lru_cache(maxsize=None)
def checkpoint(kind):
    hidden = 128 if kind == "rainbow" else 100
    jcore = jax_core(kind, hidden, 50_000)
    template = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    jstate = load_state(template, os.path.join(ZOO, kind, "cartpole", "best", "train_state.msgpack"))
    runner, _ = port_recipe(kind, None, capacity=1_024)
    return jcore, jstate, runner.core, port_state(runner.core, jstate)


@pytest.mark.parametrize("kind", KINDS)
def test_converted_checkpoint_carries_the_whole_state(kind):
    _, jstate, _, tstate = checkpoint(kind)
    assert tstate.n_updates == int(jstate.n_updates) > 1_000  # a trained state, not the template
    clipped = kind in ("dqn", "al")
    adam = jstate.opt_state[1][0] if clipped else jstate.opt_state[0]
    assert tstate.opt_state.count == int(adam.count) == int(jstate.n_updates)

    def first_layer(tree):
        tree = np_tree(tree)["params"]
        return (tree["psi"] if kind == "iqn" else tree)["MLP_0"]["Dense_0"]["kernel"]

    name = "psi.mlp.layers.0.weight" if kind == "iqn" else "mlp.layers.0.weight"
    assert next(iter(tstate.model.named_parameters()))[0] == name
    weight = dict(tstate.model.named_parameters())[name]
    np.testing.assert_array_equal(weight.detach().numpy(), first_layer(jstate.params).T)
    nu = first_layer(adam.nu)
    np.testing.assert_array_equal(tstate.opt_state.nu[0].numpy(), nu.T)
    assert nu.max() > 0
    params = np_tree(jstate.params)["params"]
    if kind == "rainbow":
        w_sigma = params["FactorizedNoisyDense_0"]["w_sigma"]
        np.testing.assert_array_equal(tstate.model.advantage.w_sigma.detach().numpy(), w_sigma.T)
        assert np.abs(w_sigma).max() > 0


def _margins(av) -> np.ndarray:
    """The gap between the best two Q-values of each row."""
    q = np.sort(np.asarray(av.q_values), axis=-1)
    return q[:, -1] - q[:, -2]


@pytest.mark.parametrize("kind", KINDS)
def test_converted_checkpoint_gives_the_jax_greedy_actions(kind, monkeypatch):
    jcore, jstate, core, tstate = checkpoint(kind)
    obs = cartpole_obs(np.random.RandomState(0), 256)
    log = record_normals(monkeypatch)  # Rainbow-CartPole's act noise, logged from flax
    key = jax.random.PRNGKey(3)
    want = np.asarray(jcore.select_action(jstate, key, jnp.asarray(obs), jnp.int32(0), False))
    assert len(log) == (4 if kind == "rainbow" else 0)
    got = core.select_action(tstate, ReplayedNormals(log), torch.from_numpy(obs), 0, False).numpy()
    rng_noise = jax.random.split(key)[0]
    jav = jcore.action_value(jstate.params, rng_noise, jnp.asarray(obs))
    away = _margins(jav) > 1e-3
    assert got.shape == want.shape == (256,) and away.sum() > 200
    np.testing.assert_array_equal(got[away], want[away])
    assert 0 < want.mean() < 1  # both actions taken


def _start_states(key):
    """``JaxEvalLoop``'s start states on ``key`` by value, then seeded draws
    (the resets after the first, kept only where a lane ends; Rainbow's
    noise)."""
    lane_keys = jax.random.split(jax.random.split(key)[1], LANES)
    first = [np.concatenate([np.asarray(jax.random.uniform(k, (4,))) for k in lane_keys])]
    rs = np.random.RandomState(0)

    class StartStates:
        def uniform(self, n):
            return torch.from_numpy(first.pop(0).copy() if first else rs.uniform(size=n).astype(np.float32))

        def normal(self, n):
            return torch.from_numpy(rs.standard_normal(n).astype(np.float32))

    return StartStates()


@pytest.mark.parametrize("kind", KINDS)
def test_converted_checkpoint_evaluates_like_the_jax_eval_loop(kind):
    jcore, jstate, core, tstate = checkpoint(kind)
    key = jax.random.PRNGKey(11)
    want = JaxEvalLoop(jenvs.TimeLimit(jenvs.CartPole(), 500), jcore, LANES, MAX_STEPS).evaluate(jstate, key)
    env = tenvs.TimeLimit(tenvs.CartPole(device="cpu"), 500)
    got = EvalLoop(env, core, LANES, MAX_STEPS, device="cpu").evaluate(tstate, _start_states(key))
    print(f"zoo {kind}/cartpole: JaxEvalLoop mean return {want.mean():.3f}, port EvalLoop {got.mean():.3f}; "
          f"largest lane difference {np.abs(got - want).max():.1f}")
    assert got.shape == want.shape == (LANES,) and np.isfinite(got).all()
    if kind == "rainbow":
        assert got.mean() >= RAINBOW_BOUND and want.mean() >= RAINBOW_BOUND
        return
    np.testing.assert_array_equal(got, want)
    assert want.mean() >= 300.0


# ------------------------------------- the AL and IQN recipes' small runs
@pytest.fixture(scope="module")
def trained():
    return {kind: small_run(kind) for kind in ("al", "iqn")}


@pytest.mark.parametrize("kind", ["al", "iqn"])
def test_recipe_matches_the_jax_runner_over_updates_and_a_sync(trained, kind):
    assert_matches_jax_runner(trained[kind], kind)


@pytest.mark.parametrize("kind", ["al", "iqn"])
def test_eval_loop_matches_jax_eval_loop_on_the_same_draws(trained, kind):
    assert_eval_matches_jax(trained[kind], kind)
