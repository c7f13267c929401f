"""The converted-zoo gate: the three Pendulum checkpoints in ``zoo/`` (SAC,
TD3, DDPG; ``train_state.msgpack`` files written by
``tools/record_curves.py``) restored by the JAX package, handed to the
port's converters as numpy trees, and held against the JAX cores.

(a) Greedy actions on 256 seeded observations: within 1e-5.
(b) ``EvalLoop``'s mean return over 10 lanes x 201 steps from the start
    states of ``JaxEvalLoop`` on a real key, against that JAX run on the
    same checkpoint: the yardstick. Greedy actions draw nothing, so the
    start states decide the returns. A trained controller pulls nearby
    trajectories together, so float32 differences do not grow: the mean
    must agree within 0.01 (of returns between -400 and 0) and each
    lane's return within 1e-4 relative + 0.01. Both are printed.

Only this test reads msgpack; the port never does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_actor_critic_modules import JaxDetPolicy, JaxSACPolicy, np_tree

from pfrl_tpu import envs as jenvs
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.agents.ddpg import DDPGCore as JaxDDPGCore
from pfrl_tpu.agents.soft_actor_critic import SACCore as JaxSACCore
from pfrl_tpu.agents.td3 import TD3Core as JaxTD3Core
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.replay.persistent import load_state
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
from pfrl_tpu_torch.experiments.runner import EvalLoop

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zoo")
LANES, MAX_STEPS = 10, 201


def _jax_core(kind):
    """The architecture ``tools/record_curves.py`` trained."""
    hidden = 256 if kind == "sac" else 64
    lr = 3e-4 if kind == "sac" else 1e-3
    qf = lambda: jq.FCSAQFunction(n_hidden_layers=2, n_hidden_channels=hidden)  # noqa: E731
    explorer = jexplorers.AdditiveGaussian(0.1, low=-1.0, high=1.0)
    if kind == "sac":
        return JaxSACCore(
            policy=JaxSACPolicy(act_dim=1, hidden=256), q_func1=qf(), q_func2=qf(),
            policy_optimizer=optax.adam(lr), q_func1_optimizer=optax.adam(lr), q_func2_optimizer=optax.adam(lr),
            gamma=0.99, entropy_target=-1.0,
        )
    if kind == "td3":
        return JaxTD3Core(
            policy=JaxDetPolicy(act_dim=1, hidden=64), q_func1=qf(), q_func2=qf(),
            policy_optimizer=optax.adam(lr), q_func1_optimizer=optax.adam(lr), q_func2_optimizer=optax.adam(lr),
            explorer=explorer, gamma=0.99, policy_update_delay=2,
        )
    return JaxDDPGCore(
        policy=JaxDetPolicy(act_dim=1, hidden=64), q_func=qf(),
        policy_optimizer=optax.adam(lr), q_optimizer=optax.adam(lr), explorer=explorer, gamma=0.99,
    )


def _port(kind, jstate):
    sizes = dict(num_envs=16, update_interval=4, minibatch_size=128, device="cpu")
    if kind == "sac":
        runner = mac.make_sac_runner(hidden=256, env=mac.pendulum_env("cpu"), **sizes)
        return runner, convert.sac_state_from_flax(runner.core, np_tree(jstate), device="cpu")
    if kind == "td3":
        runner = mac.make_td3_runner(hidden=64, env=mac.pendulum_env("cpu"), **sizes)
        return runner, convert.td3_state_from_flax(runner.core, np_tree(jstate), device="cpu")
    runner = mac.make_ddpg_runner(**sizes)
    return runner, convert.actor_critic_state_from_flax(runner.core, np_tree(jstate), device="cpu")


@pytest.fixture(scope="module", params=["sac", "td3", "ddpg"])
def checkpoint(request):
    kind = request.param
    jcore = _jax_core(kind)
    template = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)), jnp.zeros((1, 1)))
    jstate = load_state(template, os.path.join(ZOO, kind, "pendulum", "best", "train_state.msgpack"))
    runner, tstate = _port(kind, jstate)
    return kind, jcore, jstate, runner, tstate


def test_converted_checkpoint_carries_the_whole_state(checkpoint):
    kind, _, jstate, _, tstate = checkpoint
    assert tstate.n_updates == int(jstate.n_updates) > 1_000  # a trained state, not the template
    assert tstate.policy_opt_state.count == int(jstate.policy_opt_state[0].count) > 0
    first = tstate.policy.mlp.layers[0].weight.detach().numpy()
    np.testing.assert_array_equal(first, np.asarray(jstate.policy_params["params"]["MLP_0"]["Dense_0"]["kernel"]).T)
    nu = np.asarray(jstate.policy_opt_state[0].nu["params"]["MLP_0"]["Dense_0"]["kernel"]).T
    np.testing.assert_array_equal(tstate.policy_opt_state.nu[0].numpy(), nu)
    assert nu.max() > 0
    if kind == "sac":
        assert float(tstate.log_temperature.detach()) == float(jstate.log_temperature) != 0.0
        assert tstate.temperature_opt_state.count == int(jstate.temperature_opt_state[0].count) > 0
    if kind == "td3":
        assert tstate.policy_opt_state.count == (tstate.n_updates + 1) // 2


def test_converted_checkpoint_gives_the_jax_greedy_actions(checkpoint):
    kind, jcore, jstate, runner, tstate = checkpoint
    rs = np.random.RandomState(0)
    th = rs.uniform(-np.pi, np.pi, 256)
    obs = np.stack([np.cos(th), np.sin(th), rs.uniform(-8, 8, 256)], axis=1).astype(np.float32)
    want = np.asarray(jcore.select_action(jstate, jax.random.PRNGKey(0), jnp.asarray(obs), jnp.int32(0), False))
    got = runner.core.select_action(tstate, None, torch.from_numpy(obs), 0, False).numpy()
    assert got.shape == want.shape == (256, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(want).max() > 0.5 and want.std() > 0.1  # a policy that acts


def test_converted_checkpoint_evaluates_like_the_jax_eval_loop(checkpoint):
    kind, jcore, jstate, runner, tstate = checkpoint
    jenv = jenvs.NormalizeActionSpace(jenvs.TimeLimit(jenvs.Pendulum(), 200))
    key = jax.random.PRNGKey(11)
    want = JaxEvalLoop(jenv, jcore, LANES, MAX_STEPS).evaluate(jstate, key)

    halves = [jax.random.split(k) for k in jax.random.split(jax.random.split(key)[1], LANES)]
    first = [np.array([float(jax.random.uniform(h[i], ())) for h in halves], np.float32) for i in (0, 1)]
    rs = np.random.RandomState(0)

    class StartStates:
        def uniform(self, n):
            return torch.from_numpy(first.pop(0).copy() if first else rs.uniform(size=n).astype(np.float32))

    got = EvalLoop(mac.pendulum_env("cpu"), runner.core, LANES, MAX_STEPS, device="cpu").evaluate(tstate, StartStates())
    print(f"zoo {kind}/pendulum: JaxEvalLoop mean return {want.mean():.3f}, port EvalLoop {got.mean():.3f}; "
          f"largest lane difference {np.abs(got - want).max():.4f}")
    assert got.shape == want.shape == (LANES,)
    assert np.isfinite(got).all() and (got <= 0).all()
    assert want.mean() > -400.0  # the checkpoint swings the pendulum up
    assert abs(float(got.mean()) - float(want.mean())) <= 0.01
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.01)
