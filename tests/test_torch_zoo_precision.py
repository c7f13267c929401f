"""The converted-zoo gate for the two bf16 checkpoints of ``zoo/``:
``dqn_bf16/cartpole`` (``run_dqn_cartpole_bf16``) and
``sac_bf16/pendulum`` (``run_sac_pendulum_bf16``), each trained by
``tools/record_curves.py`` at ``compute_dtype=jnp.bfloat16`` over float32
masters. Each is restored by the JAX package, handed to the port's
converter as a numpy tree and evaluated by the port at
``compute_dtype=torch.bfloat16`` (``make_dqn_cartpole_bf16_runner``,
``make_sac_pendulum_bf16_runner``), against the JAX core at bf16.

The JAX side runs eagerly (``jax.disable_jit``): there each op rounds to
bf16 as the port's do, and the MLPs' bf16 forwards are bit-equal
(``test_torch_precision.py``). Jitted, XLA keeps float32 inside its
fusions; a trained CartPole Q-network's two Q-values near 100 lie within
one bf16 ulp (0.5) of each other in many states, so excess precision
alone would pick other actions.

(a) The checkpoint's masters and moments are float32 and convert whole.
(b) Greedy actions on 256 seeded observations: DQN's equal (ties
    included: both take the first of equal bf16 Q-values); SAC's within
    1e-6 (``tanh`` of a float32 mean, an ulp apart in the two libraries).
(c) ``EvalLoop`` from ``JaxEvalLoop``'s start states on a real key,
    against that JAX run: DQN's lanes equal, and the mean at least 300,
    the bound of its float32 sibling (``test_torch_zoo_value.py``); SAC's
    mean within 0.01 and each lane within 1e-4 relative + 0.01, and JAX's
    mean above -400, as its float32 sibling
    (``test_torch_zoo_actor_critic.py``).

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
from test_torch_actor_critic_modules import JaxSACPolicy, np_tree
from test_torch_cartpole_value_slice import port_state
from test_torch_value_modules import cartpole_obs
from test_torch_zoo_value import _start_states as cartpole_start_states

from pfrl_tpu import envs as jenvs
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.agents import DQNCore as JaxDQN
from pfrl_tpu.agents.soft_actor_critic import SACCore as JaxSAC
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.replay.persistent import load_state
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.experiments import cartpole_value as cv
from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
from pfrl_tpu_torch.experiments.runner import EvalLoop

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zoo")
KINDS = ("dqn_bf16/cartpole", "sac_bf16/pendulum")


def _jax_core(kind):
    """The recipe ``tools/record_curves.py`` trained, at bf16."""
    if kind.startswith("dqn"):
        return JaxDQN(
            model=jq.FCStateQFunctionWithDiscreteAction(n_actions=2, n_hidden_channels=100, n_hidden_layers=2),
            optimizer=optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-3)),
            explorer=jexplorers.LinearDecayEpsilonGreedy(1.0, 0.05, 50_000, 2), gamma=0.99,
            compute_dtype=jnp.bfloat16,
        )
    qf = lambda: jq.FCSAQFunction(n_hidden_layers=2, n_hidden_channels=256)  # noqa: E731
    return JaxSAC(
        policy=JaxSACPolicy(act_dim=1, hidden=256), q_func1=qf(), q_func2=qf(), policy_optimizer=optax.adam(3e-4),
        q_func1_optimizer=optax.adam(3e-4), q_func2_optimizer=optax.adam(3e-4), gamma=0.99, entropy_target=-1.0,
        compute_dtype=jnp.bfloat16,
    )


@functools.lru_cache(maxsize=None)
def checkpoint(kind):
    jcore = _jax_core(kind)
    path = os.path.join(ZOO, kind, "best", "train_state.msgpack")
    if kind.startswith("dqn"):
        jstate = load_state(jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, 4))), path)
        runner, loop = cv.make_dqn_cartpole_bf16_runner(device="cpu", capacity=1_024)
        return jcore, jstate, runner.core, port_state(runner.core, jstate)
    jstate = load_state(jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)), jnp.zeros((1, 1))), path)
    runner = mac.make_sac_pendulum_bf16_runner(device="cpu", capacity=1_024)
    return jcore, jstate, runner.core, convert.sac_state_from_flax(runner.core, np_tree(jstate), device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_checkpoint_holds_float32_masters_and_converts_whole(kind):
    jcore, jstate, core, tstate = checkpoint(kind)
    assert core.compute_dtype is torch.bfloat16
    leaves = jax.tree.leaves(np_tree(jstate))
    assert {str(a.dtype) for a in leaves if np.issubdtype(a.dtype, np.floating)} == {"float32"}
    assert tstate.n_updates == int(jstate.n_updates) > 1_000  # a trained state, not the template
    if kind.startswith("dqn"):
        adam = jstate.opt_state[1][0]  # after clip_by_global_norm
        modules = {"model": (tstate.model, jstate.params), "target_model": (tstate.target_model, jstate.target_params)}
        opt = tstate.opt_state
    else:
        adam = jstate.policy_opt_state[0]
        modules = {"policy": (tstate.policy, jstate.policy_params), "q_func1": (tstate.q_func1, jstate.q1_params)}
        opt = tstate.policy_opt_state
        assert float(tstate.log_temperature.detach()) == float(jstate.log_temperature) != 0.0
    for name, (module, tree) in modules.items():
        want = convert.torch_arrays(module, np_tree(tree))
        for pname, p in module.named_parameters():
            assert p.dtype == torch.float32
            np.testing.assert_array_equal(p.detach().numpy(), want[pname], err_msg=f"{kind} {name}.{pname}")
    assert opt.count == int(adam.count) > 0
    for m in opt.mu + opt.nu:
        assert m.dtype == torch.float32
    assert float(opt.nu[0].abs().max()) > 0


def _observations(kind):
    rs = np.random.RandomState(0)
    if kind.startswith("dqn"):
        return cartpole_obs(rs, 256)
    th = rs.uniform(-np.pi, np.pi, 256)
    return np.stack([np.cos(th), np.sin(th), rs.uniform(-8, 8, 256)], axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_checkpoint_gives_the_jax_greedy_actions_at_bf16(kind):
    jcore, jstate, core, tstate = checkpoint(kind)
    obs = _observations(kind)
    with jax.disable_jit():
        want = np.asarray(jcore.select_action(jstate, jax.random.PRNGKey(3), jnp.asarray(obs), jnp.int32(0), False))
    got = core.select_action(tstate, None, torch.from_numpy(obs), 0, False).numpy()
    assert got.shape == want.shape
    if kind.startswith("dqn"):
        np.testing.assert_array_equal(got, want)
        assert 0 < want.mean() < 1  # both actions taken
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert np.abs(want).max() > 0.5 and want.std() > 0.1  # a policy that acts


def _pendulum_start_states(key, lanes):
    """``JaxEvalLoop``'s start states on ``key`` by value, then seeded draws."""
    halves = [jax.random.split(k) for k in jax.random.split(jax.random.split(key)[1], lanes)]
    first = [np.array([float(jax.random.uniform(h[i], ())) for h in halves], np.float32) for i in (0, 1)]
    rs = np.random.RandomState(0)

    class StartStates:
        def uniform(self, n):
            return torch.from_numpy(first.pop(0).copy() if first else rs.uniform(size=n).astype(np.float32))

    return StartStates()


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_checkpoint_evaluates_like_the_jax_eval_loop(kind):
    jcore, jstate, core, tstate = checkpoint(kind)
    key = jax.random.PRNGKey(11)
    lanes = 10
    if kind.startswith("dqn"):
        jenv, max_steps = jenvs.TimeLimit(jenvs.CartPole(), 500), 501
        env, start = tenvs.TimeLimit(tenvs.CartPole(device="cpu"), 500), cartpole_start_states(key)
    else:
        jenv, max_steps = jenvs.NormalizeActionSpace(jenvs.TimeLimit(jenvs.Pendulum(), 200)), 201
        env, start = mac.pendulum_env("cpu"), _pendulum_start_states(key, lanes)
    with jax.disable_jit():
        want = JaxEvalLoop(jenv, jcore, lanes, max_steps).evaluate(jstate, key)
    got = EvalLoop(env, core, lanes, max_steps, device="cpu").evaluate(tstate, start)
    print(f"zoo {kind} at bf16: JaxEvalLoop mean return {want.mean():.3f}, port EvalLoop {got.mean():.3f}; "
          f"largest lane difference {np.abs(got - want).max():.4f}")
    assert got.shape == want.shape == (lanes,) and np.isfinite(got).all()
    if kind.startswith("dqn"):
        np.testing.assert_array_equal(got, want)
        assert want.mean() >= 300.0
    else:
        assert want.mean() > -400.0 and (got <= 0).all()
        assert abs(float(got.mean()) - float(want.mean())) <= 0.01
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.01)
