"""The three AtariSim examples built on ``SmallAtariCNN``, narrow, against
the JAX package's runners on the examples' own networks:

- ACER (``examples/atari/train_acer_ale.py --sim``'s recipe,
  ``make_acer_atarisim_runner``) at the example's network (84x84x4 uint8
  frames, 6 actions, RMSprop) but 4 lanes, rows of 8 steps (3 per lane,
  sealed by filling: AtariSim's episodes average 50 steps), one batch-4
  update of whole rows per scan step from 32 transitions on, 25 scan steps
  (every lane's ring wraps; 18 updates),
  through the port's ``OffPolicyRunner`` against the JAX
  ``OffPolicyRunner.run_chunk`` on the same draws, and ``EvalLoop``
  against ``JaxEvalLoop``, with the machinery and tolerances of
  ``test_torch_acer_slice.py``;
- one iteration each of A2C (``train_a2c_ale.py --sim``: 4 lanes, rollout
  5) and PPO (``train_ppo_ale.py --sim``: 4 lanes, rollout 8, 2 epochs of
  batch 16) on AtariSim with episodes of mean length 6, through the port's
  ``OnPolicyRunner`` against the JAX ``OnPolicyRunner.run_iterations``,
  jitted, with a ``ScriptedKey`` of the port's draws
  (``test_torch_onpolicy_slice.py``; each reset's seed and length draw by
  value). Tolerances: ``t``, observations and counters exact; the update's
  metrics 1e-4 relative; parameters 2e-5 absolute.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_acer_slice import assert_acer_matches, small_acer
from test_torch_onpolicy_slice import ScriptedKey, install_scripted_keys
from test_torch_recurrent_cores import np_tree
from test_torch_recurrent_slice import assert_eval_matches, load_example
from test_torch_sac import assert_network
from test_torch_value_modules import Tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu.agents.ppo import PPOCore as JaxPPOCore
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunner as JaxOnPolicyRunner
from pfrl_tpu.experiments.onpolicy_runner import OnPolicyRunnerState as JaxOnPolicyState
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.agents import A2CCore, PPOCore
from pfrl_tpu_torch.experiments import onpolicy as onp

torch.set_num_threads(1)

LANES, EPISODE = 4, 6


# ------------------------------------------------------------------- ACER
@pytest.fixture(scope="module")
def acer():
    return small_acer("acer-atarisim")


def test_narrow_acer_atarisim_matches_the_jax_runner(acer):
    assert_acer_matches(acer, "acer-atarisim")
    storage = acer["state"].replay_state.storage
    assert storage["obs"].dtype == storage["next_obs"].dtype == torch.uint8
    assert storage["obs"].shape[2:] == (84, 84, 4) and storage["extras"]["mu_logits"].shape == (12, 8, 6)


def test_narrow_acer_atarisim_eval_loop_matches_jax(acer):
    assert_eval_matches(acer)


# -------------------------------------------------------------- on-policy
class PermutingTape(Tape):
    def permutation(self, n):
        return self._record("permutation", self.rs.permutation(n)).to(torch.int64)


def _setup(kind):
    """(JAX core, port runner, update draws per iteration)."""
    env = tenvs.AtariSim(n_actions=6, mean_episode_len=EPISODE, device="cpu")
    if kind == "a2c":
        example = load_example("examples/atari/train_a2c_ale.py")
        jcore = example.build_core(6, types.SimpleNamespace(lr=7e-4, use_gae=False, tau=0.95, bf16=False))
        return jcore, onp.make_a2c_atarisim_runner(num_envs=LANES, rollout_len=5, env=env), 0
    example = load_example("examples/atari/train_ppo_ale.py")
    jcore = JaxPPOCore(model=example.PiV(n_actions=6), optimizer=optax.adam(2.5e-4, eps=1e-5), gamma=0.99, lambd=0.95,
                       clip_eps=0.1, entropy_coef=0.01, epochs=2, minibatch_size=16, standardize_advantages=True,
                       phi=example.phi)
    return jcore, onp.make_ppo_atarisim_runner(num_envs=LANES, rollout_len=8, epochs=2, minibatch_size=16, env=env), 2


def _reset_keys(draws):
    """One reset of every lane from the log: ``[seed, u]`` per lane."""
    seed, u = draws.take("randint", "uniform")
    return jnp.asarray(np.stack([seed.astype(np.float32), u], axis=1))


def _run_jax(monkeypatch, jcore, jtrain, draws, n_update, rollout_len):
    install_scripted_keys(monkeypatch)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, minval, maxval, dtype=jnp.int32: key.astype(dtype))
    jenv = jenvs.AtariSim(n_actions=6, mean_episode_len=EPISODE)
    jrunner = JaxOnPolicyRunner(jenv, jcore, LANES, rollout_len)
    env_states, obs = VectorJaxEnv(jenv, LANES).reset(_reset_keys(draws))
    acts, envs = [], []
    for _ in range(rollout_len):
        acts.append(draws.take("uniform")[0].reshape(LANES, 6))
        reset = np.asarray(_reset_keys(draws))
        envs.append(np.concatenate([np.zeros_like(reset), reset]))
    update = np.stack(draws.take(*["permutation"] * n_update)).astype(np.int32) if n_update else np.zeros(1)
    assert not draws.log  # every draw the port made is scripted
    key = ScriptedKey(step=jnp.int32(0), iteration=jnp.int32(0), act=jnp.asarray(np.stack(acts)),
                      env=jnp.asarray(np.stack(envs)), update=jnp.asarray(update[None]))
    state = JaxOnPolicyState(
        env_states=env_states, obs=obs, train_state=jtrain, rng=key, t=jnp.int32(0),
        episode_return=jnp.zeros(LANES), recent_returns=jnp.zeros(jrunner.return_window), recent_count=jnp.int32(0),
    )
    state = jax.tree.map(lambda x: jnp.array(x, copy=True), state)
    return jrunner.run_iterations(state, 1)


@pytest.mark.parametrize("kind", ["a2c", "ppo"])
def test_one_atarisim_iteration_matches_the_jax_runner(monkeypatch, kind):
    jcore, runner, n_update = _setup(kind)
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, 84, 84, 4), jnp.uint8))
    draws = PermutingTape(0)
    state = runner.init(0, draws=draws)
    state.train_state = convert.ppo_state_from_flax(runner.core, np_tree(jtrain), device="cpu")
    state, aux = runner.run_iterations(state, 1)
    jstate, jaux = _run_jax(monkeypatch, jcore, jtrain, draws, n_update, runner.rollout_len)
    assert state.t == int(jstate.t) == LANES * runner.rollout_len
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(jstate.obs))
    assert int(state.recent_count) == int(jstate.recent_count) > 0  # episodes ended and restarted
    np.testing.assert_allclose(state.recent_returns.numpy(), np.asarray(jstate.recent_returns), rtol=0, atol=0)
    assert set(aux) == set(jaux)
    for name, got in aux.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(jaux[name]), rtol=1e-4, atol=1e-6, err_msg=name)
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates) == (1 if kind == "a2c" else 4)
    assert_network(ts.model, jts.params, 2e-5, kind)
    assert isinstance(runner.core, A2CCore if kind == "a2c" else PPOCore)
    assert state.rollout.obs.dtype == torch.uint8 and state.rollout.obs.shape == (runner.rollout_len, LANES, 84, 84, 4)
