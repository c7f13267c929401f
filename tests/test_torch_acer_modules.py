"""The modules of ACER's slice of the port against the JAX package: the
NIPS'13 torso ``SmallAtariCNN`` (through the converter, at float32 and at
bf16), the stochastic continuous ABC (a categorical draw per lane and
step, before the resets' draws), the off-policy runner's extras branch and
its ``sync_target`` guard, and the recipes' published widths.

Draws are matched by value: the ABC test's JAX keys *are* the port's
logged draws (a step key is the lane's uniforms, a reset key holds its
offset). Tolerances: the torso at float32 within 1e-6 (convolutions
reduce in another order); at bf16 within 8 bf16 ulps of the output's
largest magnitude, the Nature CNN's rule (``test_torch_precision.py``:
long float32 reductions summed in another order round to the other side
of a bf16 value in about one output of 10^5); the env exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_recurrent_cores import np_tree
from test_torch_value_modules import Tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.models import SmallAtariCNN as JaxSmallAtariCNN
from pfrl_tpu.utils import precision as jprecision
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.agents.acer import ACERContinuousCore, ACERCore
from pfrl_tpu_torch.envs.vector_env import VectorTorchEnv
from pfrl_tpu_torch.experiments import acer as acer_recipes
from pfrl_tpu_torch.experiments import onpolicy
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.models import LargeAtariCNN, SmallAtariCNN
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer
from pfrl_tpu_torch.utils.precision import apply_cast

torch.set_num_threads(1)

BF16_ULP = 2.0**-8


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(rs, b=4, c=4):
    return (rs.randint(0, 256, (b, 84, 84, c)) / 255.0).astype(np.float32)


# ------------------------------------------------------------------ torso
def _small_cnn_pair(seed=0):
    jmodel = JaxSmallAtariCNN()
    params = np_tree(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 84, 84, 4))))
    return jmodel, params, convert.load_flax_params(SmallAtariCNN(), params)


def test_small_atari_cnn_has_the_nips_layers_and_flax_scopes():
    cnn = SmallAtariCNN()
    shapes = {k: tuple(p.shape) for k, p in cnn.named_parameters()}
    assert shapes == {"convs.0.weight": (16, 4, 8, 8), "convs.0.bias": (16,), "convs.1.weight": (32, 16, 4, 4),
                      "convs.1.bias": (32,), "dense.weight": (256, 2592), "dense.bias": (256,)}
    assert cnn.flax_names() == {"convs.0": "Conv_0", "convs.1": "Conv_1", "dense": "Dense_0"}
    assert all(bool((b == np.float32(0.1)).all()) for n, b in cnn.named_parameters() if n.endswith("bias"))
    # Chainer's default: untruncated LeCun normal, std sqrt(1 / fan_in).
    gen = torch.Generator().manual_seed(0)
    cnn.reset_parameters(gen)
    w = cnn.convs[0].weight.detach()
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 0.003 and float(w.abs().max()) > 2.5 * (1 / 256) ** 0.5
    assert [c.stride for c in cnn.convs] == [(4, 4), (2, 2)]
    # The Nature torso keeps its layers.
    assert [tuple(c.weight.shape) for c in LargeAtariCNN().convs] == [(32, 4, 8, 8), (64, 32, 4, 4), (64, 64, 3, 3)]


def test_small_atari_cnn_matches_flax_at_float32():
    jmodel, params, tmodel = _small_cnn_pair()
    x = _frames(np.random.RandomState(1), b=5)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(_t(x)).numpy()
    assert got.shape == want.shape == (5, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want > 0).mean() > 0.3  # the ReLU keeps a good share


def test_small_atari_cnn_matches_flax_at_bf16():
    """bf16 compute over the float32 weights against the JAX package's
    ``apply_cast`` run eagerly."""
    jmodel, params, tmodel = _small_cnn_pair(2)
    x = _frames(np.random.RandomState(3), b=6)
    with jax.disable_jit():
        want = np.asarray(jprecision.apply_cast(jmodel, params, jnp.bfloat16, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = apply_cast(tmodel, torch.bfloat16, _t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * BF16_ULP * float(np.abs(want).max()))
    # It did compute in bf16: the float32 forward lies further off.
    with torch.no_grad():
        full = tmodel(_t(x)).numpy()
    assert float(np.abs(full - want).max()) > 4 * float(np.abs(got.numpy() - want).max())


# ---------------------------------------------------- the stochastic ABC
def _install_abc_value_keys(monkeypatch):
    """A 2-D key is the rows of a split; a lane's 1-D key is its values:
    the uniforms of its categorical draw, or its reset's offset first."""

    def split(key, num=2):
        if key.ndim == 2:
            assert key.shape[0] == num, (key.shape, num)
            return key
        return jnp.stack([key] * num)

    def categorical(key, logits, axis=-1, shape=None):
        u = jnp.maximum(jnp.finfo(logits.dtype).tiny, key)
        return jnp.argmax(logits - jnp.log(-jnp.log(u)), axis=-1)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        return key[0].astype(dtype)

    for name, fn in (("split", split), ("categorical", categorical), ("randint", randint)):
        monkeypatch.setattr(jax.random, name, fn)


def test_stochastic_continuous_abc_matches_jax_and_draws_before_the_resets(monkeypatch):
    lanes, size = 6, 3
    kw = dict(size=size, discrete=False, partially_observable=True)
    tape = Tape(4)
    tenv = VectorTorchEnv(tenvs.ABC(device="cpu", **kw), lanes)
    assert tenv.env.draws_on_step and not tenvs.ABC(discrete=False, deterministic=True, device="cpu").draws_on_step
    tstate, tobs = tenv.reset(tape)
    _install_abc_value_keys(monkeypatch)
    jenv = VectorJaxEnv(jenvs.ABC(**kw), lanes)

    def reset_keys(offsets):
        return jnp.stack([jnp.asarray(offsets, jnp.float32)] + [jnp.zeros(lanes)] * (size - 1), axis=1)

    jstate, jobs = jenv.reset(reset_keys(tape.take("randint")[0]))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    rs = np.random.RandomState(5)
    jstep = jax.jit(jenv.step)
    ends = rewards = 0
    for i in range(12):
        actions = rs.uniform(-1.5, 1.5, (lanes, size)).astype(np.float32)
        actions[:, 0] += 1.0  # favour the first link of the chain
        tstate, tvec = tenv.step(tape, tstate, _t(actions))
        u, offsets = tape.take("uniform", "randint")  # the step's draw first, then the resets'
        assert u.shape == (lanes * size,) and offsets.shape == (lanes,)
        keys = jnp.concatenate([jnp.asarray(u.reshape(lanes, size)), reset_keys(offsets)])
        jstate, jvec = jstep(keys, jstate, jnp.asarray(actions))
        for got, want in ((tvec.obs, jvec.obs), (tvec.ts.obs, jvec.ts.obs), (tvec.ts.reward, jvec.ts.reward),
                          (tvec.ts.terminated, jvec.ts.terminated), (tstate.s, jstate.s),
                          (tstate.offset, jstate.offset)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"step {i}")
        ends += int(tvec.ts.done.sum())
        rewards += float(tvec.ts.reward.sum())
    assert not tape.log and ends > lanes and rewards > 0


# ------------------------------------------------------------------ runner
def _small_acer(target_update_interval, core=None):
    env = tenvs.ABC(size=3, deterministic=True, device="cpu")
    core = core or acer_recipes.make_acer_abc_runner(hidden=8, device="cpu")[0].core
    buffer = EpisodicReplayBuffer(12, 5, num_lanes=4, device="cpu")
    config = RunnerConfig(num_envs=4, replay_start_size=8, update_interval=4,
                          target_update_interval=target_update_interval, minibatch_size=4)
    return OffPolicyRunner(env, core, buffer, config, device="cpu")


class _CountedSync(ACERCore):
    """ACER with a ``sync_target`` that only counts its calls."""

    syncs = 0

    def sync_target(self, state):
        type(self).syncs += 1


def test_runner_skips_the_sync_of_a_core_without_a_target_across_the_interval():
    runner = _small_acer(target_update_interval=8)
    assert not hasattr(runner.core, "sync_target") and runner.acts_with_extras
    state, metrics = runner.run_chunk(runner.init(0), 7)  # t = 28: three crossings of the interval
    assert state.t == 28 and state.train_state.n_updates == 6
    assert torch.isfinite(metrics["loss"]).all()
    # The guard is on the core, not on the interval: a core that has one is synced.
    base = runner.core
    counted = _CountedSync(base.model, base.optimizer, gamma=base.gamma)
    state, _ = _small_acer(8, counted).run_chunk(_small_acer(8, counted).init(0), 7)
    assert _CountedSync.syncs == 3


def test_runner_stores_the_behaviour_with_each_transition():
    for make, keys in ((acer_recipes.make_acer_abc_runner, {"mu_logits": (3,)}),
                       (acer_recipes.make_acer_continuous_abc_runner, {"mu_mean": (2,), "mu_std": (2,)})):
        runner, loop = make(hidden=8, device="cpu", num_envs=4, max_episodes=12, replay_start_size=8,
                            update_interval=4, minibatch_size=4)
        tape = Tape(0)
        state = runner.init(0, draws=tape)
        assert not tape.log  # sizing the extras draws from a source of its own
        extras = state.replay_state.storage["extras"]
        E, L = runner.buffer.max_episodes, runner.buffer.max_episode_len
        assert {k: tuple(v.shape) for k, v in extras.items()} == {k: (E, L) + s for k, s in keys.items()}
        assert all(v.dtype == torch.float32 for v in extras.values())
        state, _ = runner.run_chunk(state, 4)
        written = state.replay_state.ep_len > 0
        if "mu_logits" in extras:  # normalised log-probs
            probs = extras["mu_logits"][written][:, 0].exp().sum(-1)
            np.testing.assert_allclose(probs.numpy(), 1.0, rtol=1e-6)
        else:
            assert (extras["mu_std"][written][:, 0] > 0).all()
        assert isinstance(loop, EvalLoop) and loop.evaluate(state.train_state, tape).shape == (10,)


# ----------------------------------------------------------------- recipes
def test_recipes_hold_the_published_widths_and_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (*acer_recipes.RECIPES.values(), onpolicy.make_a2c_atarisim_runner,
                 onpolicy.make_ppo_atarisim_runner):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    runner, loop = acer_recipes.make_acer_atarisim_runner(device="cpu", max_episodes=48)
    cfg, buf, core = runner.config, runner.buffer, runner.core
    assert isinstance(core, ACERCore) and isinstance(core.model.torso, SmallAtariCNN)
    assert (runner.env.env.n_actions, runner.env.env.mean_episode_len, runner.env.env.frame_shape) == (6, 50, (84, 84, 4))
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.minibatch_size, cfg.updates_per_step,
            cfg.target_update_interval) == (16, 10_000, 16, 16, 1, 10**9)
    assert (buf.max_episode_len, buf.subseq_len) == (50, None)
    assert (core.optimizer.learning_rate, core.optimizer.decay, core.optimizer.eps) == (7e-4, 0.99, 1e-2)
    assert (core.gamma, core.beta, core.c, core.use_trust_region, core.delta, core.alpha, core.use_Q_opc) == \
        (0.99, 1e-2, 10.0, True, 0.1, 0.99, False)
    assert (loop.env.num_envs, loop.max_steps) == (5, 500)
    runner, loop = acer_recipes.make_acer_abc_runner(device="cpu")
    cfg, buf = runner.config, runner.buffer
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.minibatch_size) == (16, 128, 16, 16)
    assert (buf.max_episodes, buf.max_episode_len) == (512, 5) and runner.core.model.hidden.out_features == 64
    assert (runner.core.gamma, runner.core.beta, runner.core.optimizer.learning_rate) == (0.9, 1e-2, 5e-3)
    assert (loop.env.num_envs, loop.max_steps) == (10, 5)
    runner, loop = acer_recipes.make_acer_continuous_abc_runner(device="cpu")
    core, env = runner.core, runner.env.env
    assert isinstance(core, ACERContinuousCore) and not env.discrete and env.deterministic and env.size == 2
    assert (runner.buffer.max_episodes, runner.buffer.max_episode_len) == (512, 4)
    assert (core.gamma, core.beta, core.n_sdn, core.c, core.use_Q_opc) == (0.9, 1e-3, 5, 5.0, True)
    assert core.model.pi.hidden.out_features == core.model.vf.hidden.out_features == 32
    assert (loop.env.num_envs, loop.max_steps) == (10, 4)
    a2c = onpolicy.make_a2c_atarisim_runner(device="cpu")
    assert (a2c.num_envs, a2c.rollout_len, a2c.core.use_gae, a2c.core.gamma) == (16, 5, False, 0.99)
    inner = a2c.core.optimizer.inner
    assert (a2c.core.optimizer.max_norm, inner.learning_rate, inner.decay, inner.eps) == (40.0, 7e-4, 0.99, 1e-5)
    assert isinstance(a2c.core.model.torso, SmallAtariCNN) and a2c.core.value_func_coef == 0.5
    ppo = onpolicy.make_ppo_atarisim_runner(device="cpu")
    assert (ppo.num_envs, ppo.rollout_len, ppo.core.epochs, ppo.core.minibatch_size, ppo.core.clip_eps) == \
        (8, 128, 4, 256, 0.1)
    assert (ppo.core.optimizer.learning_rate, ppo.core.optimizer.eps, ppo.core.entropy_coef) == (2.5e-4, 1e-5, 0.01)
