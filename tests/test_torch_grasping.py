"""``examples/grasping/train_dqn_batch_grasping.py`` in the port
(``experiments/grasping_dqn_batch.py``, ``envs/synthetic_grasping.py``)
against the JAX script: the network from converted flax parameters, the
synthetic env, the recipe's settings, the ``DoubleDQN`` shell over PER with
``(image, steps)`` observations through the batch driver (acts, observes,
three updates, one evaluation), the recipe over ``SerialVectorEnv`` and
spawned workers, workers that import no torch, and the pybullet branch.

Tolerances: the network's Q-values within 1e-5 of their largest magnitude
(float32 convolutions and a 3,136-long dot summed in other orders); at
bf16 within 8 bf16 ulps of it. The env's observations, the actions, the
counts and the evaluation rows exactly; the statistics within 1e-5
relative; parameters, targets and Adam's moments within 3e-6 (second
moments 1e-5 of their largest), or 4x what ulp nudges of the starting
weights move them (``test_torch_host_agents.assert_dqn_states_close``).
The JAX shell runs under ``jax.disable_jit`` on the port's logged draws
(``Tape``/``install_tape``, C29); its PER finds slots by its XLA tree
descent, the port's by the prefix-sample kernel's plain version.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_host_agents import NUDGES, assert_dqn_states_close, assert_stats_close, new_log, record, scale_weights
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu import experiments as jexperiments
from pfrl_tpu.agents import DoubleDQN as JaxDoubleDQN
from pfrl_tpu.envs import SerialVectorEnv as JaxSerialVectorEnv
from pfrl_tpu.explorers import LinearDecayEpsilonGreedy as JaxLinearDecay
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.utils.precision import apply_cast as jax_apply_cast
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.envs import SerialVectorEnv
from pfrl_tpu_torch.envs.synthetic_grasping import SyntheticGraspingEnv, make_grasping_env
from pfrl_tpu_torch.experiments import grasping_dqn_batch, train_agent_batch_with_evaluation
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer
from pfrl_tpu_torch.utils.batch_states import leaves, to_device_like_jax
from pfrl_tpu_torch.utils.precision import apply_cast

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_example():
    path = os.path.join(REPO, "examples/grasping/train_dqn_batch_grasping.py")
    spec = importlib.util.spec_from_file_location("train_dqn_batch_grasping", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EXAMPLE = load_example()


def _observations(seed, n):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(0.0, 1.1, (84, 84, 3)).astype(np.float32), int(rs.randint(9))) for _ in range(n)]


def _flax_params(seed=0):
    net = EXAMPLE.GraspingQFunction(n_actions=10, max_episode_steps=8)
    example = (jnp.zeros((1, 84, 84, 3)), jnp.zeros((1,), jnp.int32))
    return net, net.init(jax.random.PRNGKey(seed), example)


def _both_forwards(dtype=None):
    net, params = _flax_params()
    q = grasping_dqn_batch.GraspingQFunction(10, 8)
    convert.load_flax_params(q, np_tree(params))
    collated = EXAMPLE_COLLATE(_observations(1, 6))
    got = apply_cast(q, dtype, to_device_like_jax(collated, "cpu")).q_values.detach().numpy()
    with jax.disable_jit():
        want = jax_apply_cast(net, params, jnp.bfloat16 if dtype else None, jax.tree.map(jnp.asarray, collated))
    return got, np.asarray(want.q_values), q, params


def EXAMPLE_COLLATE(batch):
    from pfrl_tpu.agents.dqn import _collate_obs

    return _collate_obs(batch)


def test_network_matches_the_examples_from_converted_params():
    got, want, q, params = _both_forwards()
    assert sum(p.numel() for p in q.parameters()) == 1_715_434
    assert sum(x.size for x in jax.tree.leaves(params)) == 1_715_434
    assert np_tree(params)["params"]["Embed_0"]["embedding"].shape == (9, 3136)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_the_gate_multiplies_features_in_nhwc_order():
    """The embedding's 3,136 columns gate the features in flax's (H, W, C)
    order: gating the NCHW flatten instead (and permuting only before the
    Dense) moves the Q-values far past rounding."""
    got, want, q, _ = _both_forwards()
    image, steps = to_device_like_jax(EXAMPLE_COLLATE(_observations(1, 6)), "cpu")
    with torch.no_grad():
        h = image.permute(0, 3, 1, 2)
        for i, conv in enumerate(q.convs):
            h = conv(h)
            h = torch.relu(h) if i < 2 else h
        nchw = h.reshape(h.shape[0], -1) * torch.sigmoid(q.embedding[steps.long()])
        nhwc = nchw.reshape(h.shape).permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        wrong = q.out(torch.relu(q.dense(nhwc))).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(wrong - want).max() > 1e-3 * scale > np.abs(got - want).max()


def test_bf16_forward_keeps_the_steps_int32_and_matches_jax():
    got, want, _, _ = _both_forwards(torch.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2.0**-8 * float(np.abs(want).max()))


def test_init_follows_flaxs_defaults():
    q = grasping_dqn_batch.GraspingQFunction(10, 8)
    q.reset_parameters(torch.Generator().manual_seed(0))
    for layer in (*q.convs, q.dense, q.out):
        w = layer.weight
        std = (1.0 / (w[0].numel())) ** 0.5
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7  # truncated at 2 std
        assert abs(float(w.std()) - std) < 0.1 * std and float(layer.bias.abs().max()) == 0.0
    assert abs(float(q.embedding.std()) - 3136**-0.5) < 0.05 * 3136**-0.5


def test_synthetic_env_matches_the_examples():
    for seed in (0, 7):
        a, b = SyntheticGraspingEnv(seed=seed), EXAMPLE.SyntheticGraspingEnv(seed=seed)
        rs = np.random.RandomState(seed)
        oa, ob = a.reset(), b.reset()
        for _ in range(30):
            np.testing.assert_array_equal(oa[0], ob[0])
            assert oa[1] == ob[1] and isinstance(oa[1], int)
            act = rs.randint(10)
            (oa, ra, da, _), (ob, rb, db, _) = a.step(act), b.step(act)
            assert (ra, da) == (rb, db)
            if da:
                oa, ob = a.reset(), b.reset()


def test_recipe_holds_the_scripts_settings(monkeypatch, tmp_path):
    """The script's ``main`` and the port's ``run`` with their drivers
    replaced: the agents' settings and the drivers' arguments agree."""
    captured = {}

    def capture(which):
        def driver(agent, env, **kw):
            captured[which] = (agent, env, kw)
            return agent, []
        return driver

    monkeypatch.setattr(jexperiments, "train_agent_batch_with_evaluation", capture("jax"))
    monkeypatch.setattr(grasping_dqn_batch, "train_agent_batch_with_evaluation", capture("port"))
    monkeypatch.setattr(sys, "argv", ["train_dqn_batch_grasping.py", "--jax-env", "--serial-envs",
                                      "--outdir", str(tmp_path)])
    EXAMPLE.main()
    grasping_dqn_batch.run(["--jax-env", "--serial-envs", "--outdir", str(tmp_path)], device="cpu")
    (jagent, jenv, jkw), (tagent, tenv, tkw) = captured["jax"], captured["port"]
    assert {k: v for k, v in jkw.items() if k not in ("eval_env",)} == \
        {k: v for k, v in tkw.items() if k not in ("eval_env",)}
    assert tkw["log_interval"] == 1000 and tkw["eval_n_episodes"] == 100 and tkw["steps"] == 2 * 10**6
    assert type(tagent).__name__ == type(jagent).__name__ == "DoubleDQN"
    jbuf, tbuf = jagent.buffer, tagent.buffer
    assert isinstance(tbuf, PrioritizedReplayBuffer)
    for attr in ("capacity", "alpha", "beta0", "beta_add", "eps", "normalize_by_max", "error_min", "error_max",
                 "num_steps", "gamma", "num_lanes", "store_next_obs", "fused_dequant_scale"):
        assert getattr(tbuf, attr) == getattr(jbuf, attr), attr
    assert tbuf.capacity == 10**6 and tbuf.tree_capacity == 2**20
    for attr in ("replay_start_size", "minibatch_size", "update_interval", "target_update_interval",
                 "n_times_update", "gamma"):
        assert getattr(tagent, attr) == getattr(jagent, attr), attr
    tex, jex = tagent.core.explorer, jagent.core.explorer
    assert (tex.start_epsilon, tex.end_epsilon, tex.decay_steps, tex.n_actions) == \
        (jex.start_epsilon, jex.end_epsilon, jex.decay_steps, jex.n_actions) == (1.0, 0.2, 5 * 10**5, 10)
    assert (tagent.core.optimizer.learning_rate, tagent.core.optimizer.eps) == (6.25e-5, 1e-8)
    assert tenv.num_envs == jenv.num_envs == 1
    for env in (tenv, jenv, tkw["eval_env"], jkw["eval_env"]):
        env.close()


SMALL = dict(capacity=64, replay_start_size=32, target_update_interval=33, final_exploration_steps=40)


def _jax_shell():
    jagent = JaxDoubleDQN(
        EXAMPLE.GraspingQFunction(n_actions=10, max_episode_steps=8), optax.adam(6.25e-5),
        JaxPER(SMALL["capacity"], alpha=0.6, beta0=0.4, betasteps=2 * 10**6, gamma=0.99), 0.99,
        JaxLinearDecay(1.0, 0.2, SMALL["final_exploration_steps"], 10),
        replay_start_size=SMALL["replay_start_size"], minibatch_size=32, update_interval=1,
        target_update_interval=SMALL["target_update_interval"])
    jagent._ensure_init((np.zeros((1, 84, 84, 3), np.float32), np.zeros((1,), np.int32)))
    return jagent


def test_shell_matches_the_examples_through_the_batch_driver(tmp_path):
    """Acts, observes (the ring's two leaves), three updates over PER, the
    target sync at 33 and one evaluation of two episodes."""
    jagent = _jax_shell()
    jstate = np_tree(jagent.train_state)
    kw = dict(steps=34, eval_n_steps=None, eval_n_episodes=2, eval_interval=34)

    def port_run(scale, outdir):
        tape, log = Tape(21), new_log()
        tagent = grasping_dqn_batch.make_grasping_agent(device="cpu", draws=tape, **SMALL)
        scale_weights(convert.dqn_shell_from_flax(tagent, jstate), scale)
        env = SerialVectorEnv([SyntheticGraspingEnv(seed=3)])
        eval_env = SerialVectorEnv([SyntheticGraspingEnv(seed=4)])
        train_agent_batch_with_evaluation(record(tagent, log), env, outdir=outdir, eval_env=eval_env, **kw)
        return tagent, tape, log

    tagent, tape, tlog = port_run(1.0, str(tmp_path / "port"))
    nudged = [port_run(s, str(tmp_path / f"nudged{i}"))[0] for i, s in enumerate(NUDGES)]
    storage = tagent.replay_state.base.storage
    assert [(x.shape, x.dtype) for x in leaves(storage["obs"])] == [
        ((64, 21_248), torch.float32), ((64,), torch.int32)]
    jlog = new_log()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jexperiments.train_agent_batch_with_evaluation(
            record(jagent, jlog), JaxSerialVectorEnv([EXAMPLE.SyntheticGraspingEnv(seed=3)]),
            outdir=str(tmp_path / "jax"), eval_env=JaxSerialVectorEnv([EXAMPLE.SyntheticGraspingEnv(seed=4)]), **kw)
        assert not tape.log
    assert len(tlog["actions"]) == len(jlog["actions"]) > 34
    for got, want in zip(tlog["actions"], jlog["actions"]):
        np.testing.assert_array_equal(got, want)
    jring = jagent.replay_state.base.storage
    for name in ("obs", "next_obs"):
        for got, want in zip(leaves(storage[name]), jax.tree.leaves(getattr(jring, name))):
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tlog["syncs"] == jlog["syncs"] == 1
    assert tagent.t == jagent.t == 34 and tagent.optim_t == jagent.optim_t == 3
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics())
    from test_torch_host_agents import assert_same_scores

    assert_same_scores(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_dqn_states_close(tagent, jagent, nudged, "grasping")


@pytest.mark.parametrize("serial", [True, False])
def test_recipe_runs_to_a_few_updates(tmp_path, serial):
    """``run`` at the script's widths with small sizes: over a
    ``SerialVectorEnv`` and over one spawned worker each for training and
    evaluation; then ``--load`` and ``--demo``."""
    flags = ["--jax-env", "--steps", "40", "--replay-start-size", "32", "--replay-capacity", "64",
             "--eval-interval", "40", "--eval-n-runs", "2", "--outdir", str(tmp_path / "run")]
    agent, (_, history) = grasping_dqn_batch.run(flags + (["--serial-envs"] if serial else []), device="cpu")
    assert agent.t == 40 and agent.optim_t == 9 and len(history) == 1
    assert np.isfinite(history[0]["eval_score"])
    assert agent.buffer.tree_capacity == 64
    if serial:
        agent.save(str(tmp_path / "agent"))
        loaded, stats = grasping_dqn_batch.run(
            ["--jax-env", "--serial-envs", "--load", str(tmp_path / "agent"), "--demo", "--eval-n-runs", "3"],
            device="cpu")
        assert stats["episodes"] == 3
        for a, b in zip(loaded.train_state.model.parameters(), agent.train_state.model.parameters()):
            assert torch.equal(a, b)


def test_grasping_workers_import_no_torch(tmp_path):
    """The spawned workers of the recipe's vector env unpickle
    ``make_grasping_env`` and load no torch."""
    (tmp_path / "probe_grasping.py").write_text(
        "import sys\n"
        "from pfrl_tpu_torch.envs.synthetic_grasping import make_grasping_env\n"
        "class Probe:\n"
        "    def __init__(self, i):\n"
        "        self.env = make_grasping_env(True, 8, i, False)\n"
        "        self.observation_space = self.env.observation_space\n"
        "        self.action_space = self.env.action_space\n"
        "    def reset(self):\n"
        "        return self.env.reset()\n"
        "    def step(self, a):\n"
        "        return self.env.step(a)\n"
        "    def seed(self, s):\n"
        "        return sorted(m for m in sys.modules if m.split('.')[0] == 'torch')\n"
        "    def close(self):\n"
        "        pass\n"
    )
    code = (
        "import functools\n"
        "import torch\n"
        "from pfrl_tpu_torch.envs import MultiprocessVectorEnv\n"
        "import probe_grasping\n"
        "env = MultiprocessVectorEnv([functools.partial(probe_grasping.Probe, i) for i in range(2)])\n"
        "obs = env.reset(); obs, r, d, _ = env.step([1, 2])\n"
        "assert obs[0][0].shape == (84, 84, 3) and obs[0][1] == 1, obs[0][1]\n"
        "assert env.seed([0, 0]) == [[], []], env.seed([0, 0])\n"
        "env.close()\n"
        "print('workers without torch')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(REPO)])})
    assert out.returncode == 0 and "workers without torch" in out.stdout, out.stderr


def test_the_pybullet_branch_raises_by_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "pybullet_envs", None)  # absent, wherever it is installed
    with pytest.raises(RuntimeError, match="pybullet.*--jax-env"):
        make_grasping_env(False, 8, 0, False)
    with pytest.raises(RuntimeError, match="pybullet"):
        grasping_dqn_batch.run(["--serial-envs"], device="cpu")
    args = EXAMPLE.argparse.Namespace(jax_env=False, max_episode_steps=8, render=False, demo=False)
    with pytest.raises(RuntimeError, match="pybullet.*--jax-env"):
        EXAMPLE.make_env(args, 0, False)


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        grasping_dqn_batch.make_grasping_agent(capacity=64)
    assert grasping_dqn_batch.make_grasping_agent(capacity=64, device="cpu").device == torch.device("cpu")
    assert functools.partial(make_grasping_env, True, 8)(0, False).max_episode_steps == 8
