"""The port's recipes of the host-env examples against the examples
themselves: ``experiments/mujoco_host.py`` (the five MuJoCo reproduction
scripts), ``experiments/slimevolley_rainbow.py`` and
``experiments/env_cli.py``.

Each example's ``main`` runs with ``--jax-env`` and the port's ``run_*``
with ``--torch-env`` (``device="cpu"``), each package's driver replaced by
one that keeps its arguments. Then:

(a) the shells' settings are equal, attribute by attribute, and so are the
    drivers' arguments;
(b) the JAX shell's initial state converts into the port's
    (``convert.actor_critic_shell_from_flax``,
    ``onpolicy_shell_from_flax``, ``dqn_shell_from_flax``), which fails on
    any difference of widths or layers, and the greedy actions of both in
    evaluation mode agree within 1e-5 on 64 observations (Rainbow's on the
    same noise, by value, exactly);
(c) ``--num-envs``, ``--bf16``, ``--load`` and ``--demo`` take the
    branches the scripts take; TRPO refuses ``--bf16`` by name;
(d) ``make_backend_env`` builds gymnasium's env wrapped as the JAX
    package's is and raises naming an unavailable id, never substituting an
    env; ``MultiBinaryAsDiscreteAction`` against a stub env (``gym`` and
    ``slimevolleygym`` are not installed here).

The shells' learning is held against the JAX shells at small widths in
``test_torch_host_actor_critic.py``, ``test_torch_host_onpolicy.py`` and
``test_torch_host_value_shells.py``.
"""

import importlib.util
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, install_tape

import pfrl_tpu.experiments as jexperiments
from pfrl_tpu.experiments.env_cli import make_backend_env as jax_make_backend_env
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.envs import SerialVectorEnv
from pfrl_tpu_torch.experiments import env_cli, mujoco_host, slimevolley_rainbow
from pfrl_tpu_torch.experiments.slimevolley_rainbow import DistributionalDuelingMLPHead, MultiBinaryAsDiscreteAction

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {
    "sac": "examples/mujoco/reproduction/soft_actor_critic/train_soft_actor_critic.py",
    "td3": "examples/mujoco/reproduction/td3/train_td3.py",
    "ddpg": "examples/mujoco/reproduction/ddpg/train_ddpg.py",
    "ppo": "examples/mujoco/reproduction/ppo/train_ppo.py",
    "trpo": "examples/mujoco/reproduction/trpo/train_trpo.py",
    "rainbow": "examples/slimevolley/train_rainbow.py",
}
RUN = {"sac": mujoco_host.run_sac, "td3": mujoco_host.run_td3, "ddpg": mujoco_host.run_ddpg,
       "ppo": mujoco_host.run_ppo, "trpo": mujoco_host.run_trpo, "rainbow": slimevolley_rainbow.run}


def load_example(kind):
    path = os.path.join(REPO, SCRIPTS[kind])
    spec = importlib.util.spec_from_file_location(f"example_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Kept(Exception):
    """Raised by a replaced driver, after keeping its arguments."""


def keep(store):
    def driver(agent, env, **kwargs):
        store.update(agent=agent, env=env, **kwargs)
        raise Kept
    return driver


def jax_main(kind, argv, monkeypatch):
    """The example's ``main`` up to its driver: the driver's arguments."""
    module = load_example(kind)
    store = {}
    for name in ("train_agent_with_evaluation", "train_agent_batch_with_evaluation"):
        monkeypatch.setattr(jexperiments, name, keep(store))
    monkeypatch.setattr(sys, "argv", [SCRIPTS[kind]] + argv)
    with pytest.raises(Kept):
        module.main()
    return store


def port_main(kind, argv, monkeypatch):
    store = {}
    target = slimevolley_rainbow if kind == "rainbow" else mujoco_host
    for name in ("train_agent_with_evaluation", "train_agent_batch_with_evaluation"):
        if hasattr(target, name):
            monkeypatch.setattr(target, name, keep(store))
    with pytest.raises(Kept):
        RUN[kind](argv, device="cpu")
    return store


SETTINGS = {  # the shells' attributes that each script sets
    "off": ("replay_start_size", "minibatch_size", "update_interval", "target_update_interval", "n_times_update",
            "update_burst"),
    "on": ("update_interval",),
    "rainbow": ("replay_start_size", "minibatch_size", "update_interval", "target_update_interval", "n_times_update",
                "gamma"),
}
CORE = {
    "sac": ("gamma", "soft_update_tau", "entropy_target", "initial_temperature", "learn_temperature", "burnin_steps",
            "target_update_method"),
    "td3": ("gamma", "soft_update_tau", "policy_update_delay", "burnin_steps", "target_update_method"),
    "ddpg": ("gamma", "soft_update_tau", "burnin_steps", "target_update_method", "clip_delta"),
    "ppo": ("gamma", "lambd", "clip_eps", "clip_eps_vf", "entropy_coef", "value_func_coef", "epochs",
            "minibatch_size", "standardize_advantages"),
    "trpo": ("gamma", "lambd", "entropy_coef", "max_kl", "vf_epochs", "vf_batch_size", "standardize_advantages",
             "cg_max_iter", "cg_damping", "max_backtrack"),
    "rainbow": ("gamma", "clip_delta", "batch_accumulator", "target_update_method"),
}


def _argv(kind, backend):
    if kind == "ppo":  # see _ppo_jax_main
        return ["--torch-env"] if backend == "--torch-env" else []
    return [backend] if kind == "trpo" else [backend, "--steps", "5000"]


@pytest.mark.parametrize("kind", ["sac", "td3", "ddpg", "ppo", "trpo", "rainbow"])
def test_recipe_is_the_example(kind, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    if kind == "ppo":
        jstore = _ppo_jax_main(monkeypatch)
    else:
        jstore = jax_main(kind, _argv(kind, "--jax-env"), monkeypatch)
    tstore = port_main(kind, _argv(kind, "--torch-env"), monkeypatch)
    jagent, tagent = jstore.pop("agent"), tstore.pop("agent")
    jstore.pop("env"), tstore.pop("env")
    jeval, teval = jstore.pop("eval_env"), tstore.pop("eval_env")
    assert tstore == jstore  # steps, eval_n_steps, eval_n_episodes, eval_interval, outdir, checkpoint_freq
    group = "rainbow" if kind == "rainbow" else ("on" if kind in ("ppo", "trpo") else "off")
    for attr in SETTINGS[group]:
        assert getattr(tagent, attr) == getattr(jagent, attr), attr
    for attr in CORE[kind]:
        assert getattr(tagent.core, attr) == pytest.approx(getattr(jagent.core, attr)), attr
    if group == "off":
        assert tagent.buffer.capacity == jagent.buffer.capacity == 10**6
        assert tagent.core_action_space.shape == tuple(jagent.core_action_space.shape)
    obs_size = jeval.observation_space.shape[0]
    obs = np.random.RandomState(0).normal(size=(64, obs_size)).astype(np.float32)
    with jagent.eval_mode():
        if kind == "rainbow":
            jagent._ensure_init(obs[:1])
        else:
            jagent.batch_act(obs[:1])
    state = np_tree(jagent.train_state)
    if group == "off":
        convert.actor_critic_shell_from_flax(tagent, state)
    elif group == "on":
        convert.onpolicy_shell_from_flax(tagent, state)
    else:
        convert.dqn_shell_from_flax(tagent, state)
        _rainbow_greedy_actions_agree(tagent, jagent, obs, monkeypatch)
        return
    with jagent.eval_mode(), tagent.eval_mode():
        np.testing.assert_allclose(tagent.batch_act(obs), np.asarray(jagent.batch_act(obs)), rtol=0, atol=1e-5)


def _ppo_jax_main(monkeypatch):
    """``train_ppo.py``'s host ``main`` on the JAX package's Pendulum (the
    port's run takes ``--torch-env``): the script's host mode builds the
    real env, and its ``--jax-env`` is the device runner."""
    module = load_example("ppo")
    from pfrl_tpu.envs import HostJaxEnv, Pendulum, TimeLimit

    monkeypatch.setattr(module, "make_env", lambda args, seed: HostJaxEnv(TimeLimit(Pendulum()), seed=seed))
    store = {}
    monkeypatch.setattr(jexperiments, "train_agent_with_evaluation", keep(store))
    monkeypatch.setattr(sys, "argv", [SCRIPTS["ppo"]])
    with pytest.raises(Kept):
        module.main()
    return store


def _rainbow_greedy_actions_agree(tagent, jagent, obs, monkeypatch):
    """The noisy head draws its noise when evaluating too: both packages
    draw the tape's normals."""
    tape = Tape(4)
    tagent.draws = tape
    with tagent.eval_mode():
        want_q = tagent.batch_act(obs)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit(), jagent.eval_mode():
        install_tape(mp, tape)
        got_q = np.asarray(jagent.batch_act(obs))
        assert not tape.log
    np.testing.assert_array_equal(want_q, got_q)


def test_rainbow_head_matches_the_example_on_the_same_noise():
    """``DistributionalDuelingMLPHead`` against ``train_rainbow.py``'s at
    its width (512) and atoms (51 on [-1, 1]): the atoms within a float32
    ulp, the distribution within 1e-6 on the same weights and noise."""
    module = load_example("rainbow")
    jhead = module.DistributionalDuelingMLPHead(n_actions=6)
    obs = np.random.RandomState(1).normal(size=(5, 12)).astype(np.float32)
    params = jhead.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, obs)
    thead = DistributionalDuelingMLPHead(12, 6)
    convert.load_flax_params(thead, np_tree(params))
    tape = Tape(2)
    tav = thead(torch.from_numpy(obs), tape)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jav = jhead.apply(params, obs, rngs={"noise": jax.random.PRNGKey(3)})
        assert not tape.log
    # XLA rounds jnp.linspace(-1, 1) by the fusion around it: inside a jit
    # 13 atoms, under disable_jit 20, differ by an ulp from its stand-alone
    # compile, which support() reproduces (C57): each within an ulp.
    z = jax.jit(lambda p, o, k: jhead.apply(p, o, rngs={"noise": k}).z_values)(params, obs, jax.random.PRNGKey(3))
    ulp = np.spacing(np.float32(1.0))
    for want in (np.asarray(z), np.asarray(jav.z_values)):
        np.testing.assert_allclose(tav.z_values.numpy(), want, rtol=0, atol=ulp)
    np.testing.assert_allclose(tav.q_dist.detach().numpy(), np.asarray(jav.q_dist), rtol=0, atol=1e-6)
    assert tav.q_dist.shape == (5, 6, 51)


def test_off_policy_run_takes_the_batch_driver_bf16_load_and_demo(monkeypatch, tmp_path):
    """``--num-envs 2``: a ``SerialVectorEnv`` and the batch driver;
    ``--bf16``: ``compute_dtype``; ``--load`` then ``--demo``: the shell's
    ``load`` and 10 evaluation episodes, no training."""
    monkeypatch.chdir(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        store = port_main("td3", ["--torch-env", "--num-envs", "2", "--eval-n-envs", "2", "--bf16"], mp)
    assert isinstance(store["env"], SerialVectorEnv) and store["env"].num_envs == 2
    assert isinstance(store["eval_env"], SerialVectorEnv)
    assert store["agent"].core.compute_dtype == torch.bfloat16
    agent, _ = mujoco_host.run_ddpg(["--torch-env", "--steps", "60", "--replay-start-size", "30",
                                     "--eval-interval", "1000", "--outdir", str(tmp_path / "run")], device="cpu")
    assert agent.train_state.n_updates == 31
    agent.save(str(tmp_path / "saved"))
    loaded, stats = mujoco_host.run_ddpg(["--torch-env", "--load", str(tmp_path / "saved"), "--demo"], device="cpu")
    assert stats["episodes"] == 10 and loaded.t == 0
    for p, q in zip(loaded.train_state.policy.parameters(), agent.train_state.policy.parameters()):
        assert torch.equal(p, q)


def test_trpo_refuses_bf16_by_name(capsys):
    with pytest.raises(SystemExit):
        mujoco_host.run_trpo(["--torch-env", "--bf16"], device="cpu")
    assert "TRPO is fp32 by design" in capsys.readouterr().err
    with pytest.raises(ValueError, match="TRPO is fp32 by design"):
        mujoco_host.make_trpo_agent(3, 1, compute_dtype=torch.bfloat16, device="cpu")


def test_make_backend_env_wraps_gymnasium_as_jax_does_and_raises_by_name():
    pytest.importorskip("gymnasium")
    args = types.SimpleNamespace(env="Pendulum-v1", torch_env=False, jax_env=False)
    tenv, jenv = env_cli.make_backend_env(args, 3, None), jax_make_backend_env(args, 3, None)
    assert [type(e).__name__ for e in (tenv, tenv.env)] == ["NormalizeActionSpace", "CastObservationToFloat32"]
    tobs, jobs = tenv.reset(), jenv.reset()
    assert tobs.dtype == np.float32
    np.testing.assert_array_equal(tobs, np.asarray(jobs))
    for a in (-1.0, 0.3, 1.0):
        t, j = tenv.step(np.array([a], np.float32)), jenv.step(np.array([a], np.float32))
        np.testing.assert_array_equal(t[0], np.asarray(j[0]))
        assert t[1] == pytest.approx(j[1], rel=1e-6) and t[2] == j[2]
    discrete = env_cli.make_backend_env(types.SimpleNamespace(env="CartPole-v1"), 0, None, normalize_action=False)
    assert type(discrete).__name__ == "CastObservationToFloat32"
    missing = types.SimpleNamespace(env="NoSuchEnv-v0", torch_env=False)
    with pytest.raises(RuntimeError, match="NoSuchEnv-v0"):
        env_cli.make_backend_env(missing, 0, lambda s: pytest.fail("no fallback"))
    chosen = types.SimpleNamespace(env="NoSuchEnv-v0", torch_env=True)
    assert env_cli.make_backend_env(chosen, 7, lambda s: ("factory", s)) == ("factory", 7)


class MultiBinary:
    def __init__(self, n):
        self.n = n


class _StubSlime:
    """A stand-in for SlimeVolley-v0: 12 observations, MultiBinary(3)."""

    def __init__(self):
        self.action_space = MultiBinary(3)
        self.observation_space = types.SimpleNamespace(shape=(12,))
        self.taken = []

    def reset(self):
        return np.zeros(12)

    def step(self, action):
        self.taken.append(list(action))
        return np.ones(12), 1.0, False, {}

    def close(self):
        pass

    def seed(self, seed=None):
        return [seed]


def test_multibinary_as_discrete_action_matches_the_example(monkeypatch):
    """Action index bits are the binary vector, bit 0 first; ``Discrete(8)``
    for ``MultiBinary(3)``. The example's wrapper reads ``gym.spaces``: a
    stub module stands in for gym here."""
    fake_spaces = types.SimpleNamespace(MultiBinary=MultiBinary, Discrete=lambda n: types.SimpleNamespace(n=n))
    monkeypatch.setitem(sys.modules, "gym", types.SimpleNamespace(spaces=fake_spaces))
    monkeypatch.setitem(sys.modules, "gym.spaces", fake_spaces)
    jenv = load_example("rainbow").MultiBinaryAsDiscreteAction(_StubSlime())
    tenv = MultiBinaryAsDiscreteAction(_StubSlime())
    assert tenv.action_space.n == jenv.action_space.n == 8 and tenv.n_bits == 3
    for a in range(8):
        tenv.step(a), jenv.step(a)
    assert tenv.env.taken == jenv.env.taken and tenv.env.taken[6] == [0, 1, 1]
    assert tenv.seed(5) == [5]
    with pytest.raises(TypeError, match="MultiBinary"):
        MultiBinaryAsDiscreteAction(types.SimpleNamespace(action_space=types.SimpleNamespace(n=2)))


def test_slimevolley_without_its_packages_raises_naming_them():
    args = types.SimpleNamespace(torch_env=False)
    with pytest.raises(RuntimeError, match="slimevolleygym unavailable.*--torch-env"):
        slimevolley_rainbow.make_env(args, 0)


def test_host_recipes_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (mujoco_host.make_sac_agent, mujoco_host.make_td3_agent, mujoco_host.make_ddpg_agent,
                 mujoco_host.make_ppo_agent, mujoco_host.make_trpo_agent):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(17, 6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slimevolley_rainbow.make_rainbow_agent(4, 2)


@pytest.mark.parametrize("name", ["td3-halfcheetah-host-4-burst", "ppo-hopper-host-1", "rainbow-slimevolley-cartpole-1"])
def test_host_path_profile_counts_the_run(tmp_path, name):
    """``profile_host.run_host_batch`` over a path of ``HOST_PATHS`` on the
    CPU (what ``chip_smoke.py`` and ``profile_slice --config`` measure
    with): the serial driver for one lane, the batch driver for four; its
    counts are the run's and its timers are taken off again."""
    from pfrl_tpu_torch.experiments.profile_host import HOST_PATHS, count_host_path_ops, make_host_path, run_host_batch

    onpolicy = name.startswith("ppo")
    kw = {} if onpolicy else {"replay_start_size": 40, "capacity": 1000}
    agent, env, eval_env = make_host_path(name, device="cpu", **kw)
    lanes = HOST_PATHS[name].lanes
    steps = 2048 if onpolicy else 80
    record = run_host_batch(agent, env, eval_env, steps=steps, eval_interval=steps, eval_n_episodes=1,
                            outdir=str(tmp_path))
    expected = 1 if onpolicy else steps - (40 - lanes)
    assert record["t"] == steps and record["n_updates"] == expected and record["lanes"] == lanes
    timings = record["timings"]
    assert timings["update"]["n"] == expected
    assert timings["batch_act"]["n"] == timings["env round trip" if lanes > 1 else "env step"]["n"] == steps // lanes
    assert record["replay_start_size"] == (2048 if onpolicy else 40)
    assert record["ring_bytes"] > 0 and len(record["eval"]) == 1
    if name.startswith("rainbow"):
        assert record["target_syncs"] == 0  # the hard sync is every 2,000
    assert not {"batch_act", "batch_observe", "_update_once"} & set(vars(agent)) and "step" not in vars(env)
    assert "sync_target" not in vars(agent.core)
    ops = count_host_path_ops(name, device="cpu", capacity=None if onpolicy else 1024)
    assert ops["lanes"] == lanes and ops["ops_per_update"] > ops["ops_per_batch_act"] > 0
