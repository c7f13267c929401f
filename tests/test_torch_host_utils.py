"""The port's host wrappers and utilities against the JAX package's:
``Monitor``, ``Render`` and ``capped_cubic_video_schedule``
(``wrappers/monitor.py``), ``MJPEGVideoWriter`` and ``read_mjpeg_frames``
(``wrappers/video.py``), ``VectorFrameStack`` (``wrappers/vector_frame_stack.py``),
and ``utils/{reward_filter,env_modifiers,contexts,random_seed,random,
mode_of_distribution,clip_l2_grad_norm}.py`` and ``testing.py``.

Exact: Monitor's CSV ``r`` and ``l`` columns (not ``t``, the wall clock)
and its ``.avi`` files byte for byte (the same Pillow encodes both), the
frame stacks under masked resets, the filters' and the patched envs'
outputs, the seeded host generators, and ``sample_n_k`` and
``sample_with_replacement`` on the same draws (``install_tape``: the
port's logged uniforms are what ``jax.random.uniform`` returns; they are
checked untied, since ``lax.top_k`` breaks ties toward the lower index and
``torch.topk`` promises no order among them). ``clip_l2_grad_norm`` within
1e-6 relative (float32 sums of squares).
"""

import csv
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_value_modules import Tape, install_tape

import pfrl_tpu.utils.contexts as jcontexts
import pfrl_tpu.utils.env_modifiers as jmodifiers
import pfrl_tpu.utils.random as jrandom
import pfrl_tpu.utils.random_seed as jseed
import pfrl_tpu.utils.reward_filter as jfilter
from pfrl_tpu import distributions as jdistributions
from pfrl_tpu import testing as jtesting
from pfrl_tpu.envs import SerialVectorEnv as JaxSerialVectorEnv
from pfrl_tpu.utils.clip_l2_grad_norm import clip_l2_grad_norm as jclip_l2_grad_norm
from pfrl_tpu.utils.mode_of_distribution import mode_of_distribution as jmode
from pfrl_tpu.wrappers import Monitor as JaxMonitor
from pfrl_tpu.wrappers import Render as JaxRender
from pfrl_tpu.wrappers import VectorFrameStack as JaxVectorFrameStack
from pfrl_tpu.wrappers import monitor as jmonitor
from pfrl_tpu.wrappers import video as jvideo
from pfrl_tpu_torch import distributions as tdistributions
from pfrl_tpu_torch import testing as ttesting
from pfrl_tpu_torch.envs import SerialVectorEnv
from pfrl_tpu_torch.utils import contexts as tcontexts
from pfrl_tpu_torch.utils import env_modifiers as tmodifiers
from pfrl_tpu_torch.utils import random as trandom
from pfrl_tpu_torch.utils import random_seed as tseed
from pfrl_tpu_torch.utils import reward_filter as tfilter
from pfrl_tpu_torch.utils.clip_l2_grad_norm import clip_l2_grad_norm as tclip_l2_grad_norm
from pfrl_tpu_torch.utils.draws import Draws
from pfrl_tpu_torch.utils.mode_of_distribution import mode_of_distribution as tmode
from pfrl_tpu_torch.wrappers import Monitor, Render, VectorFrameStack
from pfrl_tpu_torch.wrappers import monitor as tmonitor
from pfrl_tpu_torch.wrappers import video as tvideo


class FrameEnv:
    """A host env of ``(h, w, c)`` uint8 frames from a seed, a reward per
    step, an episode of ``length`` steps (``needs_reset`` instead of ``done``
    every third episode) and ``render`` (``mode`` too, where ``mode_kw``)."""

    class _Space:
        def __init__(self, shape, n=3):
            self.shape, self.n = shape, n

    def __init__(self, seed, shape=(12, 16, 3), length=5, mode_kw=True):
        self._base = np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)
        self.observation_space, self.action_space = self._Space(shape), self._Space(())
        self._length, self._mode_kw = length, mode_kw
        self._t, self._episode, self.renders = 0, 0, []

    def _frame(self):
        return self._base + np.uint8((self._t * 11 + self._episode * 5) & 0xFF)

    def reset(self):
        self._t = 0
        self._episode += 1
        return self._frame()

    def step(self, action):
        self._t += 1
        end = self._t >= self._length + self._episode % 3
        truncated = end and self._episode % 3 == 0
        info = {"needs_reset": True} if truncated else {}
        return self._frame(), 0.25 * action + 0.5, end and not truncated, info

    def seed(self, seeds=None):
        return seeds

    def render(self, *args, **kwargs):
        if kwargs and not self._mode_kw:
            raise TypeError("render() takes no mode")
        self.renders.append(kwargs)
        return self._frame()

    def close(self):
        pass


def _drive(env, episodes, seed):
    rs = np.random.RandomState(seed)
    for _ in range(episodes):
        env.reset()
        while True:
            _, _, done, info = env.step(int(rs.randint(0, 3)))
            if done or info.get("needs_reset"):
                break
    env.close()


@pytest.mark.parametrize("mode_kw", [True, False], ids=["rgb_array", "no_mode"])
def test_monitor_writes_the_jax_packages_csv_and_videos(tmp_path, mode_kw):
    dirs = {}
    for name, cls in (("port", Monitor), ("jax", JaxMonitor)):
        env = FrameEnv(3, mode_kw=mode_kw)
        _drive(cls(env, str(tmp_path / name), fps=12), 10, 5)
        dirs[name] = tmp_path / name
        assert env.renders[0] == ({"mode": "rgb_array"} if mode_kw else {})
    rows = {k: list(csv.DictReader(open(d / "monitor.csv"))) for k, d in dirs.items()}
    assert len(rows["port"]) == len(rows["jax"]) == 10
    assert [(r["r"], r["l"]) for r in rows["port"]] == [(r["r"], r["l"]) for r in rows["jax"]]
    assert list(rows["port"][0]) == ["r", "l", "t"]
    videos = sorted(p for p in os.listdir(dirs["port"]) if p.endswith(".avi"))
    assert videos == sorted(p for p in os.listdir(dirs["jax"]) if p.endswith(".avi")) == [
        "video.episode000000.avi", "video.episode000001.avi", "video.episode000008.avi"]
    for v in videos:
        assert (dirs["port"] / v).read_bytes() == (dirs["jax"] / v).read_bytes()
    frames = tvideo.read_mjpeg_frames(str(dirs["port"] / videos[1]))
    assert len(frames) == 1 + 7 and frames[0].shape == (12, 16, 3)  # the reset's frame, then each of 7 steps
    for got, want in zip(frames, jvideo.read_mjpeg_frames(str(dirs["jax"] / videos[1]))):
        np.testing.assert_array_equal(got, want)


def test_monitor_without_videos_and_the_schedule(tmp_path):
    env = FrameEnv(1)
    _drive(Monitor(env, str(tmp_path), video_callable=False), 3, 0)
    assert not env.renders and not [p for p in os.listdir(tmp_path) if p.endswith(".avi")]
    assert len(open(tmp_path / "monitor.csv").read().splitlines()) == 4
    ids = range(3000)
    assert [i for i in ids if tmonitor.capped_cubic_video_schedule(i)] == \
        [i for i in ids if jmonitor.capped_cubic_video_schedule(i)] == [0, 1, 8, 27, 64, 125, 216, 343, 512, 729,
                                                                       1000, 2000]


def test_render_calls_render_at_each_step_and_reset():
    for cls in (Render, JaxRender):
        env = FrameEnv(2)
        wrapped = cls(env, mode="human")
        wrapped.reset()
        wrapped.step(1)
        wrapped.step(2)
        assert env.renders == [{"mode": "human"}] * 3


def test_video_writer_matches_the_jax_package(tmp_path):
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 256, (9, 14, 3)).astype(np.uint8) for _ in range(5)]  # an odd width and height
    for name, module in (("port.avi", tvideo), ("jax.avi", jvideo)):
        writer = module.MJPEGVideoWriter(str(tmp_path / name), fps=7, quality=90)
        for f in frames:
            writer.add_frame(f)
        assert writer.num_frames == 5
        writer.close()
        writer.close()  # a second close writes nothing
    assert (tmp_path / "port.avi").read_bytes() == (tmp_path / "jax.avi").read_bytes()
    empty = tvideo.MJPEGVideoWriter(str(tmp_path / "none.avi"))
    empty.close()
    assert not (tmp_path / "none.avi").exists()


def test_video_names_pillow_when_it_is_missing(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    writer = tvideo.MJPEGVideoWriter(str(tmp_path / "x.avi"))
    with pytest.raises(ImportError, match="Pillow"):
        writer.add_frame(np.zeros((4, 4, 3), np.uint8))


def _frame_lanes(cls, shape, n=3):
    return cls([FrameEnv(10 + i, shape=shape, length=3 + i) for i in range(n)])


@pytest.mark.parametrize("stack_axis", [0, 2])
def test_vector_frame_stack_matches_the_jax_package_under_masked_resets(stack_axis):
    shape = (1, 6, 5) if stack_axis == 0 else (6, 5, 1)  # chw or hwc planes
    port = VectorFrameStack(_frame_lanes(SerialVectorEnv, shape), 4, stack_axis=stack_axis)
    jax_env = JaxVectorFrameStack(_frame_lanes(JaxSerialVectorEnv, shape), 4, stack_axis=stack_axis)
    assert port.num_envs == jax_env.num_envs == 3 and port.seed([1, 2, 3]) == jax_env.seed([1, 2, 3])
    rs = np.random.RandomState(0)
    got, want = port.reset(), jax_env.reset()
    for step in range(14):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(got[0]).shape == ((4, 6, 5) if stack_axis == 0 else (6, 5, 4))
        actions = rs.randint(0, 3, 3)
        (got, r1, d1, _), (want, r2, d2, _) = port.step(actions), jax_env.step(actions)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
        if step % 4 == 3:  # lanes 0 and 2 restart; lane 1 keeps its frames
            mask = np.array([False, True, False])
            kept = np.asarray(got[1])
            got, want = port.reset(mask), jax_env.reset(mask)
            np.testing.assert_array_equal(np.asarray(got[1]), kept)
            first = np.asarray(got[0])
            assert all((np.take(first, i, axis=stack_axis) == np.take(first, 0, axis=stack_axis)).all()
                       for i in range(4))  # refilled with the reset's frame
    port.close()


def test_reward_filters_match_the_jax_package():
    rewards = np.random.RandomState(0).normal(0.3, 2.0, 300).tolist() + [0.0] * 50
    for name in ("AverageRewardFilter", "NormalizedRewardFilter"):
        kw = {"tau": 0.05} if name == "AverageRewardFilter" else {"tau": 0.05, "scale": 2.0, "eps": 0.5}
        port, jax_filter = getattr(tfilter, name)(**kw), getattr(jfilter, name)(**kw)
        assert [port(r) for r in rewards] == [jax_filter(r) for r in rewards]
    f = tfilter.NormalizedRewardFilter(tau=0.5, eps=0.1)  # the variance 2.25 clipped from above: min(var, eps)
    assert f(3.0) == pytest.approx(1.5 / 0.1**0.5)


def _patched(module, which):
    env = FrameEnv(4, length=6)
    if which == "action_filtered":
        module.make_action_filtered(env, lambda a: 2 - a)
    elif which == "reward_filtered":
        module.make_reward_filtered(env, lambda r: r * 3 - 1)
    elif which == "reward_clipped":
        module.make_reward_clipped(env, 0.6, 0.9)
    elif which == "action_repeated":
        module.make_action_repeated(env, 3)
    elif which == "timestep_limited":
        module.make_timestep_limited(env, 4)
    elif which == "rendered":
        module.make_rendered(env, mode="rgb_array")
    return env


@pytest.mark.parametrize("which", ["action_filtered", "reward_filtered", "reward_clipped", "action_repeated",
                                   "timestep_limited", "rendered"])
def test_env_modifiers_match_the_jax_package(which):
    outs = []
    for module in (tmodifiers, jmodifiers):
        env, out = _patched(module, which), []
        for episode in range(3):
            out.append(np.asarray(env.reset()))
            for a in (0, 1, 2, 1, 0, 2, 1):
                obs, r, done, info = env.step(a)
                out.append((np.asarray(obs), r, done, info))
                if done:
                    break
        env.close()
        outs.append((out, env.renders))
    (got, got_renders), (want, want_renders) = outs
    assert len(got) == len(want) and got_renders == want_renders
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]
        else:
            np.testing.assert_array_equal(g, w)
    if which == "timestep_limited":  # the counter starts at 1 and the patched reset rewinds it
        dones = [i for i, g in enumerate(got) if isinstance(g, tuple) and g[2]]
        assert dones == [4, 9, 14]


def test_evaluating_flips_the_shells_flag_not_a_modules_mode():
    class Shell:
        training = True

        def __init__(self):
            self.model = torch.nn.Linear(2, 2)

    for module in (tcontexts, jcontexts):
        shell = Shell()
        with module.evaluating(shell) as inside:
            assert inside is shell and shell.training is False and shell.model.training
        assert shell.training is True
        with pytest.raises(KeyError):
            with module.set_temporarily(shell, "training", "x"):
                assert shell.training == "x"
                raise KeyError
        assert shell.training is True


def test_set_random_seed_seeds_the_host_generators_as_the_jax_package():
    before = torch.random.get_rng_state()
    draws = tseed.set_random_seed(2**33 + 5, device="cpu")
    port = (random.random(), np.random.rand())
    assert torch.equal(torch.random.get_rng_state(), before)  # torch's global generator untouched
    jseed.set_random_seed(2**33 + 5)
    assert port == (random.random(), np.random.rand())
    assert isinstance(draws, Draws) and draws.device == torch.device("cpu")
    again = tseed.set_random_seed(2**33 + 5, device="cpu")
    assert torch.equal(draws.uniform(8), again.uniform(8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tseed.set_random_seed(0)


@pytest.mark.parametrize("n,k", [(100, 7), (37, 37), (1, 1)])
def test_sample_n_k_matches_the_jax_gumbel_top_k_on_the_same_draws(monkeypatch, n, k):
    tape = Tape(n)
    got = trandom.sample_n_k(tape, n, k)
    (kind, values), = tape.log
    assert kind == "uniform" and len(np.unique(values)) == n  # untied: top-k's order is then unique
    install_tape(monkeypatch, tape)
    want = jrandom.sample_n_k(jax.random.PRNGKey(0), n, k)
    assert not tape.log and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.tolist())) == k


def test_sample_with_replacement_and_the_bound_match_the_jax_package(monkeypatch):
    tape = Tape(3)
    got = trandom.sample_with_replacement(tape, 5, 40)
    install_tape(monkeypatch, tape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrandom.sample_with_replacement(jax.random.PRNGKey(1),
                                                                                         5, 40)))
    assert not tape.log and got.min() >= 0 and got.max() < 5
    for fn, key in ((trandom.sample_n_k, tape), (jrandom.sample_n_k, jax.random.PRNGKey(0))):
        with pytest.raises(ValueError, match="cannot sample 4 distinct items from 3"):
            fn(key, 3, 4)


def test_mode_of_distribution_matches_the_jax_package():
    rs = np.random.RandomState(0)
    logits, loc, scale = (rs.normal(size=(4, 5)).astype(np.float32), rs.normal(size=(4, 2)).astype(np.float32),
                          rs.uniform(0.5, 2, (4, 2)).astype(np.float32))
    pairs = [(tdistributions.Categorical(torch.from_numpy(logits)), jdistributions.Categorical(jnp.asarray(logits))),
             (tdistributions.Normal(torch.from_numpy(loc), torch.from_numpy(scale)),
              jdistributions.Normal(jnp.asarray(loc), jnp.asarray(scale))),
             (tdistributions.Delta(torch.from_numpy(loc)), jdistributions.Delta(jnp.asarray(loc)))]
    for port, jax_distrib in pairs:
        np.testing.assert_array_equal(tmode(port).numpy(), np.asarray(jmode(jax_distrib)))


def _grads(rs, scale):
    return {"b": [rs.normal(size=(3, 4)) * scale, None], "a": rs.normal(size=(5,)) * scale,
            "c": (rs.normal(size=(2, 2)) * scale,)}


@pytest.mark.parametrize("scale", [3.0, 1e-3])
def test_clip_l2_grad_norm_matches_the_jax_package(scale):
    tree = _grads(np.random.RandomState(1), scale)
    tree = {"b": [np.float32(tree["b"][0]), None], "a": np.float32(tree["a"]), "c": (np.float32(tree["c"][0]),)}
    as_torch = {"b": [torch.from_numpy(tree["b"][0]), None], "a": torch.from_numpy(tree["a"]),
                "c": (torch.from_numpy(tree["c"][0]),)}
    got = tclip_l2_grad_norm(as_torch, 2.0)
    want = jclip_l2_grad_norm(jax.tree.map(jnp.asarray, tree), 2.0)
    assert got["b"][1] is None and isinstance(got["c"], tuple)
    for g, w in ((got["a"], want["a"]), (got["b"][0], want["b"][0]), (got["c"][0], want["c"][0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    norm = float(torch.sqrt(sum((x * x).sum() for x in (got["a"], got["b"][0], got["c"][0]))))
    assert norm == pytest.approx(2.0, rel=1e-5) if scale > 1 else norm < 2.0
    if scale < 1:  # within the bound: unchanged
        np.testing.assert_array_equal(got["a"].numpy(), tree["a"])


def test_testing_helpers_match_the_jax_package():
    a = [torch.ones(3), (torch.zeros(2), torch.full((1,), 2.0))]
    ja = [jnp.ones(3), (jnp.zeros(2), jnp.full((1,), 2.0))]
    ttesting.torch_assert_allclose(a, [np.ones(3), [np.zeros(2), np.full(1, 2.0)]])
    jtesting.jax_assert_allclose(ja, [np.ones(3), [np.zeros(2), np.full(1, 2.0)]])
    ttesting.torch_assert_allclose(torch.tensor([1.0, 1.0], dtype=torch.bfloat16), 1.0)  # a lone side broadcasts
    for check, x in ((ttesting.torch_assert_allclose, a), (jtesting.jax_assert_allclose, ja)):
        with pytest.raises(AssertionError):
            check(x, [np.ones(3), [np.zeros(2), np.full(1, 2.5)]])
        with pytest.raises(AssertionError, match="length mismatch"):
            check(x, [np.ones(3)] * 3)
        with pytest.raises(TypeError, match="tree_assert_allclose"):
            check({"x": 1.0}, {"x": 1.0})
    ttesting.tree_assert_allclose({"w": [torch.ones(2)], "b": torch.zeros(1)},
                                  {"b": np.zeros(1), "w": [np.ones(2) + 1e-9]}, rtol=1e-6)
    jtesting.tree_assert_allclose({"w": [jnp.ones(2)], "b": jnp.zeros(1)}, {"b": jnp.zeros(1), "w": [jnp.ones(2)]})
    with pytest.raises(ValueError):
        ttesting.tree_assert_allclose({"w": torch.ones(2)}, {"v": torch.ones(2)})
    with pytest.raises(ValueError):
        jtesting.tree_assert_allclose({"w": jnp.ones(2)}, {"v": jnp.ones(2)})
    with pytest.raises(ValueError):
        ttesting.tree_assert_allclose([torch.ones(2)], (torch.ones(2),))
