"""The recurrent family's modules of the port against the JAX package: the
ABC and DelayedCue envs, the LSTM and GRU cells, ``RecurrentSequential``
and ``RecurrentBranched`` from converted parameters, ``utils/recurrent.py``
(``unroll`` with resets and the carry helpers), the episodic buffer
(chunk sealing, wrap-around of a lane's ring, ``sample_episodes``,
``sample`` and the window offsets), the prioritized episodic buffer (the
zero priority of rows sealed because they filled, its four draws, the
feedback) and ``sum_tree.stratified_sample``.

Draws are matched by value (``Tape`` and ``install_tape`` of
``test_torch_value_modules.py``): :func:`install_recurrent_tape` also
replays ``jax.random.categorical`` with a ``shape`` (the buffers' row draw,
Gumbel-max on a logged ``uniform`` of ``shape + [E]``) and
``jax.random.bernoulli`` (DelayedCue's cue, ``u < p``; a float key *is*
``u``).

Tolerances: env observations, rewards, flags and states exact; the cells,
containers and unrolls in float32 within 1e-6 absolute (matmuls reduce in
another order); at bf16 the LSTM's input side, a bf16 matmul of up to
32 terms, to the bit (as the MLPs, ROADMAP C36), and over 256 terms with
one-ulp flips (the float32 sum rounded to the other side of a bf16 value)
in at most 1e-4 of the outputs, the Nature CNN's rule; the cell's float32
outputs within 1e-6 relative + 1e-6 (its hidden side promotes to float32,
ROADMAP C32); buffer states, sampled rows, offsets, masks and windows
exact.
"""

import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict
from test_torch_continuous_envs import ValueKeys
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import Tape, _is_value_key, install_tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.models import recurrent as jrec
from pfrl_tpu.replay import EpisodicReplayBuffer as JaxEpisodic
from pfrl_tpu.replay import PrioritizedEpisodicReplayBuffer as JaxPrioritizedEpisodic
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.replay import sum_tree as jsum_tree
from pfrl_tpu.utils import precision as jprecision
from pfrl_tpu.utils import recurrent as jutils
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.envs.vector_env import VectorTorchEnv
from pfrl_tpu_torch.experiments.onpolicy import Dense
from pfrl_tpu_torch.experiments.recurrent import LSTMNet, RecurrentNatureQ
from pfrl_tpu_torch.models.layers import linear
from pfrl_tpu_torch.models.recurrent import (
    GRUCellModule,
    LSTMCellModule,
    RecurrentBranched,
    RecurrentSequential,
    is_recurrent,
)
from pfrl_tpu_torch.replay import sum_tree
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer
from pfrl_tpu_torch.replay.prioritized_episodic import PrioritizedEpisodicReplayBuffer
from pfrl_tpu_torch.replay.transition import Transition
from pfrl_tpu_torch.utils import recurrent as tutils
from pfrl_tpu_torch.utils.precision import apply_cast

torch.set_num_threads(1)
BF16 = torch.bfloat16


# ------------------------------------------------------------ shared helpers
def install_recurrent_tape(monkeypatch, tape: Tape):
    """``install_tape`` plus ``categorical`` with a ``shape`` and
    ``bernoulli``, both on the tape's logged uniforms."""
    install_tape(monkeypatch, tape)

    def pop_uniform(shape):
        kind, values = tape.log.pop(0)
        assert kind == "uniform", kind
        assert values.size == math.prod(shape), (values.shape, shape)
        return jnp.asarray(values.reshape(shape))

    def categorical(key, logits, axis=-1, shape=None, replace=True, mode=None):
        assert axis == -1 and replace
        full = tuple(logits.shape) if shape is None else tuple(shape) + tuple(logits.shape[-1:])
        u = jnp.maximum(jnp.finfo(logits.dtype).tiny, pop_uniform(full))
        return jnp.argmax(jnp.broadcast_to(logits, full) - jnp.log(-jnp.log(u)), axis=-1)

    def bernoulli(key, p=0.5, shape=None):
        if _is_value_key(key):
            return key < p
        return pop_uniform(() if shape is None else tuple(shape)) < p

    monkeypatch.setattr(jax.random, "categorical", categorical)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assert_trees_close(got, want, atol, rtol=0.0, what=""):
    got_leaves = tutils.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves), what
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        assert tuple(g.shape) == tuple(np.shape(w)), (what, i)
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), atol=atol, rtol=rtol, err_msg=f"{what} {i}")


# -------------------------------------------------------------------- envs
def test_delayed_cue_matches_jax_through_auto_resets(monkeypatch):
    lanes = 5
    tape = Tape(0)
    tenv = VectorTorchEnv(tenvs.DelayedCue(device="cpu"), lanes)
    jenv = VectorJaxEnv(jenvs.DelayedCue(), lanes)
    tstate, tobs = tenv.reset(tape)
    install_recurrent_tape(monkeypatch, tape)
    ValueKeys(monkeypatch)
    (u,) = tape.take("uniform")
    jstate, jobs = jenv.reset(jnp.asarray(u))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert tobs.shape == (lanes, 13) and tstate.cue.dtype == torch.int32
    rs = np.random.RandomState(1)
    vstep = jax.jit(jenv.step)
    seen_reward = set()
    for i in range(30):  # two and a half episodes, each lane reset twice
        actions = rs.randint(0, 2, lanes).astype(np.int32)
        tstate, vec = tenv.step(tape, tstate, _t(actions))
        (u,) = tape.take("uniform")
        keys = jnp.concatenate([jnp.zeros(lanes), jnp.asarray(u)])
        jstate, jvec = vstep(keys, jstate, jnp.asarray(actions))
        for got, want in ((vec.obs, jvec.obs), (vec.ts.obs, jvec.ts.obs), (vec.ts.reward, jvec.ts.reward),
                          (vec.ts.terminated, jvec.ts.terminated), (vec.ts.truncated, jvec.ts.truncated),
                          (tstate.t, jstate.t), (tstate.cue, jstate.cue)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"step {i}")
        seen_reward |= set(vec.ts.reward.tolist())
        assert bool(vec.ts.done.all()) == (i % 12 == 11)
    assert seen_reward == {-1.0, 0.0, 1.0}
    assert not tape.log


@pytest.mark.parametrize("kind", ["po-deterministic", "po-random", "continuing", "continuous"])
def test_abc_matches_jax_per_step(monkeypatch, kind):
    kw = {"po-deterministic": dict(size=3, partially_observable=True, deterministic=True),
          "po-random": dict(size=3, partially_observable=True),
          "continuing": dict(size=4, episodic=False),
          "continuous": dict(size=3, discrete=False, deterministic=True)}[kind]
    lanes = 6
    tape = Tape(2)
    tenv, jenv = tenvs.ABC(device="cpu", **kw), jenvs.ABC(**kw)
    tstate, tobs = tenv.reset(tape, lanes)
    with pytest.MonkeyPatch.context() as mp:
        install_recurrent_tape(mp, tape)
        keys = jnp.asarray(tape.take("randint")[0], jnp.float32) if kind == "po-random" else jnp.zeros(lanes)
        jstate, jobs = jax.vmap(jenv.reset)(keys)
    assert not tape.log
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    if kind == "po-deterministic":
        assert (tstate.offset == 1).all()  # every reset sets the episode counter to 1
    rs = np.random.RandomState(3)
    vstep = jax.jit(jax.vmap(jenv.step))
    step_keys = jax.random.split(jax.random.PRNGKey(0), lanes)
    rewards = 0.0
    for i in range(8):
        if kind == "continuous":
            actions = rs.uniform(-1.5, 1.5, (lanes, 3)).astype(np.float32)
        else:
            # Mostly the right action, so that chains are completed.
            right = np.asarray(jstate.s) % kw["size"]
            actions = np.where(rs.uniform(size=lanes) < 0.8, right, rs.randint(0, kw["size"], lanes)).astype(np.int32)
        tstate, ts = tenv.step(tstate, _t(actions))
        jstate, jts = vstep(step_keys, jstate, jnp.asarray(actions))
        for got, want in ((ts.obs, jts.obs), (ts.reward, jts.reward), (ts.terminated, jts.terminated),
                          (tstate.s, jstate.s), (tstate.offset, jstate.offset), (tstate.episode, jstate.episode)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{kind} step {i}")
        rewards += float(ts.reward.sum())
    if kind == "continuing":
        assert rewards > 0


def test_abc_refuses_the_stochastic_continuous_form():
    """The stochastic continuous form is ported (``test_torch_acer_modules.py``
    holds it against JAX); it draws its action on each step, so a step
    without a draw source is refused."""
    env = tenvs.ABC(discrete=False, device="cpu")
    state, _ = env.reset(Tape(0), 2)
    with pytest.raises(ValueError, match="stochastic continuous ABC draws"):
        env.step(state, torch.zeros(2, 2))
    assert env.step(state, torch.zeros(2, 2), Tape(0))[1].reward.shape == (2,)


# ------------------------------------------------------------------- cells
def _x(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


class JaxStack(nn.Module):
    """A ``RecurrentSequential`` of Dense, relu, LSTM, Dense, GRU."""

    @nn.compact
    def __call__(self, x, carry):
        return jrec.RecurrentSequential(layers=(nn.Dense(8), nn.relu, jrec.LSTMCellModule(8), nn.Dense(3),
                                                jrec.GRUCellModule(5)))(x, carry)


def _modules(kind):
    """(JAX module, JAX carry maker, port module): the module under test."""
    if kind == "lstm":
        return jrec.LSTMCellModule(6), LSTMCellModule(4, 6)
    if kind == "gru":
        return jrec.GRUCellModule(6), GRUCellModule(4, 6)
    if kind == "sequential":
        jmod = jrec.RecurrentSequential(layers=(nn.Dense(8), nn.relu, jrec.LSTMCellModule(8), nn.Dense(3),
                                                 jrec.GRUCellModule(5)))
        tmod = RecurrentSequential(Dense(4, 8), torch.relu, LSTMCellModule(8, 8), Dense(8, 3), GRUCellModule(3, 5))
        return jmod, tmod
    jmod = jrec.RecurrentBranched(branches=(jrec.LSTMCellModule(5), nn.Dense(2), jrec.GRUCellModule(3)))
    tmod = RecurrentBranched(LSTMCellModule(4, 5), Dense(4, 2), GRUCellModule(4, 3))
    return jmod, tmod


def _jax_carry(jmod, batch):
    if isinstance(jmod, jrec.RecurrentBranched):
        return tuple(b.initial_carry(batch) if jrec.is_recurrent(b) else () for b in jmod.branches)
    return jmod.initial_carry(batch)


def _converted(kind, batch=3):
    jmod, tmod = _modules(kind)
    carry0 = _jax_carry(jmod, batch)
    params = jmod.init(jax.random.PRNGKey(5), jnp.zeros((batch, 4)), carry0)
    convert.load_flax_params(tmod, np_tree(params))
    return jmod, tmod, params, carry0


@pytest.mark.parametrize("kind", ["lstm", "gru", "sequential", "branched"])
def test_recurrent_modules_match_flax_from_converted_params(kind):
    jmod, tmod, params, jcarry = _converted(kind)
    rs = np.random.RandomState(0)
    tcarry = tmod.initial_carry(3)
    assert is_recurrent(tmod)
    assert_trees_close(tcarry, jcarry, 0.0, what="initial carry")
    for step in range(5):
        x = _x(rs, 3, 4)
        jy, jcarry = jmod.apply(params, jnp.asarray(x), jcarry)
        ty, tcarry = tmod(_t(x), tcarry)
        assert_trees_close(ty, jy, 1e-6, what=f"{kind} output {step}")
        assert_trees_close(tcarry, jcarry, 1e-6, what=f"{kind} carry {step}")
    if kind == "lstm":
        c, h = tcarry
        np.testing.assert_array_equal(ty.detach().numpy(), h.detach().numpy())  # ((c', h'), h')


def test_lstm_parameters_are_flax_gates_concatenated():
    jmod, tmod, params, _ = _converted("lstm")
    cell = np_tree(params)["params"]["OptimizedLSTMCell_0"]
    assert "bias" not in cell["ii"] and "bias" in cell["hi"]
    for k, g in enumerate("ifgo"):
        np.testing.assert_array_equal(tmod.ih.weight[6 * k:6 * (k + 1)].detach().numpy(), cell[f"i{g}"]["kernel"].T)
        np.testing.assert_array_equal(tmod.hh.weight[6 * k:6 * (k + 1)].detach().numpy(), cell[f"h{g}"]["kernel"].T)
        np.testing.assert_array_equal(tmod.hh.bias[6 * k:6 * (k + 1)].detach().numpy(), cell[f"h{g}"]["bias"])
    assert tmod.ih.bias is None
    gru = GRUCellModule(4, 6)
    assert gru.hr.bias is None and gru.hz.bias is None and gru.hn.bias is not None and gru.in_.bias is not None


def test_fresh_cells_follow_flax_init():
    """Input kernels LeCun-normal (variance 1 / fan_in), hidden kernels
    orthogonal per gate, zero biases."""
    cell = LSTMCellModule(64, 32)
    cell.reset_parameters(torch.Generator().manual_seed(0))
    for block in cell.hh.weight.detach().chunk(4):
        np.testing.assert_allclose((block @ block.T).numpy(), np.eye(32), atol=1e-5)
    assert abs(float(cell.ih.weight.detach().var()) * 64 - 1.0) < 0.1
    assert float(cell.hh.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_cells_at_bf16_match_flax_and_promote_the_hidden_side(kind):
    """bf16 weights and input, float32 carry (the recurrent cores' cast):
    the input side computes in bf16, the hidden side promotes to float32,
    and the carry comes back float32."""
    jmod, tmod, params, jcarry = _converted(kind, batch=5)
    jparams = jprecision.cast_floating(params, jnp.bfloat16)
    rs = np.random.RandomState(1)
    tcarry = tmod.initial_carry(5)
    dtypes = {}

    def record(name):
        def hook(module, inputs, output):
            dtypes[name] = output.dtype
        return hook

    hooks = [getattr(tmod, name).register_forward_hook(record(name))
             for name in (("ih", "hh") if kind == "lstm" else ("ir", "hr", "hn"))]
    for step in range(4):
        x = _x(rs, 5, 4)
        with jax.disable_jit():
            jy, jcarry = jmod.apply(jparams, jnp.asarray(x).astype(jnp.bfloat16), jcarry)
        ty, tcarry = apply_cast(tmod, BF16, _t(x), tcarry, uncast_argnums=(1,))
        assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
        assert_trees_close(ty, jy, 1e-6, 1e-6, what=f"{kind} bf16 output {step}")
        assert_trees_close(tcarry, jcarry, 1e-6, 1e-6, what=f"{kind} bf16 carry {step}")
        assert all(c.dtype == torch.float32 for c in tutils.tree_leaves(tcarry))
    for h in hooks:
        h.remove()
    if kind == "lstm":
        assert dtypes == {"ih": BF16, "hh": torch.float32}
        # The input side alone, a bf16 matmul over 4 terms, is flax's to the bit.
        cell = np_tree(params)["params"]["OptimizedLSTMCell_0"]
        kernel = jnp.concatenate([cell[f"i{g}"]["kernel"] for g in "ifgo"], axis=-1).astype(jnp.bfloat16)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        with jax.disable_jit():
            want = jnp.dot(xb, kernel)
        got = linear(_t(x).to(BF16), tmod.ih.weight.detach().to(BF16), None)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    else:
        assert dtypes == {"ir": BF16, "hr": torch.float32, "hn": torch.float32}


def test_lstm_input_side_to_the_bit_over_256_terms_at_bf16():
    """The widest input side of the recipes' small nets (32 terms) matches
    flax to the bit. Over 256 terms the two float32 sums run in another
    order, and the CPU's kernels decide which outputs land on the other side
    of a bf16 value (one of 2,048 on an AMD EPYC with avx512_bf16, none on
    another CPU): held as the Nature CNN's layers are (ROADMAP C36), one-ulp
    flips in at most 1e-4 of 65,536 outputs."""
    rs = np.random.RandomState(4)
    for n_in, rows in ((32, 16), (256, 512)):
        x = _x(rs, rows, n_in)
        k = (_x(rs, n_in, 128) / math.sqrt(n_in)).astype(np.float32)
        with jax.disable_jit():
            want = jnp.dot(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(k).astype(jnp.bfloat16))
        got = linear(_t(x).to(BF16), _t(k.T.copy()).to(BF16), None).float().numpy()
        want = np.asarray(want, np.float32)
        if n_in == 32:
            np.testing.assert_array_equal(got, want)
            continue
        differ = got != want
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0**-126))) - 7)
        print(f"bf16 over {n_in} terms: {int(differ.sum())} of {differ.size} outputs one ulp apart")
        assert differ.mean() <= 1e-4, differ.mean()
        assert (np.abs(got - want)[differ] <= ulp[differ]).all()


# --------------------------------------------------------------- unrolling
def test_unroll_with_resets_matches_jax():
    jmod, tmod, params, jcarry = _converted("sequential", batch=4)
    rs = np.random.RandomState(2)
    xs = _x(rs, 7, 4, 4)
    resets = rs.uniform(size=(7, 4)) < 0.3
    resets[0, 0] = resets[3, 2] = True
    # Start from a carry that is not zero, so that the resets matter.
    warm = _x(rs, 4, 4)
    jcarry = jmod.apply(params, jnp.asarray(warm), jcarry)[1]
    tcarry = tmod(_t(warm), tmod.initial_carry(4))[1]
    jys, jfinal = jutils.unroll(jmod.apply, params, jnp.asarray(xs), jcarry, jnp.asarray(resets))
    tys, tfinal = tutils.unroll(tmod, _t(xs), tcarry, _t(resets))
    assert_trees_close(tys, jys, 1e-6, what="ys")
    assert_trees_close(tfinal, jfinal, 1e-6, what="final carry")
    # Without resets the reset rows differ: the resets were applied.
    tys2, _ = tutils.unroll(tmod, _t(xs), tcarry)
    assert not torch.allclose(tys2, tys)


@pytest.mark.parametrize("kind", ["lstm", "gru", "sequential", "branched"])
def test_sequence_form_matches_the_jax_unroll(kind):
    """``forward(xs, carry, sequence=True)`` of every recurrent module, from
    a carry that is not zero, is the JAX package's scan of its step: 1e-6."""
    jmod, tmod, params, jcarry = _converted(kind, batch=3)
    rs = np.random.RandomState(4)
    warm, xs = _x(rs, 3, 4), _x(rs, 6, 3, 4)
    jcarry = jmod.apply(params, jnp.asarray(warm), jcarry)[1]
    tcarry = tmod(_t(warm), tmod.initial_carry(3))[1]
    jys, jfinal = jutils.unroll(jmod.apply, params, jnp.asarray(xs), jcarry)
    tys, tfinal = tmod(_t(xs), tcarry, sequence=True)
    assert_trees_close(tys, jys, 1e-6, what=f"{kind} ys")
    assert_trees_close(tfinal, jfinal, 1e-6, what=f"{kind} final carry")


def test_carry_helpers_match_jax():
    rs = np.random.RandomState(3)
    carry = ((_x(rs, 4, 3), _x(rs, 4, 3)), _x(rs, 4, 2), ())
    tcarry = jax.tree.map(_t, carry)
    mask = np.array([True, False, True, False])
    zero = jax.tree.map(jnp.zeros_like, carry)
    assert_trees_close(tutils.mask_recurrent_state_at(tcarry, _t(mask)),
                       jutils.mask_recurrent_state_at(carry, jnp.asarray(mask), zero), 0.0)
    seqs = _x(rs, 3, 4, 2)
    assert_trees_close(tutils.flatten_sequences_time_first(_t(seqs)),
                       jutils.flatten_sequences_time_first(jnp.asarray(seqs)), 0.0)
    assert_trees_close(tutils.get_recurrent_state_at(tcarry, 2, detach=True),
                       jutils.get_recurrent_state_at(carry, 2, detach=True), 0.0)
    assert_trees_close(tutils.concatenate_recurrent_states([tcarry, tcarry]),
                       jutils.concatenate_recurrent_states([carry, carry]), 0.0)


@pytest.mark.parametrize("kind", ["lstm-net", "nature"])
def test_sequence_unroll_equals_stepping(kind):
    """The recipes' models unroll a window in one call (stateless layers and
    the LSTM's input side over all steps); stepping them gives the same."""
    torch.manual_seed(0)
    if kind == "lstm-net":
        model, xs = LSTMNet(13, 16, (2,), "q"), torch.randn(5, 3, 13)
    else:
        model = RecurrentNatureQ(6, lstm_size=16, frame_shape=(36, 36, 1))
        xs = torch.rand(4, 2, 36, 36, 1)
    carry = tutils.tree_map(lambda z: torch.randn_like(z), model.initial_carry(xs.shape[1]))
    av, final = model(xs, carry, sequence=True)
    stepped, final2 = tutils.unroll(model, xs, carry)
    np.testing.assert_allclose(av.q_values.detach().numpy(), stepped.q_values.detach().numpy(), atol=1e-6)
    assert_trees_close(final, tutils.tree_map(lambda z: z.detach().numpy(), final2), 1e-6)


# -------------------------------------------------------- episodic replay
LANES, ROWS, ROW_LEN, OBS_W, H = 3, 12, 4, 5, 6


def _step_batch(rs, t):
    """One step of transitions for every lane, with extras carries."""
    done = rs.uniform(size=LANES) < 0.25
    return dict(
        obs=_x(rs, LANES, OBS_W), action=rs.randint(0, 3, LANES).astype(np.int32),
        reward=_x(rs, LANES), next_obs=_x(rs, LANES, OBS_W), terminated=done & (rs.uniform(size=LANES) < 0.5),
        done=done, carry=((_x(rs, LANES, H), _x(rs, LANES, H)),), next_carry=((_x(rs, LANES, H), _x(rs, LANES, H)),),
    )


def _port_transition(b):
    return Transition(obs=_t(b["obs"]), action=_t(b["action"]), reward=_t(b["reward"]), next_obs=_t(b["next_obs"]),
                      terminated=_t(b["terminated"]), done=_t(b["done"]),
                      extras={"carry": jax.tree.map(_t, b["carry"]), "next_carry": jax.tree.map(_t, b["next_carry"])})


def _jax_transition(b):
    return JaxTransition(obs=jnp.asarray(b["obs"]), action=jnp.asarray(b["action"]), reward=jnp.asarray(b["reward"]),
                         next_obs=jnp.asarray(b["next_obs"]), terminated=jnp.asarray(b["terminated"]),
                         done=jnp.asarray(b["done"]),
                         extras=FrozenDict({"carry": jax.tree.map(jnp.asarray, b["carry"]),
                                            "next_carry": jax.tree.map(jnp.asarray, b["next_carry"])}))


def _example(b, to_port):
    one = {k: (v[0] if not isinstance(v, tuple) else jax.tree.map(lambda a: a[0], v)) for k, v in b.items()}
    one = {k: (np.asarray(v) if not isinstance(v, tuple) else v) for k, v in one.items()}
    if to_port:
        return Transition(**{k: _t(one[k]) for k in ("obs", "action", "reward", "next_obs", "terminated", "done")},
                          extras={"carry": jax.tree.map(_t, one["carry"]),
                                  "next_carry": jax.tree.map(_t, one["next_carry"])})
    return JaxTransition(**{k: jnp.asarray(one[k]) for k in ("obs", "action", "reward", "next_obs", "terminated",
                                                              "done")},
                         extras=FrozenDict({"carry": jax.tree.map(jnp.asarray, one["carry"]),
                                            "next_carry": jax.tree.map(jnp.asarray, one["next_carry"])}))


def _filled(prioritized: bool, steps: int = 26, seed: int = 0):
    """Both buffers after the same ``steps`` adds, checked after each."""
    rs = np.random.RandomState(seed)
    kw = dict(num_lanes=LANES, subseq_len=3)
    if prioritized:
        tbuf = PrioritizedEpisodicReplayBuffer(ROWS, ROW_LEN, device="cpu", **kw)
        jbuf = JaxPrioritizedEpisodic(ROWS, ROW_LEN, **kw)
    else:
        tbuf = EpisodicReplayBuffer(ROWS, ROW_LEN, device="cpu", **kw)
        jbuf = JaxEpisodic(ROWS, ROW_LEN, **kw)
    first = _step_batch(rs, 0)
    tstate, jstate = tbuf.init(_example(first, True)), jbuf.init(_example(first, False))
    seals = {"done": 0, "fill": 0}
    for t in range(steps):
        b = first if t == 0 else _step_batch(rs, t)
        rows_before = tstate.lane_row.clone()
        pos_before = tstate.ep_len[rows_before].clone()
        tbuf.add(tstate, _port_transition(b))
        jstate = jbuf.add(jstate, _jax_transition(b))
        seals["done"] += int(b["done"].sum())
        seals["fill"] += int(((pos_before + 1 >= ROW_LEN) & ~_t(b["done"])).sum())
        _assert_states_equal(tstate, jstate, prioritized, f"add {t}")
    return tbuf, tstate, jbuf, jstate, seals


def _assert_states_equal(tstate, jstate, prioritized, what):
    base = jstate.base if prioritized else jstate
    for name in ("ep_len", "finished", "lane_row", "n_started"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(base, name)), err_msg=what)
    for name in ("obs", "action", "reward", "next_obs", "terminated", "done"):
        want = np.asarray(getattr(base.storage, name))
        got = tstate.storage[name].numpy()
        np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=f"{what} {name}")
    for name in ("carry", "next_carry"):
        for g, w in zip(tutils.tree_leaves(tstate.storage["extras"][name]), jax.tree.leaves(base.storage.extras[name])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{what} {name}")
    if prioritized:
        np.testing.assert_array_equal(tstate.tree.numpy(), np.asarray(jstate.tree), err_msg=what)
        assert float(tstate.max_priority) == float(jstate.max_priority)


def test_episodic_add_seals_chunks_and_wraps_each_lanes_ring():
    tbuf, tstate, _, _, seals = _filled(False)
    # Rows sealed both ways, and each lane went round its 4-row ring.
    assert seals["done"] > 0 and seals["fill"] > 0
    assert int(tstate.n_started) == LANES + seals["done"] + seals["fill"] > LANES + ROWS
    assert tstate.lane_row.dtype == tstate.ep_len.dtype == torch.int32
    rpl = ROWS // LANES
    assert ((tstate.lane_row // rpl) == torch.arange(LANES, dtype=torch.int32)).all()  # never another lane's row


def _batches_equal(tb, jb, what=""):
    for name in ("rows", "offsets", "lengths", "mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=f"{what} {name}")
    for name in ("obs", "action", "reward", "next_obs", "terminated", "done"):
        np.testing.assert_array_equal(getattr(tb.transitions, name).numpy(), np.asarray(getattr(jb.transitions, name)),
                                      err_msg=f"{what} {name}")
    assert_trees_close(tb.init_carry, jb.init_carry, 0.0, what=f"{what} init_carry")
    assert_trees_close(tb.next_init_carry, jb.next_init_carry, 0.0, what=f"{what} next_init_carry")


@pytest.mark.parametrize("max_len", [None, 6])
def test_sample_episodes_matches_jax_windows_and_offsets(monkeypatch, max_len):
    tbuf, tstate, jbuf, jstate, _ = _filled(False)
    tape = Tape(5)
    tb = tbuf.sample_episodes(tstate, tape, 16, max_len)
    assert [k for k, _ in tape.log] == ["uniform", "uniform"]
    assert tape.log[0][1].size == 16 * ROWS
    install_recurrent_tape(monkeypatch, tape)
    jb = jbuf.sample_episodes(jstate, jax.random.PRNGKey(0), 16, max_len)
    assert not tape.log
    _batches_equal(tb, jb)
    T = max_len or 3
    assert tb.mask.shape == (16, T) and tb.rows.dtype == tb.offsets.dtype == torch.int32
    assert bool(tstate.finished[tb.rows.long()].all())
    if max_len == 6:  # longer than any row: whole rows from offset 0, tails masked
        assert (tb.offsets == 0).all() and (tb.mask.sum(1) == tstate.ep_len[tb.rows.long()].float()).all()
    else:
        assert (tb.offsets > 0).any()


def test_window_offset_is_float32_arithmetic():
    """``int32(u * (max_off + 1))`` in float32, clamped: u just below 1 gives
    the last offset, never one beyond it."""
    buf = EpisodicReplayBuffer(ROWS, ROW_LEN, num_lanes=LANES, device="cpu")
    _, tstate, _, _, _ = _filled(False)
    rows = torch.nonzero(tstate.ep_len == ROW_LEN)[:1, 0].to(torch.int32).repeat(3)
    u = torch.tensor([0.0, 0.5, np.nextafter(np.float32(1), np.float32(0))], dtype=torch.float32)
    b = buf.gather_windows(tstate, u, rows, 2)
    assert b.offsets.tolist() == [0, 1, 2] and b.lengths.tolist() == [2, 2, 2]


def test_flat_sample_matches_jax(monkeypatch):
    tbuf, tstate, jbuf, jstate, _ = _filled(False)
    tape = Tape(6)
    tb = tbuf.sample(tstate, tape, 10)
    install_recurrent_tape(monkeypatch, tape)
    jb = jbuf.sample(jstate, jax.random.PRNGKey(0), 10)
    assert not tape.log
    for name in ("obs", "action", "reward", "next_obs", "discount", "is_terminal", "weight", "indices"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    assert_trees_close(tb.extras["carry"], jb.extras["carry"], 0.0)


# --------------------------------------------------- prioritized episodic
def test_prioritized_add_gives_fill_sealed_rows_priority_zero():
    _, tstate, _, _, seals = _filled(True)
    assert seals["fill"] > 0
    leaves = sum_tree.get(tstate.tree, torch.arange(ROWS, dtype=torch.int32))
    sealed_by_fill = tstate.finished & (tstate.ep_len == ROW_LEN)
    writing = torch.zeros(ROWS, dtype=torch.bool)
    writing[tstate.lane_row.long()] = True
    assert sealed_by_fill.any()
    # A row sealed by filling keeps priority 0 unless its episode also ended
    # on its last step; the rows being written are at 0.
    assert (leaves[writing] == 0).all()
    assert ((leaves == 0) & tstate.finished).any()


def test_prioritized_sample_and_feedback_match_jax(monkeypatch):
    tbuf, tstate, jbuf, jstate, _ = _filled(True)
    tape = Tape(7)
    tb = tbuf.sample_episodes(tstate, tape, 8)
    assert [(k, v.size) for k, v in tape.log] == [("uniform", 8), ("uniform", 8 * ROWS), ("uniform", 8), ("uniform", 8)]
    errors = np.abs(_x(np.random.RandomState(8), 8)) * 3
    with pytest.MonkeyPatch.context() as mp:
        install_recurrent_tape(mp, tape)
        jb = jbuf.sample_episodes(jstate, jax.random.PRNGKey(0), 8)
    assert not tape.log
    _batches_equal(tb, jb, "prioritized")
    tbuf.update_episode_priorities(tstate, tb.rows, _t(errors))
    jstate = jbuf.update_episode_priorities(jstate, jb.rows, jnp.asarray(errors))
    np.testing.assert_allclose(tstate.tree.numpy(), np.asarray(jstate.tree), rtol=1e-6)
    np.testing.assert_allclose(float(tstate.max_priority), float(jstate.max_priority), rtol=1e-6)
    assert float(tstate.max_priority) > 1.0


def test_stratified_sample_matches_jax(monkeypatch):
    rs = np.random.RandomState(9)
    leaves = rs.uniform(0, 2, 16).astype(np.float32)
    leaves[[1, 5, 6]] = 0.0
    ttree = sum_tree.update(sum_tree.init_tree(16), torch.arange(16, dtype=torch.int32), _t(leaves))
    jtree = jsum_tree.update(jsum_tree.init_tree(16), jnp.arange(16, dtype=jnp.int32), jnp.asarray(leaves))
    tape = Tape(10)
    got = sum_tree.stratified_sample(ttree, tape, 12)
    install_recurrent_tape(monkeypatch, tape)
    want = jsum_tree.stratified_sample(jtree, jax.random.PRNGKey(0), 12)
    assert not tape.log
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and not set(got.tolist()) & {1, 5, 6}
