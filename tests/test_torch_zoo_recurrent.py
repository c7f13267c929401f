"""The converted-zoo gate for the recurrent family's five checkpoints in
``zoo/`` (``train_state.msgpack``, written by ``tools/record_curves.py``):
``drqn/po_abc``, ``drqn/delayed_cue``, ``riqn/delayed_cue``,
``rppo/delayed_cue`` and ``rtrpo/delayed_cue``. Each is restored by the
JAX package as ``tests/test_zoo.py`` restores it, handed to the port's
converter as a numpy tree (``dqn_state_from_flax``, ``ppo_state_from_flax``,
``trpo_state_from_flax``: the weights, the target, the Adam moments; the
recurrent TRPO's policy and value function, each with its own LSTM) and run
on the recipe of ``experiments/recurrent.py``.

(a) The converted state is the whole state: ``n_updates`` and the Adam
    count of a trained run, every parameter equal to the checkpoint's.
(b) ``EvalLoop`` against ``JaxEvalLoop`` (un-jitted, on the port's draws:
    the cues of every reset by value, ``test_torch_recurrent_slice.py``'s
    ``TapeEnv``), lane by lane, exactly; the carries are reset on every
    episode end. The DelayedCue checkpoints are gated as
    ``tests/test_zoo.py`` gates them, 16 lanes x 12 steps with a mean
    return of at least 1.0; ``drqn/po_abc`` (10 lanes x 5 steps) is held to
    the JAX run's lanes.
(c) The same gate on the port's own draws (a seeded ``torch.Generator``).

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
from test_torch_recurrent_cores import JaxRPiV, JaxRPolicy, JaxRPsi, JaxRQ, JaxRVF, np_tree
from test_torch_recurrent_modules import install_recurrent_tape
from test_torch_recurrent_slice import TapeEnv
from test_torch_sac import assert_network
from test_torch_value_modules import Tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu.agents import RecurrentDQNCore as JaxRDQN
from pfrl_tpu.agents import RecurrentIQNCore as JaxRIQN
from pfrl_tpu.agents import RecurrentPPOCore as JaxRPPO
from pfrl_tpu.agents import RecurrentTRPOCore as JaxRTRPO
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.explorers import ConstantEpsilonGreedy as JaxConstantEps
from pfrl_tpu.q_functions import RecurrentImplicitQuantileQFunction as JaxRIQF
from pfrl_tpu.replay.persistent import load_state
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.experiments import recurrent as rec
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zoo")
NAMES = ("drqn/po_abc", "drqn/delayed_cue", "riqn/delayed_cue", "rppo/delayed_cue", "rtrpo/delayed_cue")
WIDTH = 32


@functools.lru_cache(maxsize=None)
def checkpoint(name):
    """(JAX core, JAX env, restored JAX state, port recipe's core, converted
    state, eval lanes and steps)."""
    cue = jenvs.DelayedCue(12, 8)
    if name == "drqn/po_abc":
        jcore = JaxRDQN(model=JaxRQ(n_actions=3, hidden=WIDTH), optimizer=optax.adam(5e-3),
                        explorer=JaxConstantEps(0.3, 3), gamma=0.9)
        jenv, obs, make, lanes = jenvs.ABC(size=3, partially_observable=True, deterministic=True), 5, \
            rec.make_drqn_po_abc_runner, (10, 5)
    elif name == "drqn/delayed_cue":
        jcore = JaxRDQN(model=JaxRQ(hidden=WIDTH), optimizer=optax.adam(5e-3), explorer=JaxConstantEps(0.0, 2),
                        gamma=0.95)
        jenv, obs, make, lanes = cue, 13, rec.make_drqn_delayed_cue_runner, (16, 12)
    elif name == "riqn/delayed_cue":
        jcore = JaxRIQN(model=JaxRIQF(psi=JaxRPsi(hidden=WIDTH), n_actions=2, n_basis_functions=32),
                        optimizer=optax.adam(3e-3), explorer=JaxConstantEps(0.0, 2), gamma=0.95,
                        quantile_thresholds_N=8, quantile_thresholds_N_prime=8, quantile_thresholds_K=8)
        jenv, obs, make, lanes = cue, 13, rec.make_riqn_delayed_cue_runner, (16, 12)
    elif name == "rppo/delayed_cue":
        jcore = JaxRPPO(JaxRPiV(hidden=WIDTH), optax.adam(5e-3), chunk_len=4)
        jenv, obs, make, lanes = cue, 13, rec.make_rppo_delayed_cue_runner, (16, 12)
    else:
        jcore = JaxRTRPO(policy=JaxRPolicy(hidden=WIDTH), vf=JaxRVF(hidden=WIDTH), vf_optimizer=optax.adam(3e-3),
                         gamma=0.95, chunk_len=4)
        jenv, obs, make, lanes = cue, 13, rec.make_rtrpo_delayed_cue_runner, (16, 12)
    template = jcore.init(jax.random.PRNGKey(0), np.zeros((1, obs), np.float32))
    jstate = load_state(jax.device_get(template), os.path.join(ZOO, name, "best", "train_state.msgpack"))
    core = make(device="cpu")[0].core
    if name.startswith("rppo"):
        tstate = convert.ppo_state_from_flax(core, np_tree(jstate), device="cpu")
    elif name.startswith("rtrpo"):
        tstate = convert.trpo_state_from_flax(core, np_tree(jstate), device="cpu")
    else:
        tstate = convert.dqn_state_from_flax(core, np_tree(jstate.params), np_tree(jstate.target_params),
                                             np_tree(jstate.opt_state), device="cpu",
                                             n_updates=int(jstate.n_updates))
    return jcore, jenv, jstate, core, tstate, lanes


@pytest.mark.parametrize("name", NAMES)
def test_converted_checkpoint_carries_the_whole_state(name):
    _, _, jstate, _, tstate, _ = checkpoint(name)
    assert tstate.n_updates == int(jstate.n_updates) > 1  # a trained state, not the template
    if name.startswith("rtrpo"):
        assert_network(tstate.policy, jstate.policy_params, 0.0, "policy")
        assert_network(tstate.vf, jstate.vf_params, 0.0, "vf")
        assert tstate.vf_opt_state.count == int(jstate.vf_opt_state[0].count) > 0
    elif name.startswith("rppo"):
        assert_network(tstate.model, jstate.params, 0.0, "model")
        assert tstate.opt_state.count == int(jstate.opt_state[0].count) == int(jstate.n_updates)
    else:
        assert_network(tstate.model, jstate.params, 0.0, "online")
        assert_network(tstate.target_model, jstate.target_params, 0.0, "target")
        assert tstate.opt_state.count == int(jstate.opt_state[0].count) == int(jstate.n_updates)


@pytest.mark.parametrize("name", NAMES)
def test_eval_loop_matches_jax_lane_by_lane_and_clears_the_gate(name):
    jcore, jenv, jstate, core, tstate, (lanes, steps) = checkpoint(name)
    tape = Tape(11)
    env = rec.make_drqn_po_abc_runner(device="cpu")[1].env.env if name == "drqn/po_abc" else \
        rec.make_drqn_delayed_cue_runner(device="cpu")[1].env.env
    got = EvalLoop(env, core, lanes, steps, device="cpu").evaluate(tstate, tape)
    jloop = JaxEvalLoop(jenv, jcore, lanes, steps)
    jloop.env = TapeEnv(jenv, lanes, tape, "abc" if name == "drqn/po_abc" else "cue")
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_recurrent_tape(mp, tape)
        want = jloop.evaluate(jstate, jnp.zeros((2,), jnp.uint32))
    assert not tape.log
    print(f"{name}: port {got.mean():.3f}, JAX {want.mean():.3f}")
    np.testing.assert_array_equal(got, want)
    if name != "drqn/po_abc":
        assert got.mean() >= 1.0, got  # tests/test_zoo.py's gate
    # (c) on the port's own draws
    gen = torch.Generator().manual_seed(1)
    own = EvalLoop(env, core, lanes, steps, device="cpu").evaluate(tstate, Draws(gen))
    if name != "drqn/po_abc":
        assert own.mean() >= 1.0, own
    else:
        np.testing.assert_array_equal(own, got)  # PO-ABC draws nothing when evaluating
