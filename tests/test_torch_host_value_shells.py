"""The port's value-family shells (``AL``, ``PAL``, ``DoublePAL``, ``DPP``,
``CategoricalDQN``, ``CategoricalDoubleDQN``, ``IQN``, ``DoubleIQN``: each
the port's ``DQN`` shell with its ``default_core``) against the JAX
package's, over PER, whose proportional draw runs the prefix-sample
kernel's plain version here.

Each pair runs through ``train_agent_with_evaluation`` over the
deterministic ABC behind ``HostJaxEnv`` and ``HostTorchEnv``, from the JAX
shell's initial state converted with ``convert.dqn_shell_from_flax`` (the
categorical and IQN states are ``DQNState`` too), on the same draws by
value (``Tape``/``install_tape``, C29; IQN's taus in C25's order, with the
shell's default quantile counts 64, 64 and 32, as the JAX shell passes
none). Tolerances: actions, counts and the evaluation rows exactly;
``average_q`` and ``average_loss`` within 1e-5 relative (a categorical
``average_q`` also within 1e-6 absolute, C55); parameters and targets within
3e-6, first moments within 3e-6 of their largest magnitude where that
exceeds 1 (1e-5 for IQN, whose loss sums 4,096 quantile pairs per
example), second moments within 1e-5
of their largest magnitude, or 4x what ulp nudges of the starting weights
move them (``test_torch_host_actor_critic.assert_within_nudges``).
"""

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_host_actor_critic import assert_within_nudges
from test_torch_host_agents import (
    DQN_KW,
    ENVS,
    NUDGES,
    _buffers,
    _dqn_tensors,
    _jax_dqn_tensors,
    _same_actions,
    assert_same_scores,
    assert_stats_close,
    new_log,
    record,
    scale_weights,
)
from test_torch_rainbow_modules import np_tree
from test_torch_value_modules import JaxPsi, Tape, install_tape

from pfrl_tpu import agents as jagents
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.envs import HostJaxEnv
from pfrl_tpu.experiments import train_agent_with_evaluation as jax_train
from pfrl_tpu_torch import agents as tagents
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import explorers as texplorers
from pfrl_tpu_torch.envs import HostTorchEnv
from pfrl_tpu_torch.experiments import train_agent_with_evaluation
from pfrl_tpu_torch.experiments.cartpole_value import ReLUMLP
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import (
    DistributionalFCStateQFunctionWithDiscreteAction,
    FCStateQFunctionWithDiscreteAction,
    ImplicitQuantileQFunction,
)

torch.set_num_threads(1)

HIDDEN = 16
SHELLS = ["AL", "PAL", "DoublePAL", "DPP", "CategoricalDQN", "CategoricalDoubleDQN", "IQN", "DoubleIQN"]


def q_functions(name):
    """The JAX Q-function and the port's for the shell ``name``."""
    if name.startswith("Categorical"):
        return (jq.DistributionalFCStateQFunctionWithDiscreteAction(
                    n_actions=2, n_atoms=11, v_min=-1.0, v_max=1.0, n_hidden_channels=HIDDEN, n_hidden_layers=1),
                DistributionalFCStateQFunctionWithDiscreteAction(4, 2, 11, -1.0, 1.0, 1, HIDDEN))
    if name.endswith("IQN"):
        return (jq.ImplicitQuantileQFunction(psi=JaxPsi(out=8, hidden=HIDDEN), n_actions=2, n_basis_functions=16),
                ImplicitQuantileQFunction(ReLUMLP(4, 8, HIDDEN), 8, 2, n_basis_functions=16))
    return (jq.FCStateQFunctionWithDiscreteAction(n_actions=2, n_hidden_channels=HIDDEN, n_hidden_layers=1),
            FCStateQFunctionWithDiscreteAction(4, 2, 1, HIDDEN))


def jax_shell(name):
    jagent = getattr(jagents, name)(q_functions(name)[0], optax.adam(1e-2), _buffers("per")[0], 0.9,
                                    jexplorers.ConstantEpsilonGreedy(0.2, 2), **DQN_KW)
    jagent._ensure_init(np.zeros((1, 4), np.float32))
    return jagent


def port_shell(name, jstate, draws, scale=1.0):
    tagent = getattr(tagents, name)(q_functions(name)[1], Adam(1e-2), _buffers("per")[1], 0.9,
                                    texplorers.ConstantEpsilonGreedy(0.2, 2), **DQN_KW, device="cpu", draws=draws)
    convert.dqn_shell_from_flax(tagent, jstate)
    return scale_weights(tagent, scale)


@pytest.mark.parametrize("name", SHELLS)
def test_value_shell_matches_jax_over_per_through_the_serial_driver(tmp_path, name):
    jagent = jax_shell(name)
    assert type(jagent.core).__name__ == f"{name}Core"
    jstate = np_tree(jagent.train_state)
    jenv_cls, tenv_cls = ENVS["abc"][:2]
    kw = dict(steps=100, eval_n_steps=None, eval_n_episodes=3, eval_interval=50)

    def port_run(scale, outdir):
        tape, log = Tape(17), new_log()
        tagent = port_shell(name, jstate, tape, scale)
        train_agent_with_evaluation(record(tagent, log), HostTorchEnv(tenv_cls(), draws=tape), outdir=outdir,
                                    eval_env=HostTorchEnv(tenv_cls(), draws=tape), **kw)
        return tagent, tape, log

    tagent, tape, tlog = port_run(1.0, str(tmp_path / "port"))
    assert type(tagent.core).__name__ == type(jagent.core).__name__
    nudged = [port_run(s, str(tmp_path / f"nudged{i}")) for i, s in enumerate(NUDGES)]
    jlog = new_log()
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        install_tape(mp, tape)
        jax_train(record(jagent, jlog), HostJaxEnv(jenv_cls(), seed=1), outdir=str(tmp_path / "jax"),
                  eval_env=HostJaxEnv(jenv_cls(), seed=2), **kw)
        assert not tape.log
    _same_actions(tlog, jlog)
    for _, _, log in nudged:
        _same_actions(log, jlog)
    assert tlog["syncs"] == jlog["syncs"] >= 2
    assert tagent.t == jagent.t == 100 and tagent.optim_t == jagent.optim_t == (100 - 32) // 4 + 1
    # A categorical Q-value is a mean over atoms of [-1, 1] that nearly
    # cancel: held to 1e-6 of the support's scale (C55).
    atol = 1e-6 if name.startswith("Categorical") else 0.0
    assert_stats_close(tagent.get_statistics(), jagent.get_statistics(), atol=atol)
    assert_same_scores(str(tmp_path / "port"), str(tmp_path / "jax"), atol=atol)
    ts, js = tagent.train_state, jagent.train_state
    assert ts.n_updates == int(js.n_updates) and ts.opt_state.count == int(js.opt_state[0].count)
    # IQN's loss sums 64 x 64 quantile pairs per example: its gradients,
    # summed in another order, round apart by up to 1e-5 of their size.
    assert_within_nudges(_dqn_tensors(tagent), _jax_dqn_tensors(tagent, jagent),
                         [_dqn_tensors(a) for a, _, _ in nudged], name, mu_rel=1e-5 if name.endswith("IQN") else 3e-6)


@pytest.mark.parametrize("name", SHELLS)
def test_value_shell_save_load_round_trip(tmp_path, name):
    """``save`` then ``load`` into a fresh shell before its first act: every
    tensor of the state, Adam's count and ``n_updates`` come back, and the
    greedy actions agree."""
    jstate = np_tree(jax_shell(name).train_state)
    trained = port_shell(name, jstate, Tape(2))
    train_agent_with_evaluation(trained, HostTorchEnv(ENVS["abc"][1](), draws=Tape(3)), steps=60, eval_n_steps=None,
                                eval_n_episodes=1, eval_interval=10**6, outdir=str(tmp_path / "run"))
    assert trained.train_state.n_updates == trained.optim_t > 5
    trained.save(str(tmp_path / "agent"))
    fresh = port_shell(name, jstate, Tape(4), scale=0.5)
    fresh.train_state = None
    fresh.load(str(tmp_path / "agent"))
    obs = np.random.RandomState(0).normal(size=(9, 4)).astype(np.float32)
    with fresh.eval_mode(), trained.eval_mode():
        np.testing.assert_array_equal(fresh.batch_act(obs), trained.batch_act(obs))
    a, b = fresh.train_state, trained.train_state
    for x, y in zip(list(a.model.parameters()) + list(a.target_model.parameters()) + a.opt_state.mu + a.opt_state.nu,
                    list(b.model.parameters()) + list(b.target_model.parameters()) + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert a.n_updates == b.n_updates and a.opt_state.count == b.opt_state.count
