"""The local model zoo in the port: each of the JAX package's 26 checkpoints
in ``zoo/`` with the port's recipe that runs it.

A zoo entry is ``<algo>/<env>``; its checkpoint is
``<root>/<algo>/<env>/best/train_state.msgpack``, written by the JAX package
(``tools/record_curves.py`` and the JAX shells' runs) and read here without
JAX (:mod:`pfrl_tpu_torch.utils.flax_msgpack`), then converted by the core's
class (:func:`pfrl_tpu_torch.convert.state_from_flax`). ``root`` defaults to
:func:`~pfrl_tpu_torch.utils.pretrained_models.get_model_zoo_root`.

Each entry builds the core the checkpoint was trained with, as the port's
recipe for it builds it (the architectures of ``tests/test_torch_zoo_*.py``),
and, for the four entries ``--demo`` runs, the evaluation loop:
``dqn/cartpole`` (10 x 501 on the time-limited CartPole), ``sac/pendulum``
(10 x 201 on the time-limited Pendulum), ``ppo/hopper_real`` (10 x 1,000 on
``MujocoSim(11, 3)``: Hopper's Gymnasium env is not ported) and
``drqn/po_abc`` (10 x 5 on the partially observable ABC).

:func:`greedy_actions` acts without exploring; :func:`action_scores` gives a
discrete core's per-action scores (Q-values or logits), so that two devices'
actions can be compared away from ties.
"""

import dataclasses
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pfrl_tpu_torch.utils.pretrained_models import get_model_zoo_root


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    build: Callable      # device -> the core (a recipe's, or a shell's)
    obs_size: int
    discrete: bool
    bf16: bool = False
    eval_loop: Optional[Callable] = None  # (core, device) -> EvalLoop, for ``--demo``
    obs_scale: Tuple[float, ...] = (1.0,)  # :func:`observations` draws uniform(-1, 1) times this


CARTPOLE_SCALE = (2.0, 2.0, 0.2, 2.0)  # the pole up, the cart near the middle


def _cartpole(kind: str, **kw):
    def build(device):
        from pfrl_tpu_torch.experiments import cartpole_value as cv

        make = {"dqn": cv.make_dqn_cartpole_runner, "c51": cv.make_c51_cartpole_runner,
                "al": cv.make_al_cartpole_runner, "iqn": cv.make_iqn_cartpole_runner,
                "rainbow": cv.make_rainbow_cartpole_runner, "dqn_bf16": cv.make_dqn_cartpole_bf16_runner}[kind]
        return make(device=device, capacity=1_024, **kw)[0].core
    return build


def _cartpole_eval(core, device):
    from pfrl_tpu_torch.envs import CartPole, TimeLimit
    from pfrl_tpu_torch.experiments.runner import EvalLoop

    return EvalLoop(TimeLimit(CartPole(device=device), 500), core, 10, 501, device=device)


def _pendulum(kind: str):
    def build(device):
        from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac

        sizes = dict(num_envs=16, update_interval=4, minibatch_size=128, device=device)
        if kind == "sac":
            return mac.make_sac_runner(hidden=256, env=mac.pendulum_env(device), **sizes).core
        if kind == "td3":
            return mac.make_td3_runner(hidden=64, env=mac.pendulum_env(device), **sizes).core
        if kind == "sac_bf16":
            return mac.make_sac_pendulum_bf16_runner(device=device, capacity=1_024).core
        return mac.make_ddpg_runner(**sizes).core
    return build


def _pendulum_eval(core, device):
    from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
    from pfrl_tpu_torch.experiments.runner import EvalLoop

    return EvalLoop(mac.pendulum_env(device), core, 10, 201, device=device)


def _onpolicy(kind: str):
    def build(device):
        from pfrl_tpu_torch.experiments import onpolicy as onp

        if kind == "hopper":
            from pfrl_tpu_torch.agents.ppo import PPOCore
            from pfrl_tpu_torch.optimizers import Adam

            return PPOCore(onp.GaussianPiV(11, 3, 64, mean_scale=1e-4), Adam(3e-4), gamma=0.995, lambd=0.97,
                           epochs=10, minibatch_size=64, entropy_coef=0.0)
        make = {"ppo": onp.make_ppo_pendulum_runner, "trpo": onp.make_trpo_pendulum_runner,
                "a2c": onp.make_a2c_cartpole_runner}[kind]
        return make(device=device).core
    return build


def _hopper_eval(core, device):
    from pfrl_tpu_torch.envs import MujocoSim
    from pfrl_tpu_torch.experiments.runner import EvalLoop

    return EvalLoop(MujocoSim(11, 3, device=device), core, 10, 1_000, device=device)


def _recurrent(name: str):
    def build(device):
        from pfrl_tpu_torch.experiments import recurrent as rec

        return getattr(rec, f"make_{name}_runner")(device=device)[0].core
    return build


def _po_abc_eval(core, device):
    from pfrl_tpu_torch.experiments import recurrent as rec
    from pfrl_tpu_torch.experiments.runner import EvalLoop

    return EvalLoop(rec.make_drqn_po_abc_runner(device=device)[1].env.env, core, 10, 5, device=device)


def _acer(name: str):
    def build(device):
        from pfrl_tpu_torch.experiments import acer

        return getattr(acer, f"make_{name}_runner")(device=device)[0].core
    return build


def _host(kind: str):
    def build(device):
        if kind == "double_dqn":
            from pfrl_tpu_torch.agents import DoubleDQN
            from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
            from pfrl_tpu_torch.optimizers import Adam
            from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction
            from pfrl_tpu_torch.replay import ReplayBuffer

            return DoubleDQN(FCStateQFunctionWithDiscreteAction(8, 4, 2, 256), Adam(6e-4),
                             ReplayBuffer(1000, gamma=0.99, device=device), 0.99,
                             LinearDecayEpsilonGreedy(1.0, 0.05, 100, 4), replay_start_size=10, minibatch_size=64,
                             device=device).core
        if kind == "reinforce":
            from pfrl_tpu_torch.experiments.reinforce_gym import make_reinforce_agent

            return make_reinforce_agent(device=device).core
        from pfrl_tpu_torch.experiments import mujoco_host

        if kind == "sac":
            return mujoco_host.make_sac_agent(11, 3, replay_start_size=10, capacity=1000, device=device).core
        return mujoco_host.make_td3_agent(17, 6, replay_start_size=10, capacity=1000, device=device).core
    return build


ENTRIES = {
    "dqn/cartpole": ZooEntry(_cartpole("dqn"), 4, True, eval_loop=_cartpole_eval, obs_scale=CARTPOLE_SCALE),
    "c51/cartpole": ZooEntry(_cartpole("c51"), 4, True, obs_scale=CARTPOLE_SCALE),
    "al/cartpole": ZooEntry(_cartpole("al"), 4, True, obs_scale=CARTPOLE_SCALE),
    "iqn/cartpole": ZooEntry(_cartpole("iqn"), 4, True, obs_scale=CARTPOLE_SCALE),
    "rainbow/cartpole": ZooEntry(_cartpole("rainbow"), 4, True, obs_scale=CARTPOLE_SCALE),
    "dqn_bf16/cartpole": ZooEntry(_cartpole("dqn_bf16"), 4, True, bf16=True, obs_scale=CARTPOLE_SCALE),
    "sac/pendulum": ZooEntry(_pendulum("sac"), 3, False, eval_loop=_pendulum_eval),
    "td3/pendulum": ZooEntry(_pendulum("td3"), 3, False),
    "ddpg/pendulum": ZooEntry(_pendulum("ddpg"), 3, False),
    "sac_bf16/pendulum": ZooEntry(_pendulum("sac_bf16"), 3, False, bf16=True),
    "ppo/pendulum": ZooEntry(_onpolicy("ppo"), 3, False),
    "trpo/pendulum": ZooEntry(_onpolicy("trpo"), 3, False),
    "a2c/cartpole": ZooEntry(_onpolicy("a2c"), 4, True, obs_scale=CARTPOLE_SCALE),
    "ppo/hopper_real": ZooEntry(_onpolicy("hopper"), 11, False, eval_loop=_hopper_eval),
    "drqn/po_abc": ZooEntry(_recurrent("drqn_po_abc"), 5, True, eval_loop=_po_abc_eval),
    "drqn/delayed_cue": ZooEntry(_recurrent("drqn_delayed_cue"), 13, True),
    "riqn/delayed_cue": ZooEntry(_recurrent("riqn_delayed_cue"), 13, True),
    "rppo/delayed_cue": ZooEntry(_recurrent("rppo_delayed_cue"), 13, True),
    "rtrpo/delayed_cue": ZooEntry(_recurrent("rtrpo_delayed_cue"), 13, True),
    "acer/abc": ZooEntry(_acer("acer_abc"), 5, True),
    "acer_continuous/abc": ZooEntry(_acer("acer_continuous_abc"), 4, False),
    "double_dqn/lunarlander_real": ZooEntry(_host("double_dqn"), 8, True),
    "reinforce/cartpole": ZooEntry(_host("reinforce"), 4, True, obs_scale=CARTPOLE_SCALE),
    "reinforce/cartpole_real": ZooEntry(_host("reinforce"), 4, True, obs_scale=CARTPOLE_SCALE),
    "sac/hopper_real": ZooEntry(_host("sac"), 11, False),
    "td3/halfcheetah_real": ZooEntry(_host("td3"), 17, False),
}


def checkpoint_path(name: str, root: Optional[str] = None) -> str:
    return os.path.join(root or get_model_zoo_root(), name, "best", "train_state.msgpack")


def load(name: str, device=None, root: Optional[str] = None):
    """``(core, train_state)`` of zoo entry ``name`` on ``device`` (default:
    the CUDA device)."""
    from pfrl_tpu_torch import convert

    core = ENTRIES[name].build(device)
    return core, convert.load_flax_checkpoint(core, checkpoint_path(name, root), device=device)


def observations(name: str, n: int, seed: int) -> np.ndarray:
    """``n`` float32 observations for entry ``name``: uniform in (-1, 1)
    times the entry's ``obs_scale``, from a numpy stream seeded with
    ``seed`` (the same numbers on every device)."""
    entry = ENTRIES[name]
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n, entry.obs_size)) * np.asarray(entry.obs_scale)).astype(np.float32)


@torch.no_grad()
def greedy_actions(core, state, obs: torch.Tensor, draws=None) -> torch.Tensor:
    """The core's actions without exploring (``training=False``): greedy,
    the policy's mode or mean; a recurrent core acts from a zero carry."""
    if hasattr(core, "select_action_recurrent"):
        carry = core.init_act_state(obs.shape[0], obs.device)
        return core.select_action_recurrent(state, draws, obs, 0, False, carry)[0]
    return core.select_action(state, draws, obs, 0, False)


@torch.no_grad()
def action_scores(core, state, obs: torch.Tensor, draws=None) -> torch.Tensor:
    """A discrete core's ``[B, n_actions]`` scores, whose argmax
    :func:`greedy_actions` takes: Q-values (the value family) or logits
    (the policies), drawing what ``greedy_actions`` draws, in its order."""
    from pfrl_tpu_torch.agents import ACERCore, DQNCore, PPOCore, ReinforceCore, TRPOCore

    recurrent = hasattr(core, "select_action_recurrent")
    carry = core.init_act_state(obs.shape[0], obs.device) if recurrent else None
    if isinstance(core, DQNCore):
        av = core.step(state.model, obs, carry)[0] if recurrent else core.action_value(state.model, obs, draws)
        return av.q_values
    if isinstance(core, TRPOCore) and recurrent:
        return state.policy(core.phi(obs), carry[0])[0].logits
    if isinstance(core, PPOCore):
        return (core.forward_step(state.model, obs, carry) if recurrent else core.forward(state.model, obs))[0].logits
    if isinstance(core, ACERCore):
        return core.forward(state.model, obs)[0].logits
    if isinstance(core, ReinforceCore):
        return core.policy(state.model, obs).logits
    raise TypeError(f"no discrete scores for {type(core).__name__}")
