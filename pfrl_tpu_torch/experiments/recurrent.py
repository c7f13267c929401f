"""The recurrent family's recipes, each returning ``(runner, eval_loop)`` at
the JAX package's widths, on the CUDA device unless given ``device="cpu"``:

- :func:`make_drqn_po_abc_runner` is ``tools/record_curves.py``'s
  ``run_drqn_po_abc``: 16 lanes of the partially observable, deterministic
  ``ABC(size=3)``, :class:`LSTMNet` (Dense 5 -> 32, ReLU, LSTM 32, Dense
  32 -> 3), ``RecurrentDQNCore`` with Adam(5e-3), epsilon 0.3, gamma 0.9,
  an episodic buffer of 512 rows x 5 steps, one batch-16 update per 16
  transitions from 128 on, target syncs every 128; ``EvalLoop`` 10 x 5;
- :func:`make_drqn_delayed_cue_runner` is ``run_drqn_delayed_cue``: 16
  lanes of ``DelayedCue(12, 8)``, the same net (13 -> 32 -> LSTM 32 -> 2),
  Adam(5e-3), epsilon 0.2, gamma 0.95, 256 rows x 12 steps with windows of
  4, one batch-32 update per 8 transitions from 256 on, syncs every 256;
  ``EvalLoop`` 16 x 12;
- :func:`make_riqn_delayed_cue_runner` is ``run_riqn_delayed_cue``: the
  same env, buffer and cadence, ``RecurrentImplicitQuantileQFunction``
  over an LSTM psi (13 -> 32 -> LSTM 32) with 32 cosine bases,
  ``RecurrentIQNCore`` with N = N' = K = 8, Adam(3e-3), epsilon 0.2;
- :func:`make_rppo_delayed_cue_runner` is ``run_rppo_delayed_cue``: 16
  lanes, rollout 24, an LSTM policy-and-value net (softmax head over
  Dense 2, Dense 1 value), ``RecurrentPPOCore`` with Adam(5e-3), gamma
  0.95, 4 epochs of batch-16 chunk minibatches, chunks of 4, entropy bonus
  0.01; ``EvalLoop`` 32 x 12;
- :func:`make_rtrpo_delayed_cue_runner` is ``run_rtrpo_delayed_cue``: an
  LSTM policy and an LSTM value function fit by Adam(3e-3),
  ``RecurrentTRPOCore`` with gamma 0.95, entropy bonus 0.01, max KL 0.01,
  chunks of 4; it refuses a ``compute_dtype``;
- :func:`make_drqn_atarisim_runner` is ``examples/atari/train_drqn_ale.py
  --sim``: 32 lanes of single 84x84x1 uint8 AtariSim frames,
  :class:`RecurrentNatureQ` (Nature CNN -> 512, LSTM 512, Dense 6),
  Adam(2.5e-4, eps 1e-2), gamma 0.99, epsilon 1 -> 0.01 over 10^6
  transitions, an episodic buffer of 2,048 rows x 128 steps with the
  carries stored (about 5.9 GB on the card), windows of 32, one batch-32
  update per 4 transitions from 10^4 on, syncs every 10^4, the optional
  ``burn_in`` and ``compute_dtype`` of the example's flags; ``EvalLoop``
  5 x 500. :func:`run` is that example's ``main``.

Every layer has flax ``nn.Dense``'s default init (the Nature CNN Chainer's)
and each model names its flax scopes, so ``convert.py`` loads the JAX
package's parameters. Widths, buffers and cadences are arguments, so that
tests run the recipes small; the recipes' values are the defaults. The
models take the recurrent modules' ``sequence`` flag
(:mod:`pfrl_tpu_torch.models.recurrent`): with it their stateless layers
and the LSTM's input side run on all steps of a window at once. The carry
is the one-element tuple of the JAX modules.
"""

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.action_value import DiscreteActionValue
from pfrl_tpu_torch.agents.recurrent_dqn import RecurrentDQNCore
from pfrl_tpu_torch.agents.recurrent_iqn import RecurrentIQNCore
from pfrl_tpu_torch.agents.recurrent_ppo import RecurrentPPOCore
from pfrl_tpu_torch.agents.recurrent_trpo import RecurrentTRPOCore
from pfrl_tpu_torch.envs.abc import ABC
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.envs.delayed_cue import DelayedCue
from pfrl_tpu_torch.experiments.onpolicy import Dense
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.epsilon_greedy import ConstantEpsilonGreedy, LinearDecayEpsilonGreedy
from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN
from pfrl_tpu_torch.models.mlp import scoped_names
from pfrl_tpu_torch.models.recurrent import LSTMCellModule
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.policies import SoftmaxCategoricalHead
from pfrl_tpu_torch.q_functions.quantile_q_functions import RecurrentImplicitQuantileQFunction
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer
from pfrl_tpu_torch.utils.batch_states import atari_phi

Recipe = Tuple[object, EvalLoop]


class LSTMNet(nn.Module):
    """The recipes' compact flax nets: ``Dense_0`` (``in_size -> hidden``),
    ReLU, ``LSTMCellModule_0`` (``hidden``), then heads ``Dense_1``,
    ``Dense_2``, ... of ``head_sizes``. ``output`` says what the heads give:
    ``"q"`` a :class:`DiscreteActionValue`, ``"pi"`` a softmax
    distribution, ``"piv"`` ``(distribution, value)``, ``"v"`` a value,
    ``"features"`` the LSTM's output (no head)."""

    def __init__(self, in_size: int, hidden: int, head_sizes: Sequence[int] = (), output: str = "features"):
        super().__init__()
        self.output = output
        self.dense = Dense(in_size, hidden)
        self.lstm = LSTMCellModule(hidden, hidden)
        self.heads = nn.ModuleList(Dense(hidden, n) for n in head_sizes)
        self.pi = SoftmaxCategoricalHead()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.dense.reset_parameters(generator)
        self.lstm.reset_parameters(generator)
        for head in self.heads:
            head.reset_parameters(generator)

    def flax_names(self) -> Dict[str, object]:
        names = {"dense": "Dense_0", **scoped_names("lstm", "LSTMCellModule_0", self.lstm)}
        names.update({f"heads.{i}": f"Dense_{i + 1}" for i in range(len(self.heads))})
        return names

    def initial_carry(self, batch_size: int, device=None):
        return (self.lstm.initial_carry(batch_size, device),)

    def forward(self, x: torch.Tensor, carry, sequence: bool = False):
        h, c = self.lstm(torch.relu(self.dense(x)), carry[0], sequence=sequence)
        carry = (c,)
        if self.output == "q":
            return DiscreteActionValue(q_values=self.heads[0](h)), carry
        if self.output == "pi":
            return self.pi(self.heads[0](h)), carry
        if self.output == "piv":
            return (self.pi(self.heads[0](h)), self.heads[1](h)), carry
        if self.output == "v":
            return self.heads[0](h), carry
        return h, carry


class RecurrentNatureQ(nn.Module):
    """``train_drqn_ale.py``'s ``RecurrentQ``: ``LargeAtariCNN_0`` over
    single frames to ``lstm_size``, ``LSTMCellModule_0``, a ``Dense_0``
    Q head. With ``sequence`` the CNN runs on all ``T * B`` frames at once."""

    def __init__(self, n_actions: int = 6, lstm_size: int = 512, frame_shape=(84, 84, 1)):
        super().__init__()
        h, w, c = frame_shape
        self.torso = LargeAtariCNN(n_input_channels=c, n_output_channels=lstm_size, input_hw=(h, w))
        self.lstm = LSTMCellModule(lstm_size, lstm_size)
        self.head = Dense(lstm_size, n_actions)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.torso.reset_parameters(generator)
        self.lstm.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def flax_names(self) -> Dict[str, object]:
        names = scoped_names("torso", "LargeAtariCNN_0", self.torso)
        names.update(scoped_names("lstm", "LSTMCellModule_0", self.lstm))
        names["head"] = "Dense_0"
        return names

    def initial_carry(self, batch_size: int, device=None):
        return (self.lstm.initial_carry(batch_size, device),)

    def forward(self, x: torch.Tensor, carry, sequence: bool = False):
        if sequence:
            T, B = x.shape[:2]
            f = self.torso(x.reshape((T * B,) + tuple(x.shape[2:]))).reshape(T, B, -1)
        else:
            f = self.torso(x)
        h, c = self.lstm(f, carry[0], sequence=sequence)
        carry = (c,)
        return DiscreteActionValue(q_values=self.head(h)), carry


# ------------------------------------------------------------ off-policy
def _episodic(env, core, eval_loop, num_envs, max_episodes, max_episode_len, subseq_len,
              **cadence) -> Recipe:
    buffer = EpisodicReplayBuffer(max_episodes, max_episode_len, num_lanes=num_envs, subseq_len=subseq_len,
                                  device=env.device)
    runner = OffPolicyRunner(env, core, buffer, RunnerConfig(num_envs=num_envs, **cadence), device=env.device)
    return runner, EvalLoop(env, core, *eval_loop, device=env.device)


DELAYED_CUE_SIZES = dict(num_envs=16, max_episodes=256, max_episode_len=12, subseq_len=4, replay_start_size=256,
                         update_interval=8, target_update_interval=256, minibatch_size=32)
PO_ABC_SIZES = dict(num_envs=16, max_episodes=512, max_episode_len=5, subseq_len=None, replay_start_size=128,
                    update_interval=16, target_update_interval=128, minibatch_size=16)


def make_drqn_po_abc_runner(hidden: int = 32, device=None, compute_dtype: Optional[torch.dtype] = None,
                            **sizes) -> Recipe:
    env = ABC(size=3, partially_observable=True, deterministic=True, device=device)
    core = RecurrentDQNCore(model=LSTMNet(env.n_dim_obs, hidden, (3,), "q"), optimizer=Adam(5e-3),
                            explorer=ConstantEpsilonGreedy(0.3, 3), gamma=0.9, compute_dtype=compute_dtype)
    return _episodic(env, core, (10, 5), **{**PO_ABC_SIZES, **sizes})


def make_drqn_delayed_cue_runner(hidden: int = 32, device=None, compute_dtype: Optional[torch.dtype] = None,
                                 **sizes) -> Recipe:
    env = DelayedCue(episode_len=12, reveal_step=8, device=device)
    core = RecurrentDQNCore(model=LSTMNet(env.n_dim_obs, hidden, (2,), "q"), optimizer=Adam(5e-3),
                            explorer=ConstantEpsilonGreedy(0.2, 2), gamma=0.95, compute_dtype=compute_dtype)
    return _episodic(env, core, (16, 12), **{**DELAYED_CUE_SIZES, **sizes})


def make_riqn_delayed_cue_runner(hidden: int = 32, n_taus: int = 8, device=None,
                                 compute_dtype: Optional[torch.dtype] = None, **sizes) -> Recipe:
    env = DelayedCue(episode_len=12, reveal_step=8, device=device)
    model = RecurrentImplicitQuantileQFunction(LSTMNet(env.n_dim_obs, hidden), hidden, 2, n_basis_functions=32)
    core = RecurrentIQNCore(model=model, optimizer=Adam(3e-3), explorer=ConstantEpsilonGreedy(0.2, 2), gamma=0.95,
                            quantile_thresholds_N=n_taus, quantile_thresholds_N_prime=n_taus,
                            quantile_thresholds_K=n_taus, compute_dtype=compute_dtype)
    return _episodic(env, core, (16, 12), **{**DELAYED_CUE_SIZES, **sizes})


# The replay start that the tools (``profile_slice``, ``count_ops``,
# ``chip_smoke.py``) cut ``drqn-atarisim-32`` to, from 10^4: 130 scan steps
# of 32 lanes, just past the first rows sealed by filling at 128 steps. It
# changes no shape and no phase's work.
DRQN_ATARISIM_CUT_REPLAY_START = 4_160
ATARI_SIZES = dict(num_envs=32, max_episodes=2048, max_episode_len=128, subseq_len=32, replay_start_size=10_000,
                   update_interval=4, target_update_interval=10_000, minibatch_size=32)


def make_drqn_atarisim_runner(lstm_size: int = 512, n_actions: int = 6, frame_shape=(84, 84, 1),
                              final_exploration_frames: int = 10**6, burn_in: int = 0, device=None,
                              compute_dtype: Optional[torch.dtype] = None, lr: float = 2.5e-4,
                              **sizes) -> Recipe:
    env = AtariSim(n_actions=n_actions, frame_shape=frame_shape, device=device)
    core = RecurrentDQNCore(
        model=RecurrentNatureQ(n_actions, lstm_size, frame_shape),
        optimizer=Adam(lr, eps=1e-2),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.01, final_exploration_frames, n_actions),
        gamma=0.99,
        phi=atari_phi,
        burn_in=burn_in,
        compute_dtype=compute_dtype,
    )
    return _episodic(env, core, (5, 500), **{**ATARI_SIZES, **sizes})


# -------------------------------------------------------------- on-policy
def _onpolicy(env, core, num_envs: int, rollout: int) -> Recipe:
    runner = OnPolicyRunner(env, core, num_envs, rollout, device=env.device)
    return runner, EvalLoop(env, core, 32, 12, device=env.device)


def make_rppo_delayed_cue_runner(hidden: int = 32, num_envs: int = 16, rollout: int = 24, epochs: int = 4,
                                 minibatch_size: int = 16, chunk_len: int = 4, device=None,
                                 compute_dtype: Optional[torch.dtype] = None) -> Recipe:
    env = DelayedCue(episode_len=12, reveal_step=8, device=device)
    core = RecurrentPPOCore(LSTMNet(env.n_dim_obs, hidden, (2, 1), "piv"), Adam(5e-3), gamma=0.95, epochs=epochs,
                            minibatch_size=minibatch_size, entropy_coef=1e-2, chunk_len=chunk_len,
                            compute_dtype=compute_dtype)
    return _onpolicy(env, core, num_envs, rollout)


def make_rtrpo_delayed_cue_runner(hidden: int = 32, num_envs: int = 16, rollout: int = 24, chunk_len: int = 4,
                                  vf_epochs: int = 3, vf_batch_size: int = 64, device=None,
                                  compute_dtype: Optional[torch.dtype] = None) -> Recipe:
    if compute_dtype is not None:
        raise ValueError("recurrent TRPO runs float32 only: its Fisher-vector products, conjugate gradient "
                         "and KL line search are float32 by design (compute_dtype must be None)")
    env = DelayedCue(episode_len=12, reveal_step=8, device=device)
    core = RecurrentTRPOCore(
        policy=LSTMNet(env.n_dim_obs, hidden, (2,), "pi"),
        vf=LSTMNet(env.n_dim_obs, hidden, (1,), "v"),
        vf_optimizer=Adam(3e-3),
        gamma=0.95,
        entropy_coef=1e-2,
        max_kl=0.01,
        vf_epochs=vf_epochs,
        vf_batch_size=vf_batch_size,
        chunk_len=chunk_len,
    )
    return _onpolicy(env, core, num_envs, rollout)


# ``--config`` name -> recipe, for the tools that run them by name.
RECIPES = {
    "drqn-atarisim-32": make_drqn_atarisim_runner,
    "drqn-po-abc-16": make_drqn_po_abc_runner,
    "drqn-delayedcue-16": make_drqn_delayed_cue_runner,
    "riqn-delayedcue-16": make_riqn_delayed_cue_runner,
    "rppo-delayedcue-16": make_rppo_delayed_cue_runner,
    "rtrpo-delayedcue-16": make_rtrpo_delayed_cue_runner,
}


# ``train_drqn_ale.py``'s refusal without ``--sim`` (``:149-154``), as it is.
ALE_REFUSAL = ("host ALE requires gym[atari]+cv2 (not in this container); "
               "use --sim, or see train_dqn_ale.py:run_ale for the host "
               "wrapper stack incl. FlickerFrame")


def build_parser() -> argparse.ArgumentParser:
    """``train_drqn_ale.py``'s flags (``:120-147``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="BreakoutNoFrameskip-v4")
    parser.add_argument("--sim", action="store_true")
    parser.add_argument("--flicker", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--chunk", type=int, default=200, help="scan steps per device dispatch")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--lr", type=float, default=2.5e-4)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-envs", type=int, default=32)
    parser.add_argument("--max-episodes", type=int, default=2048)
    parser.add_argument("--episodic-update-len", type=int, default=32, help="truncated-BPTT window")
    parser.add_argument("--burn-in", type=int, default=0, help="burn-in steps per replayed window")
    parser.add_argument("--max-episode-chunk", type=int, default=128, help="storage row length")
    parser.add_argument("--replay-start-size", type=int, default=10**4)
    parser.add_argument("--update-interval", type=int, default=4)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    parser.add_argument("--final-exploration-frames", type=int, default=10**6)
    add_demo_args(parser)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """``train_drqn_ale.py``'s ``main`` with ``argv``'s flags on ``device``
    (default: the CUDA device): without ``--sim`` the example's
    ``SystemExit``; with it :func:`make_drqn_atarisim_runner` in turns of
    ``--chunk`` scan steps (``--flicker`` is parsed and not read, as in the
    example's ``--sim``). Returns :func:`~.demo_cli.run_device_example`'s
    dict."""
    from pfrl_tpu_torch.experiments.demo_cli import run_device_example

    args = build_parser().parse_args(argv)
    if not args.sim:
        raise SystemExit(ALE_REFUSAL)
    runner, eval_loop = make_drqn_atarisim_runner(
        final_exploration_frames=args.final_exploration_frames, burn_in=args.burn_in, device=device,
        compute_dtype=torch.bfloat16 if args.bf16 else None, lr=args.lr, num_envs=args.num_envs,
        max_episodes=args.max_episodes, max_episode_len=args.max_episode_chunk,
        subseq_len=args.episodic_update_len, replay_start_size=args.replay_start_size,
        update_interval=args.update_interval, target_update_interval=args.target_update_interval,
        minibatch_size=args.batch_size)
    return run_device_example(args, runner, eval_loop, lambda state: runner.run_chunk(state, args.chunk)[0])


if __name__ == "__main__":
    run()
