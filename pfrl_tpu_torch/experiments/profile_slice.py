"""Where a full-width configuration's time goes on the card.

    python -m pfrl_tpu_torch.experiments.profile_slice
        [--config per-dqn|dqn|rainbow|sac|td3|ddpg|sac-pendulum|dqn-cartpole|c51-cartpole|
                  rainbow-cartpole|al-cartpole|iqn-cartpole|dqn-cartpole-example|
                  ppo|ppo-pendulum|trpo|a2c|drqn-atarisim-32|drqn-po-abc-16|
                  drqn-delayedcue-16|riqn-delayedcue-16|rppo-delayedcue-16|
                  rtrpo-delayedcue-16|acer-atarisim-16|acer-abc-16|
                  acer-continuous-abc-16|a2c-atarisim-16|a3c-atarisim-16|ppo-atarisim-8|
                  dqn-ale-nature-64|dqn-ale-nips-64|dqn-ale-dueling-64|
                  per-dqn-ale-64|c51-atarisim-64|dqn-pipeline-288|dqn-batch-ale-8|
                  the paths of profile_host.HOST_PATHS, dqn-actor-learner-ale-8 among them]
        [--steps 8] [--bf16] [--out PATH]

Runs one configuration at full width on the CUDA device. On 64 lanes of
84x84x4 uint8 AtariSim frames, 16 batch-32 updates per scan step:
``per-dqn`` (``make_per_dqn_runner()``, prioritized-replay Nature DQN),
``dqn`` (``make_dqn_runner()``, the same over the uniform ring) and
``rainbow`` (``make_rainbow_runner()``). For continuous control: ``sac``
and ``td3`` (``make_sac_runner()``, ``make_td3_runner()``: 32 lanes of
MujocoSim, 32 batch-256 updates per scan step) and ``ddpg``
(``make_ddpg_runner()``: 16 lanes of the time-limited Pendulum, 4 batch-128
updates per scan step) and ``sac-pendulum`` (``make_sac_pendulum_runner()``,
the same lanes and cadence with 256 x 256 networks). On the time-limited CartPole
(``experiments/cartpole_value.py``): ``dqn-cartpole``, ``c51-cartpole``,
``rainbow-cartpole`` (3-step prioritized replay through the kernel),
``al-cartpole`` and ``iqn-cartpole`` (32 lanes, 8 batch-64 updates per scan
step), and ``dqn-cartpole-example`` (128 lanes, 4 batch-128 updates per
scan step). The replay start is cut to 2,048 transitions where
the recipe's is later (Rainbow: 20,000), which changes no phase's work: the
ring's size and every shape stay. Past replay start it:

1. times ``--steps`` scan steps as they run (host clock, synchronized);
2. times the same number of steps again with each phase of the scan step
   wrapped in a synchronizing host timer: act, env step, replay add, and
   per update the sample (prioritized: with the prefix-sample kernel and the
   row gather inside it; uniform: one id draw per scan step and a row
   gather per update), the gradient step and the priority feedback, and
   the target sync. The gradient step is split: for the DQN family into its
   forwards (the loss), the backward pass and the optimizer; for the
   actor-critic cores into the critic step, the actor (and temperature)
   step and the soft copies of the targets, which there include the
   runner's own sync every 1,000 transitions;
3. records ``--steps`` more steps with ``torch.profiler``: kernels
   launched per scan step, the device's busy time, and the kernels that
   take the most of it. The busy share is taken against the unprofiled
   time of step 1, since the profiler slows the host.

The on-policy configurations run through ``OnPolicyRunner`` at their
recipes' widths: ``ppo`` (``make_ppo_runner()``: 8 lanes of MujocoSim,
rollout 256, 320 batch-64 Adam steps per iteration), ``ppo-pendulum``,
``trpo`` (16 lanes of the time-limited Pendulum, rollout 128) and ``a2c``
(32 lanes of the time-limited CartPole, rollout 8, one step per iteration).
``--steps`` counts iterations there; after one warm iteration the same three
measurements are taken per iteration, with the phases: the collect steps'
act, env step and store into the rollout; the update, split for PPO and A2C
into V on the next observations, GAE (PPO) or the n-step returns (A2C), the
minibatch forwards, backward and optimizer, and for TRPO into GAE, the
policy step (of which CG and the line search) and the value function's fit.

The recurrent family (``experiments/recurrent.py``): ``drqn-atarisim-32``
(``make_drqn_atarisim_runner()``: 32 lanes of 84x84x1 frames, the Nature
CNN and an LSTM of 512, 8 batch-32 window updates per scan step over the
2,048 x 128 episodic buffer on the card; its replay start is cut to
``recurrent.DRQN_ATARISIM_CUT_REPLAY_START``, 4,160 transitions, past the
first rows sealed by filling at 128 steps),
``drqn-po-abc-16``, ``drqn-delayedcue-16`` and ``riqn-delayedcue-16`` take
the episodic phases: act, env step, replay add, the window sample, the
gradient step (of which the unrolls, the backward and the optimizer) and
the target sync; ``rppo-delayedcue-16`` and ``rtrpo-delayedcue-16`` the
recurrent collect (act, V on the next observations with the carry after
the step, env step, store) and the update, split into GAE and the chunk
unrolls with backward and optimizer (PPO), or the policy step (of which CG
and the line search) and the value function's fit over chunks (TRPO).

ACER (``experiments/acer.py``): ``acer-atarisim-16``
(``make_acer_atarisim_runner()``: 16 lanes of 84x84x4 AtariSim frames,
``SmallAtariCNN``, one batch-16 update of whole 50-step rows per scan
step over the 2,048 x 50 episodic buffer on the card, from 10,000
transitions on), ``acer-abc-16`` and ``acer-continuous-abc-16`` take the
episodic phases with the act that stores the behaviour distribution, and
the update's Retrace recursion apart. The Atari on-policy examples,
``a2c-atarisim-16`` (16 lanes, rollout 5, one step per iteration),
``a3c-atarisim-16`` (``train_a3c.py --sim``: the same widths, the network's
own ``x / 255`` and RMSprop behind a global-norm clip of 40) and
``ppo-atarisim-8`` (8 lanes, rollout 128, 16 batch-256 Adam steps per
iteration), take the on-policy phases of A2C, A3C and PPO.

The Atari examples at their own settings (``experiments/atari_dqn_ale.py``,
``atari_c51.py``; 64 lanes, a 10^6-slot ring, 16 batch-32 updates per scan
step): ``dqn-ale-nature-64``, ``dqn-ale-nips-64`` and
``dqn-ale-dueling-64`` (``train_dqn_ale.py --sim --arch A``: Adam, the
mean loss, the uniform ring), ``per-dqn-ale-64`` (``--prioritized``: the
prefix-sample kernel at C = 2^20) and ``c51-atarisim-64``
(``train_categorical_dqn_ale.py --sim``); their replay start is cut from
50,000 to 2,048, as Rainbow's is. ``dqn-pipeline-288``
(``experiments/atari_pipeline.make_dqn_pipeline()``: 3 actor processes x 96
lanes of ``SyntheticALE``, the 999,936-plane ring, bursts of 64 updates) is
no runner: it is started, run through its replay start of 50,000, then
``--steps`` seconds timed (env-steps/s, updates/s, and the host's act round
trips, commits, bursts' gathers and updates from ``timings()``), then
``--steps`` seconds under ``torch.profiler`` (kernels per second and per
env step, the device's busy share of that wall time), then stopped.

``dqn-batch-ale-8`` (``experiments/atari_dqn_batch.py``,
``train_dqn_batch_ale.py``'s ``run_batch``: the ``DQN`` shell, the
10^6-slot ring, 8 + 8 spawned ``SyntheticALE`` workers) is driven one batch
step at a time by ``train_agent_batch_with_evaluation``
(``experiments/profile_host.py``): its replay start cut to 2,048, then
``--steps`` batch steps under ``torch.profiler`` and ``--steps`` more timed
(env-steps/s, updates/s, and the median ``batch_act``, env round trip,
``batch_observe`` and update), then one evaluation of 10 episodes. The
host paths of ``profile_host.HOST_PATHS`` (the MuJoCo reproduction
examples' shells over ``MujocoSim`` at HalfCheetah's and Hopper's sizes,
and SlimeVolley Rainbow on CartPole) run the same way through their
scripts' drivers: an off-policy shell's replay start cut to 2,048, then
``--steps`` batch steps profiled and ``--steps`` more timed; an on-policy
shell over two updates, ``--steps`` batch steps profiled around the second.
``dqn-actor-learner-ale-8`` (``train_dqn_batch_ale.py --actor-learner``:
8 actor threads, the inference server, the poller and the learner over
the 10^6-slot ring) runs from a thread of its own: its replay start cut to
2,048, ``2 * --steps`` updates timed, then ``--steps`` under
``torch.profiler`` (env-steps/s before the replay start and after it, updates/s, rows per forward, act round trips, poller add and
learner update ms, kernels per update, the busy share).

``--bf16`` builds the configuration at ``compute_dtype=torch.bfloat16``
(bf16 compute over float32 masters, as the examples' ``--bf16``); TRPO
refuses it by name.

Prints a summary and writes the record as JSON to ``--out``.
"""

import argparse
import collections
import contextlib
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pfrl_tpu_torch.agents import a2c as a2c_module
from pfrl_tpu_torch.agents import acer as acer_module
from pfrl_tpu_torch.agents import ppo as ppo_module
from pfrl_tpu_torch.agents import recurrent_ppo as rppo_module
from pfrl_tpu_torch.agents import recurrent_trpo as rtrpo_module
from pfrl_tpu_torch.agents import trpo as trpo_module
from pfrl_tpu_torch.agents.a2c import A2CCore
from pfrl_tpu_torch.agents.ppo import PPOCore
from pfrl_tpu_torch.agents.recurrent_ppo import RecurrentPPOCore
from pfrl_tpu_torch.agents.recurrent_trpo import RecurrentTRPOCore
from pfrl_tpu_torch.agents.trpo import TRPOCore
from pfrl_tpu_torch.experiments import (
    acer,
    atari_a3c,
    atari_c51,
    atari_dqn_ale,
    atari_dqn_batch,
    cartpole_value,
    onpolicy,
    recurrent,
)
from pfrl_tpu_torch.experiments.atari_pipeline import make_dqn_pipeline
from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner, make_per_dqn_runner
from pfrl_tpu_torch.experiments.atari_rainbow import make_rainbow_runner
from pfrl_tpu_torch.experiments.profile_host import HOST_PATHS
from pfrl_tpu_torch.experiments.mujoco_actor_critic import (
    make_ddpg_runner,
    make_sac_pendulum_runner,
    make_sac_runner,
    make_td3_runner,
)

def _maker(make, replay_arg="capacity", **fixed):
    """A recipe as ``build(device=None, compute_dtype=None, capacity=None)
    -> runner``: ``capacity`` sizes the replay through the recipe's
    ``replay_arg`` (a ring's slots, an episodic buffer's rows; None keeps
    the recipe's; ``replay_arg=None`` for an on-policy recipe, which keeps
    no replay); a recipe's ``(runner, eval_loop)`` gives its runner."""

    def build(capacity=None, **kw):
        if capacity is not None and replay_arg is not None:
            kw[replay_arg] = capacity
        out = make(**{**fixed, **kw})
        return out[0] if isinstance(out, tuple) else out

    return build


# ``--config`` name -> ``build(device=None, compute_dtype=None, capacity=None)``.
CONFIGS = {
    "per-dqn": _maker(make_per_dqn_runner),
    "dqn": _maker(make_dqn_runner),
    "rainbow": _maker(make_rainbow_runner, replay_start_size=2_048),
    "sac": _maker(make_sac_runner),
    "td3": _maker(make_td3_runner),
    "ddpg": _maker(make_ddpg_runner),
    "sac-pendulum": _maker(make_sac_pendulum_runner),
    **{name: _maker(make) for name, make in cartpole_value.RECIPES.items()},
    "ppo": _maker(onpolicy.make_ppo_runner, None),
    "ppo-pendulum": _maker(onpolicy.make_ppo_pendulum_runner, None),
    "trpo": _maker(onpolicy.make_trpo_pendulum_runner, None),
    "a2c": _maker(onpolicy.make_a2c_cartpole_runner, None),
    "drqn-atarisim-32": _maker(recurrent.make_drqn_atarisim_runner, "max_episodes",
                               replay_start_size=recurrent.DRQN_ATARISIM_CUT_REPLAY_START),
    "drqn-po-abc-16": _maker(recurrent.make_drqn_po_abc_runner, "max_episodes"),
    "drqn-delayedcue-16": _maker(recurrent.make_drqn_delayed_cue_runner, "max_episodes"),
    "riqn-delayedcue-16": _maker(recurrent.make_riqn_delayed_cue_runner, "max_episodes"),
    "rppo-delayedcue-16": _maker(recurrent.make_rppo_delayed_cue_runner, None),
    "rtrpo-delayedcue-16": _maker(recurrent.make_rtrpo_delayed_cue_runner, None),
    **{name: _maker(make, "max_episodes") for name, make in acer.RECIPES.items()},
    "a2c-atarisim-16": _maker(onpolicy.make_a2c_atarisim_runner, None),
    "a3c-atarisim-16": _maker(atari_a3c.make_a3c_atarisim_runner, None),
    "ppo-atarisim-8": _maker(onpolicy.make_ppo_atarisim_runner, None),
    **{f"dqn-ale-{arch}-64": _maker(atari_dqn_ale.make_dqn_ale_runner, arch=arch, replay_start_size=2_048)
       for arch in atari_dqn_ale.ARCHS},
    "per-dqn-ale-64": _maker(atari_dqn_ale.make_dqn_ale_runner, prioritized=True, replay_start_size=2_048),
    "c51-atarisim-64": _maker(atari_c51.make_c51_atarisim_runner, replay_start_size=2_048),
}
# ``--config`` name -> ``build(device=None, compute_dtype=None, capacity=None)``
# of an actor-learner pipeline (not a runner).
PIPELINES = {"dqn-pipeline-288": _maker(make_dqn_pipeline)}
# A host-env object path: a shell over spawned vector envs (not a runner).
HOSTS = {"dqn-batch-ale-8": atari_dqn_batch.make_dqn_batch_agent}
HOST_REPLAY_START = 2_048

# Labels that start with two spaces are parts of the phase above them.
COMMON_PHASES = (
    ("core", "select_action", "act"),
    ("env", "step", "env step"),
    ("buffer", "add", "replay add"),
    ("core", "update", "gradient step"),
)
DQN_PHASES = (
    ("core", "loss_and_errors", "  of which forwards (loss)"),
    ("autograd", "grad", "  of which backward"),
    ("optimizer", "update", "  of which optimizer"),
    ("core", "sync_target", "target sync"),
)
ACTOR_CRITIC_PHASES = (
    ("core", "critic_step", "  of which critic step"),
    ("core", "actor_step", "  of which actor (and temperature) step"),
    ("core", "sync_target", "  of which soft copies"),
)
PRIORITIZED_PHASES = (
    ("buffer", "sample", "PER sample"),
    ("buffer", "_find_slots", "  of which prefix_sample + clamp"),
    ("buffer", "gather", "  of which row gather"),
    ("buffer", "update_priorities", "priority feedback"),
)
UNIFORM_PHASES = (
    ("buffer", "sample_indices", "id draw"),
    ("buffer", "gather", "row gather"),
)
EPISODIC_PHASES = (
    ("core", "select_action_recurrent", "act"),
    ("core", "select_action_with_extras", "act"),
    ("env", "step", "env step"),
    ("buffer", "add", "replay add"),
    ("buffer", "sample_episodes", "window sample"),
    ("core", "update_episodic", "gradient step"),
    ("core", "unroll", "  of which unrolls (forwards, burn-in too)"),
    ("core", "unroll_quantiles", "  of which unrolls (forwards)"),
    ("autograd", "grad", "  of which backward"),
    ("optimizer", "update", "  of which optimizer"),
    ("core", "sync_target", "target sync"),
)
# ACER's part of its gradient step, after the episodic phases' own.
ACER_PHASES = (("acer", "retrace", "  of which Retrace (the reverse loop over T)"),)
COLLECT_PHASES = (
    ("core", "act_with_aux", "act"),
    ("env", "step", "env step"),
    ("runner", "_store", "store into the rollout"),
    ("core", "update", "update"),
)
RECURRENT_COLLECT_PHASES = (
    ("core", "act_with_aux_recurrent", "act"),
    ("core", "value_recurrent", "V on the next obs (carry after the step)"),
    ("env", "step", "env step"),
    ("runner", "_store", "store into the rollout"),
    ("core", "update", "update"),
)
# Keyed by the on-policy core's class.
UPDATE_PHASES = {
    PPOCore: (
        ("core", "next_values", "  of which V on next_obs"),
        ("ppo", "gae_advantages", "  of which GAE"),
        ("core", "_minibatch_loss", "  of which minibatch forwards (loss)"),
        ("autograd", "grad", "  of which backward"),
        ("optimizer", "update", "  of which optimizer"),
    ),
    A2CCore: (
        ("core", "next_values", "  of which V on next_obs"),
        ("a2c", "discounted_returns", "  of which n-step returns"),
        ("core", "loss", "  of which forwards (loss)"),
        ("autograd", "grad", "  of which backward"),
        ("optimizer", "update", "  of which optimizer"),
    ),
    RecurrentPPOCore: (
        ("rppo", "gae_advantages", "  of which GAE"),
        ("core", "_chunk_loss", "  of which chunk unrolls (loss)"),
        ("autograd", "grad", "  of which backward"),
        ("optimizer", "update", "  of which optimizer"),
    ),
    RecurrentTRPOCore: (
        ("rtrpo", "gae_advantages", "  of which GAE"),
        ("core", "_recurrent_policy_step", "  of which policy step"),
        ("rtrpo", "conjugate_gradient", "  of which CG (in the policy step)"),
        ("core", "_line_search", "  of which line search (in the policy step)"),
        ("core", "_vf_fit_chunks", "  of which value-function fit"),
    ),
    TRPOCore: (
        ("trpo", "gae_advantages", "  of which GAE"),
        ("core", "_policy_step", "  of which policy step"),
        ("trpo", "conjugate_gradient", "  of which CG (in the policy step)"),
        ("core", "_line_search", "  of which line search (in the policy step)"),
        ("core", "_vf_fit", "  of which value-function fit"),
    ),
}


def _synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _wrap(acc, label, fn):
    def timed(*args, **kwargs):
        out, seconds = _synced(lambda: fn(*args, **kwargs))
        acc[label] += seconds
        return out

    return timed


def profile_config(config: str, steps: int, compute_dtype=None) -> dict:
    """Builds ``config`` on the card and profiles it: per scan step through
    an off-policy runner, per iteration through an on-policy one, per
    second through a pipeline."""
    if config in PIPELINES:
        return profile_pipeline(PIPELINES[config](compute_dtype=compute_dtype), config, steps, compute_dtype)
    if config in HOSTS:
        return profile_host_batch(config, steps, compute_dtype)
    if config in HOST_PATHS:
        return profile_host_path(config, steps, compute_dtype)
    runner = CONFIGS[config](compute_dtype=compute_dtype)
    measure = profile_onpolicy if hasattr(runner, "run_iterations") else profile_slice
    return measure(runner, config, steps, compute_dtype)


def profile_slice(runner, config: str, steps: int, compute_dtype=None) -> dict:
    cfg = runner.config
    actor_critic = hasattr(runner.core, "critic_step")
    if hasattr(runner.buffer, "sample_episodes"):
        phases = tuple(p for p in EPISODIC_PHASES if p[0] != "core" or hasattr(runner.core, p[1]))
        if isinstance(runner.core, (acer_module.ACERCore, acer_module.ACERContinuousCore)):
            phases += ACER_PHASES
    else:
        phases = (
            COMMON_PHASES
            + (ACTOR_CRITIC_PHASES if actor_critic else DQN_PHASES)
            + (UNIFORM_PHASES if runner.buffer.iid_samples else PRIORITIZED_PHASES)
        )
    state = runner.init(0)
    warm = -(-cfg.replay_start_size // cfg.num_envs) + 2  # past replay start
    state, _ = runner.run_chunk(state, warm)

    (state, _), plain_s = _synced(lambda: runner.run_chunk(state, steps))

    owners = {
        "core": runner.core, "env": runner.env, "buffer": runner.buffer,
        "autograd": torch.autograd, "optimizer": getattr(runner.core, "optimizer", None), "acer": acer_module,
    }
    with _phase_timers(phases, owners) as acc:
        (state, _), phased_s = _synced(lambda: runner.run_chunk(state, steps))
    (state, _), profiled_s, kernels, busy_us, top = _profiled(lambda: runner.run_chunk(state, steps))
    return {
        "device": torch.cuda.get_device_name(0),
        "config": config,
        "compute_dtype": str(compute_dtype),
        "steps": steps,
        "updates_per_step": cfg.updates_per_step,
        "scan_step_ms": plain_s / steps * 1e3,
        "env_steps_per_s": steps * cfg.num_envs / plain_s,
        "phase_ms_per_step_synchronized": _per_step_ms(acc, phased_s, steps),
        "phased_scan_step_ms": phased_s / steps * 1e3,
        "profiled_scan_step_ms": profiled_s / steps * 1e3,
        "device_launches_per_step": kernels / steps,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / 1e6 / plain_s,
        "top_device_ops": _top(top, steps),
    }


def profile_onpolicy(runner, config: str, iterations: int, compute_dtype=None) -> dict:
    """The on-policy counterpart of :func:`profile_slice`, per iteration."""
    state = runner.init(0)
    state, _ = runner.run_iterations(state, 1)  # warm: allocates the rollout

    updates_before = state.train_state.n_updates
    (state, _), plain_s = _synced(lambda: runner.run_iterations(state, iterations))
    updates = state.train_state.n_updates - updates_before
    owners = {
        "core": runner.core, "env": runner.env, "runner": runner, "autograd": torch.autograd,
        "optimizer": getattr(runner.core, "optimizer", None),
        "ppo": ppo_module, "a2c": a2c_module, "trpo": trpo_module, "rppo": rppo_module, "rtrpo": rtrpo_module,
    }
    collect = RECURRENT_COLLECT_PHASES if runner.recurrent else COLLECT_PHASES
    with _phase_timers(collect + UPDATE_PHASES[type(runner.core)], owners) as acc:
        (state, _), phased_s = _synced(lambda: runner.run_iterations(state, iterations))
    (state, _), profiled_s, kernels, busy_us, top = _profiled(lambda: runner.run_iterations(state, iterations))
    transitions = runner.num_envs * runner.rollout_len
    return {
        "device": torch.cuda.get_device_name(0),
        "config": config,
        "compute_dtype": str(compute_dtype),
        "iterations": iterations,
        "transitions_per_iteration": transitions,
        "gradient_steps_per_iteration": updates / iterations,
        "iteration_ms": plain_s / iterations * 1e3,
        "env_steps_per_s": iterations * transitions / plain_s,
        "phase_ms_per_iteration_synchronized": _per_step_ms(acc, phased_s, iterations),
        "phased_iteration_ms": phased_s / iterations * 1e3,
        "profiled_iteration_ms": profiled_s / iterations * 1e3,
        "device_launches_per_iteration": kernels / iterations,
        "device_busy_ms_per_iteration": busy_us / iterations / 1e3,
        "device_busy_share": busy_us / 1e6 / plain_s,
        "top_device_ops": _top(top, iterations),
    }


def run_pipeline(pipeline, seconds: float, profiled_seconds: float = 0.0, start_timeout: float = 600.0) -> dict:
    """Starts ``pipeline``, waits for its replay start, runs it ``seconds``
    timed and ``profiled_seconds`` under ``torch.profiler``, and stops it
    (also when a thread fails, which raises). Returns the rates over the
    timed window, ``timings()`` and the profiled window's kernels and busy
    time."""
    t0 = time.perf_counter()
    pipeline.start()
    try:
        def wait(until):
            while not until():
                if pipeline.exception_event.is_set():
                    raise RuntimeError("the pipeline failed (see the log)")
                time.sleep(0.05)

        deadline = t0 + start_timeout
        wait(lambda: pipeline.optim_t > 0 or time.perf_counter() > deadline)
        if pipeline.optim_t == 0:
            raise RuntimeError(f"no update within {start_timeout} s of the start")
        start_s = time.perf_counter() - t0
        acted0, optim0, t1 = pipeline.acted_steps, pipeline.optim_t, time.perf_counter()
        wait(lambda: time.perf_counter() - t1 >= seconds)
        timed_s = time.perf_counter() - t1
        acted1, optim1 = pipeline.acted_steps, pipeline.optim_t
        record = {
            "start_to_first_burst_s": start_s,
            "timed_s": timed_s,
            "env_steps_per_s": (acted1 - acted0) / timed_s,
            "updates_per_s": (optim1 - optim0) / timed_s,
        }
        if profiled_seconds:
            def window():
                t = time.perf_counter()
                wait(lambda: time.perf_counter() - t >= profiled_seconds)

            acted2 = pipeline.acted_steps
            _, profiled_s, kernels, busy_us, top = _profiled(window)
            acted = pipeline.acted_steps - acted2
            record.update({
                "profiled_s": profiled_s,
                "device_launches_per_s": kernels / profiled_s,
                "device_launches_per_env_step": kernels / max(acted, 1),
                "device_busy_share": busy_us / 1e6 / profiled_s,
                "top_device_ops": _top(top, 1),
            })
    finally:
        pipeline.stop()
    if pipeline.exception_event.is_set():
        raise RuntimeError("the pipeline failed (see the log)")
    record.update({"acted_steps": pipeline.acted_steps, "optim_t": pipeline.optim_t,
                   "statistics": dict(pipeline.get_statistics()), "timings": pipeline.timings()})
    return record


def profile_pipeline(pipeline, config: str, seconds: float, compute_dtype=None) -> dict:
    """The pipeline counterpart of :func:`profile_slice`: ``seconds`` timed
    after replay start, then as long under the profiler."""
    record = run_pipeline(pipeline, seconds, seconds)
    return {"device": torch.cuda.get_device_name(0), "config": config, "compute_dtype": str(compute_dtype),
            "lanes": pipeline.L, "burst": pipeline.burst, "ring_bytes": pipeline.ring.nbytes, **record}


def profile_host_batch(config: str, steps: int, compute_dtype=None) -> dict:
    """The host path's counterpart of :func:`profile_slice`: replay start
    cut to 2,048, ``2 * steps`` batch steps past it, the first ``steps``
    profiled and the next timed, one evaluation of 10 episodes at the end.
    The driver's output directory (with the agents it saves) is a temporary
    one."""
    import tempfile

    from pfrl_tpu_torch.experiments.profile_host import run_host_batch

    agent = HOSTS[config](replay_start_size=HOST_REPLAY_START, compute_dtype=compute_dtype)
    env, eval_env = atari_dqn_batch.make_vector_envs(agent.buffer.num_lanes)
    lanes = env.num_envs
    total = HOST_REPLAY_START + 2 * steps * lanes
    try:
        with tempfile.TemporaryDirectory() as outdir:
            record = run_host_batch(agent, env, eval_env, total, total, 10, outdir,
                                    profiled=(HOST_REPLAY_START, steps))
    finally:
        for e in (env, eval_env):
            if not e.closed:
                e.close()
    return {"config": config, "compute_dtype": str(compute_dtype), **record}


def profile_host_path(config: str, steps: int, compute_dtype=None) -> dict:
    """A path of ``profile_host.HOST_PATHS`` on the card (see the module
    docstring), one evaluation at the end."""
    import tempfile

    from pfrl_tpu_torch.experiments.profile_host import _keywords, make_host_path, run_host_batch

    if HOST_PATHS[config].actors:
        return profile_actor_learner(config, steps, compute_dtype)
    onpolicy = "replay_start_size" not in _keywords(HOST_PATHS[config].make_agent)
    kw = {} if onpolicy else {"replay_start_size": HOST_REPLAY_START}
    agent, env, eval_env = make_host_path(config, compute_dtype=compute_dtype, **kw)
    lanes = getattr(env, "num_envs", 1)
    if onpolicy:
        total, profiled = 2 * agent.update_interval, (2 * agent.update_interval - steps * lanes, steps)
    else:
        total, profiled = HOST_REPLAY_START + 2 * steps * lanes, (HOST_REPLAY_START, steps)
    with tempfile.TemporaryDirectory() as outdir:
        record = run_host_batch(agent, env, eval_env, total, total, HOST_PATHS[config].eval_n_episodes, outdir,
                                profiled=profiled)
    return {"config": config, "compute_dtype": str(compute_dtype), **record}


def profile_actor_learner(config: str, steps: int, compute_dtype=None) -> dict:
    """An actor-learner path of ``profile_host.HOST_PATHS`` on the card: its
    replay start cut to 2,048, ``2 * --steps`` updates timed, then
    ``--steps`` profiled; no evaluation (its interval is past the run's
    end)."""
    import tempfile

    from pfrl_tpu_torch.experiments.profile_host import run_actor_learner_path

    path = HOST_PATHS[config]
    agent = path.make_agent(replay_start_size=HOST_REPLAY_START, compute_dtype=compute_dtype)
    with tempfile.TemporaryDirectory() as outdir:
        record = run_actor_learner_path(agent, path.make_env, path.steps, path.steps, path.eval_n_episodes, outdir,
                                        actors=path.actors, n_updates=3 * steps, profiled=(2 * steps, steps))
    return {"config": config, "compute_dtype": str(compute_dtype), **record}


@contextlib.contextmanager
def _phase_timers(phases, owners):
    """Wraps each ``(owner, attribute, label)`` in a synchronizing timer that
    adds its seconds to ``acc[label]``; yields ``acc``; restores all."""
    acc = collections.defaultdict(float)
    originals = []
    for owner, attr, label in phases:
        obj = owners[owner]
        originals.append((obj, attr, vars(obj).get(attr)))
        setattr(obj, attr, _wrap(acc, label, getattr(obj, attr)))
    try:
        yield acc
    finally:
        for obj, attr, own in reversed(originals):
            if own is None:
                delattr(obj, attr)  # back to the class's method
            else:
                setattr(obj, attr, own)  # a module's function


def _profiled(fn):
    """``fn``'s result and host seconds under ``torch.profiler``, the
    kernels it launched, their busy microseconds, and the top 15 by time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, seconds = _synced(fn)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return out, seconds, len(kernels), busy_us, top


def _per_step_ms(acc, phased_s: float, steps: int) -> dict:
    accounted = sum(v for k, v in acc.items() if not k.startswith("  "))
    per_step_ms = {k: v / steps * 1e3 for k, v in acc.items()}
    per_step_ms["other (runner bookkeeping, timers)"] = (phased_s - accounted) / steps * 1e3
    return per_step_ms


def _top(top, steps: int) -> list:
    return [
        {"name": name, "ms_per_step": us / steps / 1e3, "launches_per_step": n / steps}
        for name, (us, n) in top
    ]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=sorted([*CONFIGS, *PIPELINES, *HOSTS, *HOST_PATHS]), default="per-dqn")
    parser.add_argument("--steps", type=int, default=8,
                        help="scan steps, iterations of an on-policy config, seconds of a pipeline, "
                             "or batch steps of a host path")
    parser.add_argument("--bf16", action="store_true", help="bf16 compute over float32 masters")
    parser.add_argument("--out", default=None, help="default: chiprun_out/profile_<config>[_bf16].json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    dtype = torch.bfloat16 if args.bf16 else None
    record = profile_config(args.config, args.steps, dtype)
    out = Path(args.out or f"chiprun_out/profile_{args.config}{'_bf16' if args.bf16 else ''}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({k: v for k, v in record.items() if k != "top_device_ops"}, indent=1))
    for op in record.get("top_device_ops", []):
        print(f"{op['ms_per_step']:9.3f} ms/step {op['launches_per_step']:8.1f} launches/step  {op['name'][:90]}")


if __name__ == "__main__":
    main()
