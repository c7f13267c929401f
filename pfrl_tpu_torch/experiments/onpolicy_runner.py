"""On-policy training loop (counterpart of
``pfrl_tpu/experiments/onpolicy_runner.py``) for the PPO, A2C and TRPO cores.

The JAX runner compiles an iteration, a ``[T, L]`` rollout collected by
``lax.scan`` (act, env step) and the core's update, into one program and
scans ``n`` of them. Here an iteration is :meth:`OnPolicyRunner._iteration`:
a Python loop over the ``T`` collect steps, which write each step into
preallocated time-major ``[T, L, ...]`` rollout tensors in place, then the
core's ``update`` on that rollout. The step counter ``t`` lives on the host;
everything else stays on the device and no step waits for the device.
:class:`OnPolicyRunnerState` is updated **in place**.

Draws, in order, as the JAX runner splits its key: per collect step the
core's act draw (the distribution's sample), then the env's resets (one for
every lane, kept where the episode ended); after the ``T`` steps the
update's draws (PPO: one ``permutation`` per epoch; TRPO: one per
value-function epoch; A2C: none).

A recurrent core (``core.recurrent``) acts from the carry in
``act_state``; each step stores the carry before acting
(``Rollout.carry``) and V(s_{t+1}) on the pre-reset next observation with
the carry after the step (``Rollout.next_value``), then resets the carry's
rows where the episode ended.

**A mesh** (``mesh=``) changes the layout, not the result, as in the JAX
package and in :class:`~pfrl_tpu_torch.experiments.runner.OffPolicyRunner`:
each rank steps and acts for its lanes only, from its lanes' part of every
per-lane draw (``LaneDraws``); at the end of the ``T`` collect steps the
rollout is all-gathered along the lanes (a recurrent core's stored
carries too), so every rank holds the whole ``[T, L]`` rollout and draws
the same global minibatch permutation. A core with ``splits_over_mesh``
(PPO, A2C, recurrent PPO) splits each minibatch's rows (or chunks) over
the ranks, each rank differentiates its share and the gradients are
averaged with an all-reduce before the identical optimizer step. TRPO and
recurrent TRPO do not split: every rank runs the whole update on the
whole rollout (the conjugate gradient, the line search, the value fit),
so the replicated state equals the single-process run's to the bit
(``agents/trpo.py``). The finished lanes' rewards and flags are
all-gathered every step for the returns ring. Over one rank the run
equals the run without a mesh to the bit.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from pfrl_tpu_torch._device import check_same_device, resolve_device, use_full_fp32
from pfrl_tpu_torch.agents.ppo import Rollout
from pfrl_tpu_torch.envs.vector_env import VectorTorchEnv
from pfrl_tpu_torch.experiments.runner import record_returns, recent_return_mean
from pfrl_tpu_torch.parallel.data_parallel import data_parallel_core, reduce_aux
from pfrl_tpu_torch.parallel.lane_sharding import LaneDraws
from pfrl_tpu_torch.parallel.mesh import all_gather_rows, local_rows, replicate
from pfrl_tpu_torch.utils.draws import Draws
from pfrl_tpu_torch.utils.recurrent import tree_map


@dataclasses.dataclass
class OnPolicyRunnerState:
    env_states: Any
    obs: torch.Tensor
    train_state: Any
    draws: Any                     # the JAX state's rng
    t: int                         # env transitions so far
    episode_return: torch.Tensor   # [L] running returns
    recent_returns: torch.Tensor   # [window] ring of completed returns
    recent_count: torch.Tensor     # int32 0-d
    rollout: Optional[Rollout] = None  # [T, L, ...], allocated at the first collect step
    act_state: Any = ()                # a recurrent core's carry


class OnPolicyRunner:
    def __init__(
        self,
        env,
        core,
        num_envs: int,
        rollout_len: int,
        return_window: int = 256,
        device=None,
        mesh=None,
    ):
        self.device = check_same_device(runner=resolve_device(device), env=env.device)
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.return_window = return_window
        self.recurrent = getattr(core, "recurrent", False)
        self.mesh = mesh
        lanes = num_envs
        self.splits = mesh is not None and getattr(core, "splits_over_mesh", False)
        if mesh is not None:
            mine = local_rows(mesh, num_envs)  # raises unless the lanes divide evenly
            lanes = mine.stop - mine.start
            if self.splits:
                core = data_parallel_core(core, mesh)
        self.env = VectorTorchEnv(env, lanes)
        self.core = core
        if self.device.type == "cuda":
            use_full_fp32()

    def init(self, seed: int, draws=None) -> OnPolicyRunnerState:
        """``draws`` replaces the default source, one ``torch.Generator`` on
        the device seeded with ``seed``. The env's resets are drawn first;
        the weights come from a CPU generator seeded with ``seed``."""
        if draws is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            draws = Draws(gen)
        env_states, obs = self.env.reset(self._lane_draws(draws))
        train_state = self.core.init(torch.Generator().manual_seed(seed), obs)
        if self.mesh is not None:
            replicate(self.mesh, train_state)
        return OnPolicyRunnerState(
            env_states=env_states,
            obs=obs,
            train_state=train_state,
            draws=draws,
            t=0,
            episode_return=torch.zeros(self.num_envs, dtype=torch.float32, device=self.device),
            recent_returns=torch.zeros(self.return_window, dtype=torch.float32, device=self.device),
            recent_count=torch.zeros((), dtype=torch.int32, device=self.device),
            act_state=self.core.init_act_state(self.env.num_envs, self.device) if self.recurrent else (),
        )

    def _lane_draws(self, draws):
        return draws if self.mesh is None else LaneDraws(draws, self.mesh)

    # ------------------------------------------------------------- iteration
    def _allocate(self, state, action, aux) -> Rollout:
        def empty(like):
            return torch.empty((self.rollout_len,) + tuple(like.shape), dtype=like.dtype, device=self.device)

        flags = torch.zeros(self.env.num_envs, dtype=torch.bool, device=self.device)
        if self.recurrent:
            recurrent = dict(carry=tree_map(empty, state.act_state), next_value=empty(aux["value"]))
        else:
            recurrent = {}
        return Rollout(
            **recurrent,
            obs=empty(state.obs),
            action=empty(action),
            log_prob=empty(aux["log_prob"]),
            value=empty(aux["value"]),
            reward=empty(flags.to(torch.float32)),
            terminated=empty(flags),
            done=empty(flags),
            next_obs=empty(state.obs),
        )

    def _store(self, rollout: Rollout, i: int, **step) -> None:
        for name, value in step.items():
            tree_map(lambda dst, src: dst[i].copy_(src), getattr(rollout, name), value)

    def _collect_step(self, state: OnPolicyRunnerState, i: int) -> None:
        draws = self._lane_draws(state.draws)
        if self.recurrent:
            pre_act_carry = state.act_state
            action, aux, act_state = self.core.act_with_aux_recurrent(
                state.train_state, draws, state.obs, True, state.act_state)
        else:
            action, aux = self.core.act_with_aux(state.train_state, draws, state.obs, True)
        env_states, vec = self.env.step(draws, state.env_states, action)
        ts = vec.ts
        if state.rollout is None:
            state.rollout = self._allocate(state, action, aux)
        recurrent = {}
        if self.recurrent:
            recurrent = dict(
                carry=pre_act_carry, next_value=self.core.value_recurrent(state.train_state, ts.obs, act_state))
            state.act_state = self.core.reset_act_state(act_state, ts.done)
        self._store(
            state.rollout, i, obs=state.obs, action=action, log_prob=aux["log_prob"], value=aux["value"],
            reward=ts.reward, terminated=ts.terminated, done=ts.done, next_obs=ts.obs, **recurrent,
        )
        reward, done = (ts.reward, ts.done) if self.mesh is None else all_gather_rows(self.mesh, (ts.reward, ts.done))
        record_returns(state, reward, done, self.return_window)
        state.env_states = env_states
        state.obs = vec.obs

    def _iteration(self, state: OnPolicyRunnerState) -> Dict[str, torch.Tensor]:
        for i in range(self.rollout_len):
            self._collect_step(state, i)
        if self.mesh is None:
            _, aux = self.core.update(state.train_state, state.draws, state.rollout)
        else:
            rollout = all_gather_rows(self.mesh, state.rollout, dim=1)
            _, aux = self.core.update(state.train_state, state.draws, rollout)
            if self.splits:  # else every rank computed the whole update
                aux = reduce_aux(self.mesh, aux)
        state.t += self.rollout_len * self.num_envs
        return aux

    def run_iterations(self, state: OnPolicyRunnerState, n: int) -> Tuple[OnPolicyRunnerState, Dict[str, torch.Tensor]]:
        """Run ``n`` collect + update iterations; the update's metrics come
        back stacked, ``[n, ...]`` each, on the device."""
        auxes = [self._iteration(state) for _ in range(n)]
        return state, {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}

    def recent_return_mean(self, state: OnPolicyRunnerState) -> float:
        return recent_return_mean(state, self.return_window)
