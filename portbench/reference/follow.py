"""The reference: a run's draws replayed, and the program's answers, read
from its state, judged.

:class:`Observation` is what the benchmark reads of the program's state,
never of its methods: the ring's columns at the end of the run, and for each
observed chunk of scan steps (the first step that updates, at the replay
start, and the window's last chunk) the online and target parameters,
RMSprop's second moments and, with prioritized replay, the leaf priorities,
``max_priority`` and ``beta``, read before each of the chunk's draws and
after its last step, with the loss each step reported and the ring rows it
wrote.

:class:`Follower` replays the draws in the port's documented order (per scan
step: the act's uniforms and random actions, the env's resets of every
lane, then the ids of all of the step's minibatches (uniform ring) or each
update's stratified uniforms (prioritized)) and works out AtariSim's
trajectory from them: every stored frame, reward and episode end. Then it
judges, exactly where the answer is exact:

- every row in the ring and every row an observed step wrote: its frame,
  its reward and episode flags for the stored action, an explored action
  equal to the drawn one (``ring_mismatch``, ``action_mismatch``);
- greedy actions, by the gap of their Q below the best
  (``greedy_q_gap``): all before the first update, under the seed's
  weights, and those of the observed steps, under the parameters read
  before the step;
- the start: the parameters, the target and the moments read before the
  first update are the seed's weights and zeros (``start_mismatch``);
- each update of an observed step, from the program's state before it:
  the sample (prioritized: a slot's interval must hold its stratified
  target, ``slot_gap``), the gather, the Huber loss under the target rule,
  the gradient and RMSprop's step; compared are the loss the step reported
  (its last update's), each leaf's change and, at the first update, each
  leaf's gradient norm as the moments took it (``loss_gap``,
  ``change_gap``, ``grad_gap``), and
  the fed-back priorities, ``max_priority`` and ``beta``
  (``priority_gap``, ``beta_gap``); the trees' side of the step's add;
- the target sync at the end of each observed step (``sync_mismatch``).

Each update is judged from the program's own state before it: two runs of
the program part after a few updates (cuDNN sums the weight gradient in no
fixed order, and a ReLU at the edge tips), so no run of the reference from
the seed could follow a later update. The start is judged by itself.

:meth:`Follower.simulate` is the reference in the program's place, making
its own answers from the seed through the first update step: the control,
when run in TF32.
"""

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference.atari_sim import AtariSimReference
from portbench.reference.draws import DrawMismatch
from portbench.reference.nature_q import precision, q_values

Params = Dict[str, torch.Tensor]
ROW_FIELDS = ("action", "reward", "terminated", "done")


@dataclasses.dataclass
class Snap:
    """The program's state at one point."""
    params: Params
    target: Params
    nu: Params
    leaves: Optional[torch.Tensor] = None
    max_priority: Optional[torch.Tensor] = None
    beta: Optional[torch.Tensor] = None

    def to(self, device) -> "Snap":
        move = lambda x: None if x is None else x.to(device)  # noqa: E731
        table = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
        return Snap(table(self.params), table(self.target), table(self.nu), move(self.leaves),
                    move(self.max_priority), move(self.beta))


@dataclasses.dataclass
class Chunk:
    """Scan steps ``first_step ..`` of one observed call: the state before
    each of their draws (by index in the log) and after the last step, the
    loss each step reported, the ring rows they wrote (``ROW_FIELDS``, in id
    order) and the ring's action column after them (by slot)."""
    first_step: int
    steps: int
    snaps: Dict[int, Snap]
    end: Snap
    losses: torch.Tensor
    rows: Dict[str, torch.Tensor]
    actions: torch.Tensor

    def to(self, device) -> "Chunk":
        return dataclasses.replace(self, snaps={k: v.to(device) for k, v in self.snaps.items()},
                                   end=self.end.to(device), losses=self.losses.to(device),
                                   rows={k: v.to(device) for k, v in self.rows.items()},
                                   actions=self.actions.to(device))


@dataclasses.dataclass
class Observation:
    steps: int
    chunks: List[Chunk]


def updates_per_step(traffic: dict) -> int:
    lanes, interval = traffic["num_envs"], traffic["update_interval"]
    if lanes % interval:
        raise ValueError(f"{lanes} lanes do not make whole updates at one per {interval} transitions")
    return lanes // interval


def first_update_step(cfg: dict, traffic: dict) -> int:
    """The scan step whose transitions reach the replay start: it updates."""
    return -(-cfg["build"]["replay_start_size"] // traffic["num_envs"]) - 1


def epsilon_at(t: int, start: float, end: float, steps: int) -> float:
    """The linear decay in float32, as the configuration's schedule states."""
    f32 = np.float32
    frac = np.clip(f32(t) / f32(steps), f32(0.0), f32(1.0))
    return float(f32(start) + frac * f32(end - start))


def tree_capacity(n: int) -> int:
    return 1 << max(1, math.ceil(math.log2(n)))


class Follower:
    def __init__(self, cfg: dict, traffic: dict, weights: Params, device, tf32: bool = False):
        self.device = torch.device(device)
        self.tf32 = tf32
        build, net = cfg["build"], cfg["network"]
        self.convs = [tuple(c) for c in net["convs"]]
        self.L = traffic["num_envs"]
        self.B = traffic["minibatch_size"]
        self.U = updates_per_step(traffic)
        self.capacity = (build["capacity"] // self.L) * self.L
        self.replay_start = build["replay_start_size"]
        self.sync_interval = build["target_update_interval"]
        self.n_actions = build["n_actions"]
        self.double = bool(build.get("double", False))
        self.eps = (cfg["explorer"]["start_epsilon"], build["final_epsilon"], build["final_exploration_frames"])
        self.opt = cfg["optimizer"]
        self.gamma = cfg["gamma"]
        self.per = cfg.get("per")
        if self.per is None and self.U != 1:
            raise ValueError("the uniform ring draws the ids of all of a step's updates at once, so the state "
                             "between them cannot be read: one update per scan step is judged")
        self.env = AtariSimReference(self.n_actions, build["frame_shape"], cfg["env"]["mean_episode_len"], self.device)
        self.frame_numel = math.prod(build["frame_shape"])
        self.weights = {k: v.detach().to(self.device) for k, v in weights.items()}
        self.names = list(weights)
        self.first = first_update_step(cfg, traffic)
        self.values = {"draw_mismatch": 0, "action_mismatch": 0, "ring_mismatch": 0, "start_mismatch": 0,
                       "sync_mismatch": 0, "greedy_q_gap": 0.0, "loss_gap": 0.0, "grad_gap": 0.0,
                       "change_gap": 0.0}
        if self.per is not None:
            self.values.update(slot_gap=0.0, priority_gap=0.0, beta_gap=0.0)
            self.beta_add = (1.0 - self.per["beta0"]) / self.per["betasteps"]

    # ---------------------------------------------------------------- numbers
    def count(self, name: str, bad) -> None:
        self.values[name] += int(bad.sum()) if torch.is_tensor(bad) else int(bad)

    def gap(self, name: str, value: float) -> None:
        if not value <= self.values[name]:  # NaN counts as the widest
            self.values[name] = value

    # ------------------------------------------------------------- the draws
    def replay(self, draws, steps: int) -> None:
        """Takes the run's ``steps`` scan steps of draws in order and works
        out the trajectory: ``obs_t``/``obs_seed`` ``[S + 1, L]`` (the frame
        each step stored, and the last step's successor), ``ep_len [S, L]``,
        the explorer's ``u``/``random_a [S, L]``, each step's first draw
        index and its updates' draws."""
        dev, L, S = self.device, self.L, steps
        self.steps = S
        self.obs_t = torch.zeros(S + 1, L, dtype=torch.int32, device=dev)
        self.obs_seed = torch.zeros(S + 1, L, dtype=torch.int32, device=dev)
        self.ep_len = torch.zeros(S, L, dtype=torch.int32, device=dev)
        self.u = torch.zeros(S, L, dtype=torch.float32, device=dev)
        self.random_a = torch.zeros(S, L, dtype=torch.int32, device=dev)
        self.eps_step = torch.tensor([epsilon_at(s * L, *self.eps) for s in range(S)], dtype=torch.float32,
                                     device=dev)
        self.step_draw: List[int] = []
        self.update_draws: List[List[tuple]] = []
        t_ep, seed, ep_len = self.env.reset(draws, L)
        for s in range(S):
            self.step_draw.append(draws.at)
            self.obs_t[s], self.obs_seed[s], self.ep_len[s] = t_ep, seed, ep_len
            self.u[s] = draws.uniform(L)
            self.random_a[s] = draws.randint(self.n_actions, L)
            t1 = t_ep + 1
            terminated = t1 >= ep_len
            r_t, r_seed, r_len = self.env.reset(draws, L)
            t_ep = torch.where(terminated, r_t, t1)
            seed = torch.where(terminated, r_seed, seed)
            ep_len = torch.where(terminated, r_len, ep_len)
            ups = []
            if (s + 1) * L >= self.replay_start:
                if self.per is None:
                    ups.append((draws.at, None, draws.raw("randint_below", self.U * self.B)))
                else:
                    for _ in range(self.U):
                        ups.append((draws.at, draws.uniform(self.B), None))
            self.update_draws.append(ups)
        self.step_draw.append(draws.at)
        self.obs_t[S], self.obs_seed[S] = t_ep, seed
        if draws.at != len(draws.log):
            raise DrawMismatch(f"the run made {len(draws.log) - draws.at} draws more than {S} scan steps make")

    def explored(self, s: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
        return self.u[s, lane] < self.eps_step[s]

    # ---------------------------------------------------------------- the ring
    def check_rows(self, ids: torch.Tensor, rows: Dict[str, torch.Tensor], frames=None) -> None:
        """The rows stored at monotonic ``ids``: an explored action is the
        drawn one, every action in range, the reward and flags those of the
        stored action, and where ``frames`` (``ids -> uint8 [n, numel]``) is
        given, the stored frame."""
        ids = ids.to(self.device).long()
        s, lane = ids // self.L, ids % self.L
        a = rows["action"].to(self.device).to(torch.int32)
        self.count("action_mismatch", (self.explored(s, lane) & (a != self.random_a[s, lane]))
                   | (a < 0) | (a >= self.n_actions))
        t1, seed = self.obs_t[s, lane] + 1, self.obs_seed[s, lane]
        reward = (((seed + t1) % 37) == (a % 37 % 7)).to(torch.float32)
        terminated = t1 >= self.ep_len[s, lane]
        self.count("ring_mismatch", rows["reward"].to(self.device) != reward)
        self.count("ring_mismatch", rows["terminated"].to(self.device) != terminated)
        self.count("ring_mismatch", rows["done"].to(self.device) != terminated)
        if frames is not None:
            for i in range(0, ids.shape[0], 1024):
                j = slice(i, i + 1024)
                want = self.env.frames(self.obs_t[s[j], lane[j]], self.obs_seed[s[j], lane[j]]).reshape(-1, self.frame_numel)
                self.count("ring_mismatch", (frames(ids[j]).to(self.device) != want).any(dim=1))

    def check_ring(self, storage: Dict[str, torch.Tensor], cursor: int) -> None:
        """Every row of the program's ring at the end of the run, read from
        its storage (``[capacity]`` columns, ``obs [capacity, width]``)."""
        ids = torch.arange(max(cursor - self.capacity, 0), cursor, device=self.device)
        slots = ids % self.capacity
        rows = {f: storage[f][slots.to(storage[f].device)] for f in ROW_FIELDS}
        obs = storage.get("obs")
        frames = None if obs is None else lambda i: obs[(i % self.capacity).to(obs.device), :self.frame_numel]
        self.check_rows(ids, rows, frames)
        self.greedy_before_start(ids, rows["action"])

    def greedy_before_start(self, ids: torch.Tensor, actions: torch.Tensor) -> None:
        """The greedy actions of the steps before the first update, under
        the seed's weights."""
        ids = ids.to(self.device).long()
        s, lane = ids // self.L, ids % self.L
        keep = (s < self.first) & ~self.explored(s, lane)
        self.judge_greedy(self.weights, self.obs_t[s[keep], lane[keep]], self.obs_seed[s[keep], lane[keep]],
                          actions.to(self.device)[keep])

    # --------------------------------------------------------------- helpers
    def q(self, params: Params, frames_u8: torch.Tensor) -> torch.Tensor:
        with precision(self.tf32, self.device):
            return q_values(params, frames_u8.to(torch.float32) / 255.0, self.convs, self.tf32)

    def judge_greedy(self, params: Params, t: torch.Tensor, seed: torch.Tensor, a: torch.Tensor) -> None:
        """The widest gap by which a greedy answer's Q lies below the best."""
        a = a.long().clamp(0, self.n_actions - 1)
        with torch.no_grad():
            for i in range(0, t.shape[0], 1024):
                q = self.q(params, self.env.frames(t[i:i + 1024], seed[i:i + 1024]))
                gap = q.amax(dim=1) - torch.gather(q, 1, a[i:i + 1024, None])[:, 0]
                self.gap("greedy_q_gap", float(gap.max()))

    def gather(self, ids: torch.Tensor, actions: torch.Tensor, weight: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch at monotonic ``ids``: frames and rewards worked out from
        the trajectory, the bootstrap frame from the successor step,
        ``actions`` the stored ones; uint8 frames dequantized by ``/ 255``."""
        ids = ids.long()
        s, lane = ids // self.L, ids % self.L
        t1, seed = self.obs_t[s, lane] + 1, self.obs_seed[s, lane]
        a = actions.to(torch.int32)
        scale = 1.0 / 255.0
        return {
            "obs": self.env.frames(self.obs_t[s, lane], seed).to(torch.float32) * scale,
            "action": a,
            "reward": (((seed + t1) % 37) == (a % 37 % 7)).to(torch.float32),
            "next_obs": self.env.frames(self.obs_t[s + 1, lane], self.obs_seed[s + 1, lane]).to(torch.float32) * scale,
            "is_terminal": t1 >= self.ep_len[s, lane],
            "weight": weight,
        }

    def loss_and_grads(self, params: Params, target: Params, batch):
        """The summed, weighted Huber loss of ``Q(obs)[a]`` against the
        target rule's bootstrap, its gradient, and the absolute errors."""
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        with precision(self.tf32, self.device):
            y_all = q_values(leaves, batch["obs"], self.convs, self.tf32)
            y = torch.gather(y_all, 1, batch["action"].long()[:, None])[:, 0]
            with torch.no_grad():
                next_target = q_values(target, batch["next_obs"], self.convs, self.tf32)
                if self.double:
                    greedy = q_values(params, batch["next_obs"], self.convs, self.tf32).argmax(dim=1)
                    next_q = torch.gather(next_target, 1, greedy[:, None])[:, 0]
                else:
                    next_q = next_target.amax(dim=1)
                bootstrap = batch["reward"] + self.gamma * (1.0 - batch["is_terminal"].to(torch.float32)) * next_q
            diff = y - bootstrap
            ad = torch.abs(diff)
            huber = torch.where(ad <= 1.0, 0.5 * diff * diff, ad - 0.5)
            loss = (huber * batch["weight"]).sum()
            grads = torch.autograd.grad(loss, [leaves[k] for k in self.names])
        return loss.detach(), dict(zip(self.names, grads)), ad.detach()

    def rmsprop(self, params: Params, nu: Params, grads: Params):
        """optax's RMSprop step (eps inside the root): new params and moments."""
        lr, decay, eps = self.opt["learning_rate"], self.opt["decay"], self.opt["eps"]
        new_p, new_nu = {}, {}
        with torch.no_grad():
            for k in self.names:
                g = grads[k]
                new_nu[k] = (1 - decay) * (g * g) + decay * nu[k]
                new_p[k] = params[k] + -lr * (torch.rsqrt(new_nu[k] + eps) * g)
        return new_p, new_nu

    def priorities(self, errors: torch.Tensor) -> torch.Tensor:
        e = torch.clamp(errors, self.per["error_min"], self.per["error_max"])
        return (e + self.per["eps"]) ** self.per["alpha"]

    def targets(self, leaves: torch.Tensor, u: torch.Tensor):
        """The stratified targets of a sample over ``leaves``, float64, with
        the prefix sums and the total."""
        B = u.shape[0]
        cs = torch.cumsum(leaves.double(), 0)
        total = cs[-1]
        bounds = torch.arange(B + 1, dtype=torch.float64, device=self.device) / B
        targets = torch.minimum((bounds[:-1] + u.double() * (bounds[1:] - bounds[:-1])) * total, total * (1 - 1e-7))
        return targets, cs, total

    def off(self, leaves: torch.Tensor, cs, total, slots: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """``[len(slots), len(targets)]``: how far each target lies outside
        each slot's interval, in mean leaf widths; ``inf`` for a slot out of
        range or of priority 0."""
        C = leaves.shape[0]
        s = torch.clamp(slots.long(), 0, C - 1)
        hi, lo = cs[s], cs[s] - leaves.double()[s]
        width = total / torch.count_nonzero(leaves).clamp_min(1)
        off = torch.clamp_min(torch.maximum(lo[:, None] - targets[None], targets[None] - hi[:, None]), 0.0) / width
        sound = (slots >= 0) & (slots < C) & (leaves[s] > 0)
        return torch.where(sound[:, None], off, torch.full_like(off, math.inf))

    def ids_of(self, slots: torch.Tensor, cursor: int) -> torch.Tensor:
        """A slot's monotonic id: the newest write of it before ``cursor``."""
        lo = max(cursor - self.capacity, 0)
        gen = torch.div(cursor - 1 - slots.long(), self.capacity, rounding_mode="floor")
        return torch.clamp_min(slots.long() + gen * self.capacity, lo)

    # -------------------------------------------------------------- judging
    def judge(self, obs: Observation) -> Dict[str, float]:
        """The numbers of an observed run (after :meth:`replay` and
        :meth:`check_ring`)."""
        starts = [c for c in obs.chunks if c.first_step == self.first]
        if not starts:
            self.values["start_mismatch"] = math.inf
        for chunk in obs.chunks:
            chunk = chunk.to(self.device)
            self.judge_chunk(chunk, start=chunk.first_step == self.first)
        return dict(self.values)

    def judge_chunk(self, chunk: Chunk, start: bool) -> None:
        L = self.L
        n = chunk.steps * L
        ids = torch.arange(chunk.first_step * L, chunk.first_step * L + n, device=self.device)
        self.check_rows(ids, chunk.rows)
        actions = chunk.rows["action"].to(self.device).reshape(chunk.steps, L)
        for i in range(chunk.steps):
            s = chunk.first_step + i
            before = chunk.snaps[self.step_draw[s]]
            after = chunk.snaps.get(self.step_draw[s + 1], chunk.end) if i + 1 < chunk.steps else chunk.end
            if start and i == 0:
                for k in self.names:
                    self.count("start_mismatch", before.params[k] != self.weights[k])
                    self.count("start_mismatch", before.target[k] != self.weights[k])
                    self.count("start_mismatch", before.nu[k] != 0)
            lane = torch.arange(L, device=self.device)
            greedy = ~self.explored(torch.full_like(lane, s), lane)
            self.judge_greedy(before.params, self.obs_t[s][greedy], self.obs_seed[s][greedy], actions[i][greedy])
            self.judge_step(chunk, s, before, after, float(chunk.losses[i]))
            t, t_next = s * L, (s + 1) * L
            synced = t_next // self.sync_interval != t // self.sync_interval
            for k in self.names:
                want = after.params[k] if synced else before.target[k]
                self.count("sync_mismatch", after.target[k] != want)

    def judge_step(self, chunk: Chunk, s: int, before_step: Snap, after_step: Snap, loss: float) -> None:
        """The updates of step ``s`` and, with prioritized replay, the trees'
        side of its add."""
        ups = self.update_draws[s]
        cursor = (s + 1) * self.L
        if self.per is not None:
            first = chunk.snaps[ups[0][0]] if ups else after_step
            self.judge_admit(before_step, first, cursor - self.L)
        for j, (at, u, bits) in enumerate(ups):
            before = chunk.snaps[at]
            after = chunk.snaps[ups[j + 1][0]] if j + 1 < len(ups) else after_step
            if self.per is None:
                lo, hi = max(cursor - self.capacity, 0), cursor - self.L
                ids = lo + bits % max(hi - lo, 1)
                weight = torch.ones(self.B, dtype=torch.float32, device=self.device)
                slots = None
            else:
                slots, weight = self.sample(before, after, u)
                ids = self.ids_of(slots, cursor)
            batch = self.gather(ids, chunk.actions[ids.long() % self.capacity], weight)
            ref_loss, grads, errors = self.loss_and_grads(before.params, before_step.target, batch)
            new_p, new_nu = self.rmsprop(before.params, before.nu, grads)
            if j == len(ups) - 1:
                self.gap("loss_gap", abs(loss - float(ref_loss)) / max(abs(float(ref_loss)), 1e-30))
            self.judge_moments(before, after, grads, new_p)
            if self.per is not None:
                self.judge_feedback(before, after, slots, errors)

    def judge_admit(self, before: Snap, after: Snap, cursor: int) -> None:
        """The new slots held out at priority 0, the slots a stride older
        entered at ``max_priority``."""
        lane = torch.arange(self.L, device=self.device)
        new = (cursor + lane) % self.capacity
        self.count("ring_mismatch", after.leaves[new] != 0)
        older = cursor - self.L + lane
        mature = older[older >= 0] % self.capacity
        self.count("ring_mismatch", after.leaves[mature] != before.max_priority)

    def sample(self, before: Snap, after: Snap, u: torch.Tensor):
        """The program's slots for one prioritized sample and their weights.
        A slot is the one whose interval holds its target; where float32
        rounding puts the target at the edge of two, the one the program fed
        back (its leaf changed) is taken. ``slot_gap``: how far a changed
        leaf or a taken slot lies from its target, in mean leaf widths."""
        leaves = before.leaves
        targets, cs, total = self.targets(leaves, u)
        own = torch.clamp_max(torch.searchsorted(cs, targets, right=True), leaves.shape[0] - 1)
        changed = (after.leaves != leaves).nonzero().flatten()
        slots = own.clone()
        if changed.numel():
            off = self.off(leaves, cs, total, changed, targets)  # [changed, B]
            self.gap("slot_gap", float(off.min(dim=1).values.max()))
            near = off <= 0.05
            fed = torch.isin(own, changed)
            alone = near.sum(dim=0) == 1
            take = ~fed & alone
            slots = torch.where(take, changed[near.to(torch.int64).argmax(dim=0)], own)
        own_off = self.off(leaves, cs, total, slots, targets).diagonal()
        self.gap("slot_gap", float(own_off.max()))
        probs = (leaves.double()[slots] / total).to(torch.float32)
        weight = (probs / torch.min(probs)) ** -before.beta
        return slots, weight

    def judge_feedback(self, before: Snap, after: Snap, slots: torch.Tensor, errors: torch.Tensor) -> None:
        prio = self.priorities(errors)
        got = after.leaves[slots]
        rel = torch.abs(got.double()[:, None] - prio.double()[None]) / prio.double()[None]
        same = slots[:, None] == slots[None]  # a slot drawn twice keeps one of its priorities
        rel = torch.where(same, rel, torch.full_like(rel, math.inf)).min(dim=1).values
        want_max = torch.maximum(before.max_priority, prio.max())
        self.gap("priority_gap", max(float(rel.max()), abs(float(after.max_priority) - float(want_max)) / float(want_max)))
        beta = torch.clamp_max(before.beta + self.beta_add, 1.0)
        self.gap("beta_gap", abs(float(after.beta) - float(beta)) / float(beta))

    def judge_moments(self, before: Snap, after: Snap, grads: Params, new_p: Params) -> None:
        """Each leaf's change against the reference's, and at the first
        update (zero moments before it) each leaf's gradient norm as the
        moments took it: later, ``decay`` times the old moments is most of
        the new, and float32 leaves too little of the gradient to read back;
        the change carries it there."""
        decay = self.opt["decay"]
        ref_g = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
        if all(not bool(before.nu[k].any()) for k in self.names):
            prog_g = {k: math.sqrt(float(after.nu[k].double().sum()) / (1 - decay)) for k in self.names}
            self.gap("grad_gap", worst_leaf(prog_g, ref_g, ref_g))
        ref_c = {k: float(torch.linalg.vector_norm((new_p[k] - before.params[k]).double())) for k in self.names}
        prog_c = {k: float(torch.linalg.vector_norm((after.params[k] - before.params[k]).double())) for k in self.names}
        self.gap("change_gap", worst_leaf(prog_c, ref_c, ref_g))

    # ----------------------------------------------------------- the control
    def simulate(self, draws) -> tuple:
        """The reference in the program's place from the seed through the
        first update step, answering for itself (greedy actions and slots
        of its own): ``(observation, ring)``, the ring's columns as
        :meth:`check_ring` reads them (frames left out: they are the
        reference's own)."""
        dev, L, S = self.device, self.L, self.first + 1
        params = {k: v.clone() for k, v in self.weights.items()}
        target = {k: v.clone() for k, v in self.weights.items()}
        nu = {k: torch.zeros_like(v) for k, v in self.weights.items()}
        C = tree_capacity(self.capacity)
        leaves = torch.zeros(C, dtype=torch.float32, device=dev) if self.per is not None else None
        max_p = torch.ones((), dtype=torch.float32, device=dev)
        beta = torch.full((), self.per["beta0"] if self.per else 0.0, dtype=torch.float32, device=dev)
        rows = {f: [] for f in ROW_FIELDS}
        snaps: Dict[int, Snap] = {}

        def snap():
            return Snap({k: v.clone() for k, v in params.items()}, {k: v.clone() for k, v in target.items()},
                        {k: v.clone() for k, v in nu.items()}, None if leaves is None else leaves.clone(),
                        max_p.clone(), beta.clone())

        self.obs_t = torch.zeros(S + 1, L, dtype=torch.int32, device=dev)
        self.obs_seed = torch.zeros(S + 1, L, dtype=torch.int32, device=dev)
        self.ep_len = torch.zeros(S, L, dtype=torch.int32, device=dev)
        t_ep, seed, ep_len = self.env.reset(draws, L)
        losses = []
        for s in range(S):
            self.obs_t[s], self.obs_seed[s], self.ep_len[s] = t_ep, seed, ep_len
            if s == self.first:
                draws.observer = lambda i: snaps.__setitem__(i, snap())
            u = draws.uniform(L)
            random_a = draws.randint(self.n_actions, L)
            with torch.no_grad():
                best = torch.argmax(self.q(params, self.env.frames(t_ep, seed)), dim=-1).to(torch.int32)
            a = torch.where(u < epsilon_at(s * L, *self.eps), random_a, best)
            t1 = t_ep + 1
            reward = (((seed + t1) % 37) == (a % 37 % 7)).to(torch.float32)
            terminated = t1 >= ep_len
            for f, x in zip(ROW_FIELDS, (a, reward, terminated, terminated)):
                rows[f].append(x)
            r_t, r_seed, r_len = self.env.reset(draws, L)
            t_ep = torch.where(terminated, r_t, t1)
            seed = torch.where(terminated, r_seed, seed)
            ep_len = torch.where(terminated, r_len, ep_len)
            self.obs_t[s + 1], self.obs_seed[s + 1] = t_ep, seed
            cursor = (s + 1) * L
            if leaves is not None:
                lane = torch.arange(L, device=dev)
                leaves[(cursor - L + lane) % self.capacity] = 0.0
                older = cursor - 2 * L + lane
                leaves[older[older >= 0] % self.capacity] = max_p
            if s == self.first:
                column = torch.zeros(self.capacity, dtype=torch.int32, device=dev)
                column[:cursor] = torch.cat(rows["action"])
                loss = None
                if self.per is None:
                    lo, hi = max(cursor - self.capacity, 0), cursor - L
                    bound = torch.tensor(max(hi - lo, 1), dtype=torch.int64, device=dev)
                    id_sets = (lo + draws.randint_below(bound, self.U * self.B)).reshape(self.U, self.B)
                for j in range(self.U):
                    if self.per is None:
                        ids, weight = id_sets[j], torch.ones(self.B, dtype=torch.float32, device=dev)
                    else:
                        targets, cs, total = self.targets(leaves, draws.uniform(self.B))
                        slots = torch.clamp_max(torch.searchsorted(cs, targets, right=True), C - 1)
                        probs = (leaves.double()[slots] / total).to(torch.float32)
                        weight = (probs / torch.min(probs)) ** -beta
                        beta = torch.clamp_max(beta + self.beta_add, 1.0)
                        ids = self.ids_of(slots, cursor)
                    batch = self.gather(ids, column[ids.long() % self.capacity], weight)
                    loss, grads, errors = self.loss_and_grads(params, target, batch)
                    params, nu = self.rmsprop(params, nu, grads)
                    if leaves is not None:
                        prio = self.priorities(errors)
                        leaves[slots] = prio
                        max_p = torch.maximum(max_p, prio.max())
                losses.append(loss)
            if (s + 1) * L // self.sync_interval != s * L // self.sync_interval:
                target = {k: v.clone() for k, v in params.items()}
        draws.observer = None
        end = snap()
        chunk = Chunk(self.first, 1, snaps, end, torch.stack(losses), {f: rows[f][self.first] for f in ROW_FIELDS},
                      column)
        ring = {f: torch.cat(rows[f]) for f in ROW_FIELDS}
        return Observation(S, [chunk]), ring


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], ref_grad: Dict[str, float]) -> List[float]:
    """``|prog - ref|`` of each leaf against the larger of its own reference
    norm and the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out."""
    med_g = float(np.median(list(ref_grad.values())))
    kept = [k for k in ref if ref_grad[k] >= 1e-3 * med_g]
    med = float(np.median([ref[k] for k in kept]))
    return [abs(prog[k] - ref[k]) / max(abs(ref[k]), med, 1e-30) for k in kept]


def worst_leaf(prog, ref, ref_grad) -> float:
    return max(leaf_gaps(prog, ref, ref_grad))
