"""Actors of the ``DQN`` shell's actor-learner mode (counterpart of
``pfrl_tpu/agents/state_q_function_actor.py``; reference parity:
pfrl/agents/state_q_function_actor.py).

An actor owns nothing of the model: ``act`` is a blocking call into the
:class:`~pfrl_tpu_torch.parallel.inference_server.BatchedInferenceServer`
(one batched forward on the card for all actors), and ``observe`` puts the
transition on the queue that the learner's poller drains. Actors are
threads of the learner's process, so the reference's pipe becomes a
``queue.Queue`` and ``save``, ``load`` and ``get_statistics`` call the
learner directly. Observations and actions stay numpy arrays on the host;
the poller uploads whole rows of them to the ring.
"""

import queue
from typing import Any, Optional

import numpy as np

from pfrl_tpu_torch.agent import Agent


class StateQFunctionActor(Agent):
    """Agent-protocol actor: acts through the inference server, ships its
    transitions as ``(actor_id, dict(obs, action, reward, next_obs,
    terminated, done))``, with ``done | reset`` as ``done`` and ``done`` as
    ``terminated``.

    Args:
        inference: the server (anything with ``submit(obs, training)``).
        transition_queue: the queue the learner's poller drains.
        actor_id: this actor's lane in the learner's ring.
        learner_agent: the learner, to which ``save``, ``load`` and
            ``get_statistics`` delegate.
    """

    def __init__(self, inference, transition_queue: "queue.Queue", actor_id: int, learner_agent=None, logger=None):
        self.inference = inference
        self.transition_queue = transition_queue
        self.actor_id = actor_id
        self.learner_agent = learner_agent
        self.logger = logger
        self._last_obs: Optional[np.ndarray] = None
        self._last_action: Optional[np.ndarray] = None
        self.t = 0

    # --------------------------------------------------------------- acting
    def act(self, obs) -> Any:
        obs = np.asarray(obs)
        action = self.inference.submit(obs, self.training)
        self._last_obs = obs
        self._last_action = np.asarray(action)
        return action

    def observe(self, obs, reward, done, reset) -> None:
        if not self.training:
            return
        self.t += 1
        self.transition_queue.put((self.actor_id, dict(
            obs=self._last_obs,
            action=self._last_action,
            reward=np.float32(reward),
            next_obs=np.asarray(obs),
            terminated=bool(done),
            done=bool(done or reset),
        )))

    # ------------------------------------------------------------- delegate
    def save(self, dirname: str) -> None:
        if self.learner_agent is not None:
            self.learner_agent.save(dirname)

    def load(self, dirname: str) -> None:
        if self.learner_agent is not None:
            self.learner_agent.load(dirname)

    def get_statistics(self):
        if self.learner_agent is not None:
            return self.learner_agent.get_statistics()
        return []


class VectorStateQFunctionActor(StateQFunctionActor):
    """An actor that drives ``num_lanes`` env lanes from one thread: one
    server request and one queue message per vector step carry all K
    transitions as stacked arrays. Drive it like a ``BatchAgent``:
    ``batch_act(obs_list)``, then ``batch_observe(obs_list, rewards, dones,
    resets)``."""

    def __init__(self, inference, transition_queue, actor_id, num_lanes, learner_agent=None, logger=None):
        super().__init__(inference, transition_queue, actor_id, learner_agent=learner_agent, logger=logger)
        self.num_lanes = num_lanes

    def act(self, obs):
        raise TypeError("VectorStateQFunctionActor drives num_lanes env lanes: use batch_act(obs_list), "
                        "not the single-row act().")

    def observe(self, obs, reward, done, reset):
        # Single rows from a K-lane actor would mis-shape the poller's rows.
        raise TypeError("VectorStateQFunctionActor ships [num_lanes, ...] rows: use batch_observe(...), "
                        "not the single-row observe().")

    @staticmethod
    def _collate(obs_list):
        if isinstance(obs_list, np.ndarray):
            return obs_list
        return np.stack([np.asarray(o) for o in obs_list])

    def batch_act(self, obs_list) -> np.ndarray:
        obs = self._collate(obs_list)
        actions = self.inference.submit_batch(obs, self.training)
        self._last_obs = obs
        self._last_action = np.asarray(actions)
        return self._last_action

    def batch_observe(self, obs_list, rewards, dones, resets) -> None:
        if not self.training:
            return
        self.t += self.num_lanes
        dones = np.asarray(dones, bool)
        self.transition_queue.put((self.actor_id, dict(
            obs=self._last_obs,
            action=self._last_action,
            reward=np.asarray(rewards, np.float32),
            next_obs=self._collate(obs_list),
            terminated=dones,
            done=dones | np.asarray(resets, bool),
        )))
