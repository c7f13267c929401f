"""Faults planted in the program, each of which a run must read as not
correct (the check of the comparison, never part of a benchmark run):

- ``unchanged``: the optimizer step leaves the parameters and its state
  as they were (a step that returns its state unchanged);
- ``half_batch``: each update trains on the first half of its batch only,
  its errors repeated for the feedback (half of the batch left out);
- ``action_altered``: every lane's action at the first scan step that
  updates is moved to the next action (answers altered where they are
  produced: the lanes that explored and the few that acted greedily);
- ``sync_skipped``: the target network is never synced.

One chip, so no exchange between chips can be left out.
"""

import dataclasses


def unchanged(runner) -> None:
    runner.core.optimizer.update = lambda params, grads, state: None


def half_batch(runner) -> None:
    update = runner._update

    def halved(train, batch, draws):
        half = batch.indices.shape[0] // 2
        fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
        kept = {k: (v[:half] if hasattr(v, "shape") and v.dim() else v) for k, v in fields.items()}
        state, aux = update(train, type(batch)(**kept), draws)
        aux = dict(aux, errors=aux["errors"].repeat(2))
        return state, aux

    runner._update = halved


def action_altered(runner) -> None:
    act = runner.core.select_action
    first = -(-runner.config.replay_start_size // runner.config.num_envs)
    calls = [0]

    def altered(state, draws, obs, t, training):
        a = act(state, draws, obs, t, training)
        calls[0] += 1
        if calls[0] == first:
            a = (a + 1) % runner.env.action_space.n
        return a

    runner.core.select_action = altered


def sync_skipped(runner) -> None:
    runner.core.sync_target = lambda state: state


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "action_altered": action_altered,
          "sync_skipped": sync_skipped}
