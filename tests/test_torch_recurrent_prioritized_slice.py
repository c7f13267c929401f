"""DRQN on DelayedCue over the prioritized episodic buffer, through the
runners' episodic branch with its window feedback: each update samples
windows from the sum tree over rows (``sample_episodes``), trains on them
(``update_episodic``) and writes one priority per sampled row from the
core's ``aux["errors"]`` (``update_episode_priorities``), because the core
reports window errors. The recipe's runner at the sizes of
``test_torch_recurrent_slice.py`` (4 lanes, hidden 16, rows of 12 steps,
windows of 4, 14 updates), against the JAX package's
``OffPolicyRunner.run_chunk`` on the same draws, through the same harness.

Tolerances: the sampled rows of every update, counters, flags and actions
exact; the sum tree and the max priority 1e-5 relative (priorities are
|TD| + 1e-3 from float32 updates that agree to about 1e-6); the rest as in
``test_torch_recurrent_slice.py``.
"""

import numpy as np
import pytest
import torch
from test_torch_recurrent_slice import assert_eval_matches, assert_offpolicy_matches, small_offpolicy

from pfrl_tpu_torch.replay import sum_tree
from pfrl_tpu_torch.replay.prioritized_episodic import PrioritizedEpisodicReplayBuffer


@pytest.fixture(scope="module")
def trained():
    return small_offpolicy("drqn-delayedcue", prioritized=True)


def test_prioritized_drqn_delayedcue_matches_the_jax_runner(trained):
    assert isinstance(trained["runner"].buffer, PrioritizedEpisodicReplayBuffer)
    assert_offpolicy_matches(trained, "drqn-delayedcue")
    replay, jreplay = trained["state"].replay_state, trained["jax"][1].replay_state
    np.testing.assert_allclose(replay.tree.numpy(), np.asarray(jreplay.tree), rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(float(replay.max_priority), float(jreplay.max_priority), rtol=1e-5)


def test_window_errors_reach_the_sum_tree(trained):
    """Leaves that are neither 0 (a row being written, or sealed by filling)
    nor 1 (the max priority a row got when its episode ended, before any
    feedback) came from the updates' window errors."""
    replay = trained["state"].replay_state
    rows = trained["runner"].buffer.max_episodes
    leaves = sum_tree.get(replay.tree, torch.arange(rows, dtype=torch.int32))
    sampled = np.unique(np.concatenate(trained["runner"].buffer.sample_episodes.rows))
    fed_back = (leaves != 0.0) & (leaves != 1.0)
    assert fed_back.any()
    assert set(np.flatnonzero(fed_back.numpy())) <= set(sampled.tolist())


def test_prioritized_eval_loop_matches_jax_eval_loop(trained):
    assert_eval_matches(trained)
