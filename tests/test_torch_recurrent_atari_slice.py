"""DRQN on AtariSim, narrow: ``examples/atari/train_drqn_ale.py --sim``'s
recipe (``make_drqn_atarisim_runner``) at 4 lanes of single 84x84x1 uint8
frames, the Nature CNN into an LSTM of 16, rows of 8 steps (2 per lane,
sealed by filling), windows of 4 with a burn-in of 2, through the port's
``OffPolicyRunner`` against the JAX package's ``OffPolicyRunner.run_chunk``
on the example's own ``RecurrentQ`` and the same draws, and ``EvalLoop``
against ``JaxEvalLoop``. The machinery and tolerances are those of
``test_torch_recurrent_slice.py`` (a file of its own so that xdist can run
it beside the others).
"""

import pytest
from test_torch_recurrent_slice import assert_eval_matches, assert_offpolicy_matches, small_offpolicy


@pytest.fixture(scope="module")
def trained():
    return small_offpolicy("drqn-atarisim")


def test_narrow_drqn_atarisim_matches_the_jax_runner(trained):
    assert_offpolicy_matches(trained, "drqn-atarisim")
    # The stored frames are the uint8 frames; the carries have the LSTM's width.
    storage = trained["state"].replay_state.storage
    assert storage["obs"].dtype == storage["next_obs"].dtype == trained["state"].obs.dtype
    assert storage["obs"].shape[2:] == (84, 84, 1)
    assert storage["extras"]["carry"][0][0].shape == (9, 8, 16)


def test_narrow_drqn_atarisim_eval_loop_matches_jax(trained):
    assert_eval_matches(trained)
