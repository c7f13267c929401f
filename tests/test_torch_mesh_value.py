"""Every core under a mesh, on the CPU over Gloo (``torch_mesh_harness.py``):
the cores that draw in their update. IQN on CartPole (each update's taus per row); Rainbow-CartPole (a noisy
network over 3-step PER: every rank draws the same per-parameter noise,
acting and updating; the prefix-sample kernel's plain version on every
rank over the replicated tree); SAC on MujocoSim (the reparameterisation
noise per row).

- One Gloo rank in this process equals the run without a mesh to the bit:
  every learned tensor, metric, carry and buffer table.
- Two spawned Gloo ranks (each under its own timeout) are equal to each
  other to the bit in everything replicated; each rank's lanes and buffer
  rows are the single-process run's; the learned tensors lie within
  ROADMAP C77's bound of the single-process run and within 2e-5 (or the
  nudge bound, where larger) of the JAX runner on a two-device mesh.
"""

import pytest
from torch_mesh_harness import (assert_matches_the_jax_runner, assert_one_rank_equals_no_mesh, assert_ranks_equal,
                                assert_within_the_single_run, one_rank, spawn_two_ranks)

SCENARIOS = ("iqn", "rainbow", "sac")
_ = one_rank  # the fixture


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn_two_ranks(SCENARIOS, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_a_mesh_of_one_gloo_rank_equals_no_mesh_to_the_bit(one_rank, scenario):
    assert_one_rank_equals_no_mesh(scenario, one_rank)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_gloo_ranks_are_equal_to_the_bit(two_ranks, scenario):
    assert_ranks_equal(two_ranks[scenario], scenario)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_gloo_ranks_lie_within_the_bound_of_the_single_process_run(two_ranks, scenario):
    assert_within_the_single_run(two_ranks[scenario], scenario)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_gloo_ranks_match_the_jax_runner_on_a_two_device_mesh(two_ranks, scenario):
    assert_matches_the_jax_runner(two_ranks[scenario], scenario)
