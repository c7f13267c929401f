"""The reference against the port at a tiny size on the CPU: a sound run is
correct, the control (the reference in TF32 in the program's place) and
each planted fault are not, through the whole of a run."""

import time

import pytest
import torch

from portbench import faults, harness, main
from portbench.reference.draws import ReplayedDraws
from _tiny import CELLS, H100, tiny, tiny_uniform

TINY = [tiny(name) for name in CELLS] + [tiny_uniform()]
IDS = [c["name"] for c in TINY]


@pytest.mark.parametrize("cell", TINY, ids=IDS)
def test_the_port_agrees_with_the_reference(cell):
    setup = harness.set_up(cell, 2**31 + 7, "cpu")
    harness.window(setup, 0.2)
    assert [c.first_step for c in setup.chunks][0] == 31 and len(setup.chunks) == 2
    numbers = harness.judge(cell, setup, "cpu")
    for exact in ("draw_mismatch", "action_mismatch", "ring_mismatch", "start_mismatch", "sync_mismatch"):
        assert numbers[exact] == 0, (exact, numbers)
    for gap in ("loss_gap", "grad_gap", "change_gap", "greedy_q_gap"):
        assert numbers[gap] < 1e-6, (gap, numbers)
    assert harness.is_correct(harness.checks(numbers, cell["limits"])), numbers


@pytest.mark.parametrize("cell", TINY, ids=IDS)
def test_a_run_is_correct(cell):
    result, _ = main.run_cell(cell, 5, 0.2, False, "cpu", H100, time.time())
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"env_steps_per_s", "step_mfu", "setup_s"}


@pytest.mark.parametrize("cell", TINY, ids=IDS)
def test_the_control_is_not_correct(cell):
    numbers = harness.control_numbers(cell, 11, "cpu")
    assert numbers["draw_mismatch"] == 0 and numbers["action_mismatch"] == 0, numbers
    assert not harness.is_correct(harness.checks(numbers, cell["limits"])), numbers


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", TINY, ids=IDS)
def test_a_fault_is_not_correct(cell, fault):
    result, _ = main.run_cell(cell, 13, 0.2, False, "cpu", H100, time.time(), faults=[faults.FAULTS[fault]])
    assert not result["correct"], result["checks"]


def test_a_draw_out_of_turn_is_not_correct():
    cell = TINY[0]
    setup = harness.set_up(cell, 3, "cpu")
    del setup.draws.log[1]
    numbers = harness.judge(cell, setup, "cpu")
    assert numbers["draw_mismatch"] == float("inf")
    assert not harness.is_correct(harness.checks(numbers, cell["limits"]))


def test_the_window_judges_its_last_chunk_from_the_state():
    """The observed chunk is the window's last, and the reference reads it
    only from the program's state: a parameter changed in place after the
    chunk's last draw is caught there."""
    cell = TINY[0]
    setup = harness.set_up(cell, 17, "cpu")
    w = harness.window(setup, 0.3)
    last = setup.chunks[-1]
    assert last.first_step + last.steps == setup.state.t // cell["traffic"]["num_envs"]
    assert w["scan_steps"] >= 2
    with torch.no_grad():
        next(setup.state.train_state.model.parameters()).add_(1e-3)
    last.end.params = {n: p.detach().clone() for n, p in setup.state.train_state.model.named_parameters()}
    numbers = harness.judge(cell, setup, "cpu")
    assert numbers["change_gap"] > cell["limits"]["change_gap"], numbers


def test_every_draw_of_a_run_is_replayed():
    cell = TINY[0]
    setup = harness.set_up(cell, 19, "cpu")
    draws = ReplayedDraws(setup.draws.log)
    f = harness.Follower(cell["config"], cell["traffic"], setup.weights, "cpu")
    f.replay(draws, setup.state.t // cell["traffic"]["num_envs"])
    assert draws.at == len(setup.draws.log)


def _sample(changed_slots):
    """``Follower.sample`` over 64 leaves of priority 1 and 32 targets: the
    first at the edge of slots 0 and 1, the others inside slot ``2i``; the
    program fed back ``changed_slots``."""
    cell = TINY[0]
    f = harness.Follower(cell["config"], cell["traffic"], harness.inputs(cell["config"], 1, "cpu")[0], "cpu")
    leaves = torch.ones(64)
    u = torch.full((32,), 0.25)
    u[0] = 0.5
    after = leaves.clone()
    after[torch.tensor(changed_slots)] = 0.5
    snap = lambda x: harness.Snap({}, {}, {}, x, torch.tensor(1.0), torch.tensor(0.4))  # noqa: E731
    slots, _ = f.sample(snap(leaves), snap(after), u)
    return slots.tolist(), f.values["slot_gap"]


def test_a_slot_at_the_edge_of_two_is_the_one_fed_back():
    # The reference's own search gives slot 1 for the first target; the
    # program took slot 0, as float32 rounding may.
    slots, gap = _sample([0] + [2 * i for i in range(1, 32)])
    assert slots == [2 * i for i in range(32)] and gap == 0
    slots, gap = _sample([1] + [2 * i for i in range(1, 32)])
    assert slots == [1] + [2 * i for i in range(1, 32)] and gap == 0


def test_a_slot_fed_back_away_from_every_target_is_caught():
    _, gap = _sample([0] + [2 * i for i in range(1, 32) if i != 2] + [5])
    assert gap == 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_full_size_run_on_the_card(name, cuda):
    cell = harness.load_cell(name)
    peak = harness.load_json(harness.HERE / "peaks.json")[torch.cuda.get_device_name(cuda)]
    result, _ = main.run_cell(cell, 2**31 + 99, 1.0, False, cuda, peak, time.time())
    assert result["correct"], result["checks"]
