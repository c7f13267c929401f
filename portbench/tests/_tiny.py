"""Cells cut to a size the CPU runs in seconds: 8 lanes, a 1,024-slot ring
and a replay start of 256 transitions; the network, the frames and every
other setting as the cell runs them."""

import copy

from portbench import harness

H100 = harness.load_json(harness.HERE / "peaks.json")["NVIDIA H100 80GB HBM3"]


def _cut(cell: dict) -> dict:
    # The replay start stays a crossing of the target sync interval.
    cell["config"]["build"].update(capacity=1024, replay_start_size=256, target_update_interval=256)
    cell["traffic"].update(num_envs=8, warm_steps=1, profile_steps=2, chunk_steps=1)
    return cell


def tiny(name: str) -> dict:
    return _cut(copy.deepcopy(harness.load_cell(name)))


def tiny_uniform() -> dict:
    """The uniform ring's path, which no cell takes yet: ``nature-dqn``
    (Nature's own target rule) at one batch-64 update per scan step of 8
    lanes, Nature's replay ratio, judged against the PER cell's limits."""
    cell = tiny(CELLS[0])
    cell["name"] = "nature-dqn.tiny"
    cell["config"] = harness.load_json(harness.HERE / "configs" / "nature-dqn.json")
    cell["traffic"].update(minibatch_size=64, update_interval=8)
    cell["limits"] = {k: v for k, v in cell["limits"].items() if k not in ("slot_gap", "priority_gap", "beta_gap")}
    return _cut(cell)


CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
