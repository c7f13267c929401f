"""Runner snapshots under a mesh (``agents/snapshot.py``), on the CPU over
Gloo: the ``snapshot`` scenario of ``torch_mesh_worker.py`` (DRQN on
DelayedCue over the sharded episodic buffer with stored carries, from its
own seeded weights and a seeded generator) runs 26 scan steps
uninterrupted, then 13, saves a runner snapshot (each rank its own rows,
the replicated state, its rank and the world size, the shared draw
source's state), loads it into a fresh runner built from other seeds and
runs 13 more. The resumed run equals the uninterrupted one to the bit, on
one rank in this process and on two spawned ranks; loading under another
world size, or with a mesh where it was saved without one and the other
way round, raises by name.
"""

import os
import subprocess
import sys

import pytest
import torch
from torch_mesh_harness import RANK_TIMEOUT_S, WORKER, assert_equal_runs, free_port, one_rank

import torch_mesh_worker as worker
from pfrl_tpu_torch.agent import CheckpointMismatchError
from pfrl_tpu_torch.agents.snapshot import load_runner_snapshot, save_runner_snapshot
from pfrl_tpu_torch.parallel.mesh import Mesh
from pfrl_tpu_torch.utils.draws import Draws

torch.set_num_threads(1)
_ = one_rank  # the fixture


def assert_resumed_equals_whole(out):
    whole, resumed = out["whole"], out["resumed"]
    assert resumed["t"] == whole["t"] == 2 * worker.SNAPSHOT_STEPS * worker.LANES and resumed["n_updates"] > 0
    assert_equal_runs(whole, resumed, ("learned", "replicated", "local"))
    for key, value in resumed["metrics"].items():  # the resumed chunk is the last 13 scan steps
        assert torch.equal(value, whole["metrics"][key][worker.SNAPSHOT_STEPS:]), key


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("snapshot")
    torch.save({"snapshot_dir": str(tmp / "snapshot")}, tmp / "setup.pt")
    port, procs = free_port(), []
    for rank in range(2):
        cmd = [sys.executable, WORKER, "snapshot", str(tmp / "setup.pt"), str(tmp / f"{rank}.pt"), str(rank), "2",
               str(port)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = []
    for rank, proc in enumerate(procs):
        try:
            log, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        assert proc.returncode == 0, log[-2000:]
        out.append(torch.load(tmp / f"{rank}.pt", weights_only=False))
    return out, tmp / "snapshot"


def test_a_snapshot_resumed_on_one_rank_equals_the_uninterrupted_run_to_the_bit(one_rank, tmp_path):
    assert_resumed_equals_whole(worker.run_core("snapshot", {"snapshot_dir": str(tmp_path)}, one_rank))
    assert sorted(os.listdir(tmp_path)) == ["runner_state.rank0.pt"]


def test_a_snapshot_resumed_on_two_ranks_equals_the_uninterrupted_run_to_the_bit(two_ranks):
    (a, b), snapshot = two_ranks
    for out in (a, b):
        assert_resumed_equals_whole(out)
    assert_equal_runs(a["resumed"], b["resumed"], ("learned", "replicated"))
    assert sorted(os.listdir(snapshot)) == ["runner_state.rank0.pt", "runner_state.rank1.pt"]
    for rank in range(2):  # each rank's file names its rank and the world size
        saved = torch.load(snapshot / f"runner_state.rank{rank}.pt", weights_only=True)
        assert (saved["rank"], saved["world"]) == (rank, 2)


def test_loading_under_another_world_size_or_without_the_mesh_raises_by_name(two_ranks, one_rank, tmp_path):
    _, snapshot = two_ranks
    runner = worker.build_core("snapshot", None, one_rank)
    template = runner.init(0, draws=Draws(torch.Generator().manual_seed(0)))
    with pytest.raises(CheckpointMismatchError, match="world size of 2, loaded by one of 1"):
        load_runner_snapshot(template, str(snapshot), one_rank)
    with pytest.raises(CheckpointMismatchError, match="saved under a mesh"):
        load_runner_snapshot(template, str(snapshot))
    save_runner_snapshot(template, str(tmp_path))  # without a mesh
    with pytest.raises(CheckpointMismatchError, match="saved without a mesh"):
        load_runner_snapshot(template, str(tmp_path), one_rank)
    # A rank's file that another rank wrote.
    other = tmp_path / "other"
    save_runner_snapshot(template, str(other), one_rank)
    saved = torch.load(other / "runner_state.rank0.pt", weights_only=True)
    saved["rank"] = 1
    torch.save(saved, other / "runner_state.rank0.pt")
    with pytest.raises(CheckpointMismatchError, match="saved by rank 1"):
        load_runner_snapshot(template, str(other), one_rank)
    # Rank 1 of a world size of 2 finds no file of its own in a one-rank snapshot.
    with pytest.raises(CheckpointMismatchError, match="no runner_state.rank1.pt for rank 1 of a world size of 2"):
        load_runner_snapshot(template, str(other), Mesh(("dp",), (2,), 1))
