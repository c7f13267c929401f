"""What keeps a mesh's result the single-process result, shown on the CPU:
the draw kinds, the masked losses' global denominator, and ACER's SDN
draw split on its rows' axis.

- **Draw kinds** (``utils/draws.py``, ``parallel/lane_sharding.py``): a
  per-row draw keeps a rank's rows on the stated axis of the whole draw,
  a per-parameter draw (a noisy layer's ``eps_in`` and ``eps_out``) is
  the whole draw on every rank, a flat draw that names no kind raises
  inside a data-parallel update, and ``LaneDraws`` keeps a rank's lanes of
  a flat act-time draw. A rank's source needs only its rank and the world
  size, so these run without a process group.
- **ACER's SDN normal** ``[n_sdn, B, T, d]``: a flat block split (a rank's
  block ``[rank * N / 2, (rank + 1) * N / 2)`` of the flat draw) hands a
  rank the noise of the other rank's rows; the row-axis split hands it
  its own.
- **The global denominator**: four DRQN windows whose two shares hold 8
  and 2 valid steps. The mean of the two shares' masked means misses the
  whole batch's masked mean by far more than ROADMAP C77's bound; two
  spawned Gloo ranks, each dividing its share's sum by the whole batch's
  count (the data-parallel update hands a share the whole batch's mask)
  and summing the gradients, give the whole batch's loss and update
  within that bound.
"""

import copy
import subprocess
import sys

import pytest
import torch
from torch_mesh_harness import RANK_TIMEOUT_S, WORKER, free_port

import torch_mesh_worker as worker
from pfrl_tpu_torch.models.noisy_linear import FactorizedNoisyLinear
from pfrl_tpu_torch.parallel.lane_sharding import LaneDraws, RowDraws
from pfrl_tpu_torch.parallel.mesh import Mesh, shard_batch
from pfrl_tpu_torch.utils.draws import normal, per_parameter, per_row, uniform

torch.set_num_threads(1)

N_SDN, B, T, D = 5, 4, 6, 2


def _rank(rank):
    return Mesh(("dp",), (2,), rank)


def test_a_per_row_draw_keeps_the_ranks_rows_on_their_axis():
    whole = worker.NumpyDraws(0).normal(3 * 4 * 2).reshape(3, 4, 2)
    for rank in range(2):
        share = per_row(RowDraws(worker.NumpyDraws(0), _rank(rank)), "normal", (3, 2, 2), row_axis=1)
        assert torch.equal(share, whole[:, rank * 2:(rank + 1) * 2])
        lanes = uniform(LaneDraws(worker.NumpyDraws(0), _rank(rank)), (2, 3))
        assert torch.equal(lanes, worker.NumpyDraws(0).uniform(12).reshape(4, 3)[rank * 2:(rank + 1) * 2])
    # A plain source draws the shape flat and reshapes it.
    assert torch.equal(normal(worker.NumpyDraws(0), (3, 4, 2), row_axis=1), whole)


def test_a_per_parameter_draw_is_whole_on_every_rank_and_a_flat_update_draw_raises():
    want = worker.NumpyDraws(0).normal(7)
    for rank in range(2):
        for source in (RowDraws, LaneDraws):
            assert torch.equal(per_parameter(source(worker.NumpyDraws(0), _rank(rank)), "normal", 7), want)
        with pytest.raises(TypeError, match="names no kind"):
            RowDraws(worker.NumpyDraws(0), _rank(rank)).normal(7)
        # A flat act-time draw is per lane.
        assert torch.equal(LaneDraws(worker.NumpyDraws(0), _rank(rank)).normal(2), want[:4][rank * 2:(rank + 1) * 2])
    # A noisy layer takes the same noise on both ranks, acting or updating.
    layer = FactorizedNoisyLinear(3, 2)
    x = torch.ones(1, 3)
    outs = [layer(x, source(worker.NumpyDraws(0), _rank(r))) for r in range(2) for source in (RowDraws, LaneDraws)]
    assert all(torch.equal(o, layer(x, worker.NumpyDraws(0))) for o in outs)


def test_a_flat_split_of_acers_sdn_draw_gives_another_rows_noise_the_row_axis_split_does_not():
    whole = worker.NumpyDraws(0).normal(N_SDN * B * T * D).reshape(N_SDN, B, T, D)
    n = whole.numel() // 2
    for rank in range(2):
        mine = whole[:, rank * 2:(rank + 1) * 2]  # this rank's rows of the batch
        flat = whole.reshape(-1)[rank * n:(rank + 1) * n].reshape(N_SDN, 2, T, D)
        assert not torch.equal(flat, mine)
        # The flat block holds the other rank's rows' numbers.
        other = whole[:, (1 - rank) * 2:(2 - rank) * 2]
        assert any(torch.equal(flat[i, j], other[k, m]) for i in range(N_SDN) for j in range(2)
                   for k in range(N_SDN) for m in range(2))
        share = normal(RowDraws(worker.NumpyDraws(0), _rank(rank)), (N_SDN, 2, T, D), row_axis=1)
        assert torch.equal(share, mine)


def _masked_mean_loss(batch):
    """The DRQN loss of ``batch`` from the seeded weights, no mesh."""
    core = worker.build_core("drqn", None).core
    state = core.init(torch.Generator().manual_seed(0), torch.zeros(worker.LANES, 13))
    _, aux = core.update_episodic(state, batch)
    return aux["loss"], worker.tensors(state, "train")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("denominator")
    torch.save({}, tmp / "setup.pt")
    port, procs = free_port(), []
    for rank in range(2):
        cmd = [sys.executable, WORKER, "denominator", str(tmp / "setup.pt"), str(tmp / f"{rank}.pt"), str(rank), "2",
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
    return out


def test_the_averaged_share_means_miss_the_whole_batch_loss_and_the_global_denominator_meets_it(two_ranks):
    batch = worker.denominator_batch()
    assert batch.mask[:2].sum() == 8 and batch.mask[2:].sum() == 2  # the shares' valid steps differ
    whole_loss, whole_state = _masked_mean_loss(copy.deepcopy(batch))
    shares = [_masked_mean_loss(shard_batch(_rank(r), copy.deepcopy(batch)))[0] for r in range(2)]
    averaged = (shares[0] + shares[1]) / 2
    assert float((averaged - whole_loss).abs()) > 100 * 2e-6  # the mean of the shares' means is another loss
    a, b = two_ranks
    for rank in (a, b):
        torch.testing.assert_close(rank["loss"], whole_loss, rtol=0, atol=2e-6)
        torch.testing.assert_close(rank["errors"], worker.run_denominator()["errors"], rtol=0, atol=2e-6)
        for key, value in whole_state.items():
            if value.is_floating_point():
                torch.testing.assert_close(rank["learned"][key], value, rtol=0, atol=2e-6, msg=key)
    for key, value in a["learned"].items():
        assert torch.equal(value, b["learned"][key]), key
