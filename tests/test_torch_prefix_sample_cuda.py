"""The hand-written CUDA prefix-sample kernel against its plain version, on
a card. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_prefix_sample_cuda.py -q

Without a card every test skips: the kernel has no CPU mode. Integer-valued
priorities sum exactly in any order, so kernel and plain version agree
exactly; real-valued ones may differ only where a target lies within
float32 rounding of a cumulative boundary.
"""

import numpy as np
import pytest
import torch

from pfrl_tpu_torch.ops import prefix_sample as ps

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, c, b, high=5):
    rs = np.random.RandomState(seed)
    prio = rs.randint(0, high, c).astype(np.float32)
    prio[-max(c // 7, 1):] = 0.0  # an all-zero tail, counted past
    total = float(prio.sum())
    cs = np.cumsum(prio)
    targets = np.concatenate([
        rs.uniform(0.0, total, max(b - 4, 0)),
        [cs[c // 3], 0.0, total, total + 3.0],  # on a boundary, ends, past
    ])[:b].astype(np.float32)
    return prio, targets


@pytest.mark.gpu
@pytest.mark.parametrize(
    "c,b",
    [(131072, 32), (3 * 1024 + 517, 5), (1, 3), (200_001, 200), (1024, 1),
     (1_048_576, 32), (131072, 1000), (5, 8)],
)
def test_kernel_matches_plain_version(cuda, c, b):
    # C = 2**20 streams many tiles per segment; B = 1,000 takes more than one
    # pass of the kernel's target loop; C = 5 leaves segments empty.
    prio, targets = _case(c, c, b)
    p, t = torch.from_numpy(prio).to(cuda), torch.from_numpy(targets).to(cuda)
    before = ps.prefix_sample.launches
    got = ps.prefix_sample(p, t)
    torch.cuda.synchronize()
    assert ps.prefix_sample.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda" and got.shape == (b,)
    np.testing.assert_array_equal(got.cpu().numpy(), ps.prefix_sample_reference(p, t).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("c,offset", [(131072 + 3, 1), (8192 * 3 + 7, 3)])
def test_kernel_on_unaligned_view(cuda, c, offset):
    # A view that starts 4 or 12 bytes past a 16-byte boundary: the tiles'
    # heads take plain loads, the bodies the bulk copy.
    prio, targets = _case(c, c, 32)
    big = torch.from_numpy(prio).to(cuda)
    p, t = big[offset:], torch.from_numpy(targets).to(cuda)
    assert p.is_contiguous() and p.data_ptr() % 16 == 4 * offset
    before = ps.prefix_sample.launches
    got = ps.prefix_sample(p, t)
    torch.cuda.synchronize()
    assert ps.prefix_sample.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), ps.prefix_sample_reference(p, t).cpu().numpy())


@pytest.mark.gpu
def test_occupancy_query_between_launches(cuda):
    prio, targets = _case(11, 1_048_576 + 13, 64)
    p, t = torch.from_numpy(prio).to(cuda), torch.from_numpy(targets).to(cuda)
    want = ps.prefix_sample_reference(p, t).cpu().numpy()
    np.testing.assert_array_equal(ps.prefix_sample(p, t).cpu().numpy(), want)
    # A query for a smaller call must not lower the shared memory allowed.
    info = ps.cluster_info(5)
    assert info["cluster"] == ps.CLUSTER
    assert info["max_active_clusters"] >= 1 and info["smem_bytes_per_block"] > 0
    np.testing.assert_array_equal(ps.prefix_sample(p, t).cpu().numpy(), want)


@pytest.mark.gpu
def test_kernel_on_two_devices(cuda):
    # The kernel's shared-memory and cluster-size attributes are set per
    # device: a launch on a second card after one on the first must work.
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    prio, targets = _case(12, 1_048_576, 32)
    for index in (0, 1, 0):
        dev = torch.device("cuda", index)
        p, t = torch.from_numpy(prio).to(dev), torch.from_numpy(targets).to(dev)
        got = ps.prefix_sample(p, t)
        assert got.device == dev
        np.testing.assert_array_equal(got.cpu().numpy(), ps.prefix_sample_reference(p, t).cpu().numpy())


@pytest.mark.gpu
def test_kernel_prefix_never_steps_back(cuda):
    # Lane totals 1, 0.4 ulp, 0.4 ulp, 0 in the first 16 leaves: a
    # tree-ordered lane scan would give 1 + ulp at lane 2 and 1 at lane 3.
    # The kernel's running max keeps 1 + ulp from leaf 11 on, as the CPU
    # model in test_torch_prefix_sample.py derives. Where that differs from
    # the plain version (at t = 1.0), it is within rounding of a boundary.
    ulp = 2.0**-23
    prio = torch.zeros(3 * 8192, device=cuda)
    prio[torch.tensor([0, 4, 8])] = torch.tensor([1.0, 0.4 * ulp, 0.4 * ulp], device=cuda)
    targets = torch.tensor([1.0, 1.0 + ulp, 0.5], device=cuda)
    got = ps.prefix_sample(prio, targets).cpu().numpy()
    assert got.tolist() == [11, 3 * 8192, 0]
    cs64 = np.cumsum(prio.cpu().numpy().astype(np.float64))
    want = np.searchsorted(cs64, targets.cpu().numpy().astype(np.float64), side="right")
    for g, w, t in zip(got, want, targets.cpu().numpy()):
        lo, hi = sorted((int(g), int(w)))
        assert np.all(np.abs(cs64[lo:hi] - t) <= 1e-6 * cs64[-1])


@pytest.mark.gpu
def test_kernel_real_priorities_within_rounding(cuda):
    rs = np.random.RandomState(3)
    prio = rs.uniform(0.0, 1.0, 131072).astype(np.float32)
    targets = rs.uniform(0.0, float(prio.sum()), 32).astype(np.float32)
    got = ps.prefix_sample(torch.from_numpy(prio).to(cuda), torch.from_numpy(targets).to(cuda)).cpu().numpy()
    cs64 = np.cumsum(prio.astype(np.float64))
    want = np.searchsorted(cs64, targets.astype(np.float64), side="right")
    for g, w, t in zip(got, want, targets):
        if g != w:  # only within float32 rounding of a boundary
            lo, hi = sorted((int(g), int(w)))
            assert np.all(np.abs(cs64[lo:hi] - t) <= 1e-6 * cs64[-1])


@pytest.mark.gpu
def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        ps.prefix_sample(torch.zeros(8, device=cuda), torch.zeros(2))
