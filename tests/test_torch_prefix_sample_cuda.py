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
@pytest.mark.parametrize("c,b", [(131072, 32), (3 * 1024 + 517, 5), (1, 3), (200_001, 200), (1024, 1)])
def test_kernel_matches_plain_version(cuda, c, b):
    prio, targets = _case(c, c, b)
    p, t = torch.from_numpy(prio).to(cuda), torch.from_numpy(targets).to(cuda)
    before = ps.prefix_sample.launches
    got = ps.prefix_sample(p, t)
    torch.cuda.synchronize()
    assert ps.prefix_sample.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda" and got.shape == (b,)
    np.testing.assert_array_equal(got.cpu().numpy(), ps.prefix_sample_reference(p, t).cpu().numpy())


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
            assert abs(cs64[min(g, w)] - t) <= 1e-6 * cs64[-1]


@pytest.mark.gpu
def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        ps.prefix_sample(torch.zeros(8, device=cuda), torch.zeros(2))
