"""PER prefix sampler: the port's plain version and wrapper against the
JAX package's Pallas kernel (interpret mode) and XLA reference, a model of
the CUDA kernel's two-launch chunk algorithm, and, on a card, the CUDA
kernel itself.

Integer-valued float32 priorities sum exactly in any order (all partial
sums stay below 2**24), so every comparison here is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfrl_tpu.ops import pallas_kernels as pk
from pfrl_tpu_torch.ops import prefix_sample as ps

torch.set_num_threads(1)

KERNEL_CHUNK = 1024  # leaves per block in csrc/prefix_sample.cu


def _case(seed, c, b, high=5):
    rs = np.random.RandomState(seed)
    prio = rs.randint(0, high, c).astype(np.float32)
    prio[-c // 7:] = 0.0  # an all-zero tail, counted past
    total = float(prio.sum())
    cs = np.cumsum(prio)
    targets = np.concatenate([
        rs.uniform(0.0, total, b - 4),
        [cs[c // 3], 0.0, total, total + 3.0],  # on a boundary, ends, past
    ]).astype(np.float32)
    return prio, targets


@pytest.mark.parametrize("chunks", [1, 2])
def test_reference_matches_pallas_kernel_and_xla(chunks):
    prio, targets = _case(chunks, chunks * pk._CHUNK, 32)
    want_pallas = np.asarray(pk.prefix_sample_pallas(jnp.asarray(prio), jnp.asarray(targets), interpret=True))
    want_xla = np.asarray(pk.prefix_sample_reference(jnp.asarray(prio), jnp.asarray(targets)))
    got = ps.prefix_sample_reference(torch.from_numpy(prio), torch.from_numpy(targets))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    np.testing.assert_array_equal(got.numpy(), want_xla)


@pytest.mark.parametrize("c,b", [(8192, 32), (3 * 1024 + 517, 5), (1, 3), (5000, 200)])
def test_wrapper_on_cpu_is_the_plain_version(c, b):
    prio, targets = _case(c, c, max(b, 5))
    p, t = torch.from_numpy(prio), torch.from_numpy(targets[:b].copy())
    want = np.asarray(pk.prefix_sample_reference(jnp.asarray(prio), jnp.asarray(targets[:b])))
    before = ps.prefix_sample.launches
    np.testing.assert_array_equal(ps.prefix_sample(p, t).numpy(), want)
    assert ps.prefix_sample.launches == before  # the CPU path launches nothing


def _two_launch_model(prio, targets, chunk=KERNEL_CHUNK, threads=256):
    """The CUDA kernel's algorithm in numpy float32, step for step: chunk
    inclusive scans (sequential per thread, then across thread sums), chunk
    totals, a left-to-right running offset, and a count inside the first
    chunk whose end exceeds the target."""
    f32 = np.float32
    n = prio.shape[0]
    nchunks = -(-n // chunk)
    padded = np.zeros(nchunks * chunk, np.float32)
    padded[:n] = prio

    def chunk_incl(c):
        x = padded[c * chunk:(c + 1) * chunk].reshape(threads, -1)
        local = np.cumsum(x, axis=1, dtype=np.float32)
        excl = np.concatenate([[f32(0)], np.cumsum(local[:, -1], dtype=np.float32)[:-1]])
        return (excl[:, None].astype(np.float32) + local).reshape(-1)

    totals = [chunk_incl(c)[-1] for c in range(nchunks)]
    out = []
    for t in targets:
        run, crossing = f32(0), nchunks
        for c, tot in enumerate(totals):
            end = f32(run + tot)
            if end > t:
                crossing = c
                break
            run = end
        if crossing == nchunks:
            out.append(n)
        else:
            out.append(crossing * chunk + int(np.sum(f32(run) + chunk_incl(crossing) <= t)))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("c", [KERNEL_CHUNK, 3 * KERNEL_CHUNK + 517, 8192, 1])
def test_two_launch_chunk_algorithm_matches_reference(c):
    prio, targets = _case(7 + c, c, 12)
    want = ps.prefix_sample_reference(torch.from_numpy(prio), torch.from_numpy(targets)).numpy()
    np.testing.assert_array_equal(_two_launch_model(prio, targets), want)


def test_two_launch_chunk_algorithm_real_priorities():
    # Real-valued priorities: the model's own prefix is non-decreasing, so
    # its count equals the count over that prefix exactly.
    rs = np.random.RandomState(3)
    prio = rs.uniform(0.0, 1.0, 3 * KERNEL_CHUNK + 100).astype(np.float32)
    targets = rs.uniform(0.0, float(prio.sum()), 16).astype(np.float32)
    got = _two_launch_model(prio, targets)
    cs64 = np.cumsum(prio.astype(np.float64))
    want = np.searchsorted(cs64, targets.astype(np.float64), side="right")
    # Off by one only where the target sits within float32 rounding of a boundary.
    for g, w, t in zip(got, want, targets):
        if g != w:
            assert abs(cs64[min(g, w)] - t) <= 1e-6 * cs64[-1]


@pytest.mark.parametrize(
    "p,t,err",
    [
        (torch.zeros(8, dtype=torch.float64), torch.zeros(2), TypeError),
        (torch.zeros(8), torch.zeros(2, dtype=torch.int32), TypeError),
        (torch.zeros(2, 4), torch.zeros(2), ValueError),
        (torch.zeros(0), torch.zeros(2), ValueError),
        (torch.zeros(8), torch.zeros(0), ValueError),
        (torch.zeros(16)[::2], torch.zeros(2), ValueError),
    ],
)
def test_wrapper_rejects_bad_input(p, t, err):
    with pytest.raises(err):
        ps.prefix_sample(p, t)
