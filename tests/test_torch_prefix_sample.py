"""PER prefix sampler: the port's plain version and wrapper against the
JAX package's Pallas kernel (interpret mode) and XLA reference, a model of
the CUDA kernel's cluster algorithm, and, on a card, the CUDA
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


def _scan_tiles(x, warps, rows, items=4):
    """``scan_tile`` of csrc/prefix_sample.cu on each row of ``x``
    (``[tiles, warps * rows * 32 * items]`` float32, zero-padded): per lane
    ``items`` leaves summed in order; the lane totals scanned across 32
    lanes (Hillis-Steele), then a running max; each leaf is min(previous
    lane end + own prefix, own lane end); the warp's rows chained left to
    right, then the warp totals folded left to right. Returns the inclusive
    prefixes and the tile totals."""
    f32 = np.float32
    x = x.reshape(x.shape[0], warps, rows, 32, items)
    s = x.copy()
    for k in range(1, items):
        s[..., k] = s[..., k - 1] + x[..., k]
    e = s[..., -1].copy()
    for d in (1, 2, 4, 8, 16):
        y = e[..., :-d].copy()
        e[..., d:] = y + e[..., d:]
    for d in (1, 2, 4, 8, 16):
        y = e[..., :-d].copy()
        e[..., d:] = np.maximum(y, e[..., d:])
    prev = np.concatenate([np.zeros_like(e[..., :1]), e[..., :-1]], axis=-1)
    v = np.minimum(prev[..., None] + s, e[..., None])
    v[..., -1] = e
    row_base = np.zeros(x.shape[:2], f32)
    for r in range(rows):
        v[:, :, r] = row_base[..., None, None] + v[:, :, r]
        row_base = row_base + e[:, :, r, -1]
    off = np.zeros_like(row_base)
    total = np.zeros(x.shape[0], f32)
    for w in range(warps):
        off[:, w] = total
        total = total + row_base[:, w]
    v = off[:, :, None, None, None] + v
    return v.reshape(x.shape[0], warps * rows * 32 * items), total


def _cluster_model(prio, targets, k, warps=16, rows=4, with_prefix=False):
    """The CUDA kernel's algorithm in numpy float32, step for step: k
    segments of a multiple of 4 leaves, tiles of ``warps * rows * 128``
    leaves scanned by ``scan_tile``, left-to-right folds of the tile ends
    and of the segment ends, then per target the owning segment, the
    crossing tile and the first leaf inside it whose prefix exceeds it
    (or the tile's end). ``with_prefix``: also the virtual prefix over all
    leaves, ``seg_off + (tile_base + incl)``."""
    tile = warps * rows * 128
    n = prio.shape[0]
    seg = -(-(-(-n // k)) // 4) * 4
    segs = []
    for rank in range(k):
        s0 = min(rank * seg, n)
        x = prio[s0:min(s0 + seg, n)]
        ntiles = -(-x.shape[0] // tile)
        padded = np.zeros(ntiles * tile, np.float32)
        padded[:x.shape[0]] = x
        incl, totals = _scan_tiles(padded.reshape(ntiles, tile), warps, rows)
        ends, run = np.zeros(ntiles, np.float32), np.float32(0)
        for j in range(ntiles):
            run = np.float32(run + totals[j])
            ends[j] = run
        segs.append((s0, x.shape[0], incl, ends, run))
    seg_end, e = [], np.float32(0)
    for *_, total in segs:
        e = np.float32(e + total)
        seg_end.append(e)
    out = []
    for t in targets:
        owner = next((r for r in range(k) if seg_end[r] > t), k)
        if owner == k:
            out.append(n)
            continue
        s0, length, incl, ends, _ = segs[owner]
        seg_off = np.float32(0) if owner == 0 else seg_end[owner - 1]
        j = next(j for j in range(ends.shape[0]) if np.float32(seg_off + ends[j]) > t)
        base = np.float32(0) if j == 0 else ends[j - 1]
        cnt = min(tile, length - j * tile)
        prefix = seg_off + (base + incl[j, :cnt])
        above = prefix > t
        out.append(s0 + j * tile + (int(np.argmax(above)) if above.any() else cnt))
    out = np.asarray(out, np.int32)
    if not with_prefix:
        return out
    prefix = []
    for rank, (s0, length, incl, ends, _) in enumerate(segs):
        seg_off = np.float32(0) if rank == 0 else seg_end[rank - 1]
        for j in range(ends.shape[0]):
            base = np.float32(0) if j == 0 else ends[j - 1]
            prefix.append(seg_off + (base + incl[j, :min(tile, length - j * tile)]))
    return out, np.concatenate(prefix)


# K = 16 is the kernel's cluster; K = 8 holds the algorithm to a second
# segment count. C = 5 leaves empty segments, 3,589 a ragged tail, 131,072
# one resident tile per segment (the PER buffer's tree); 2**20 runs with
# 1,024-leaf tiles so that every segment streams many of them.
@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize(
    "c,warps,rows", [(1, 16, 4), (5, 16, 4), (3 * 1024 + 517, 16, 4), (131072, 16, 4), (2**20, 2, 4)]
)
def test_cluster_algorithm_matches_reference(k, c, warps, rows):
    prio, targets = _case(7 + c, c, 12)
    want = ps.prefix_sample_reference(torch.from_numpy(prio), torch.from_numpy(targets)).numpy()
    np.testing.assert_array_equal(_cluster_model(prio, targets, k, warps, rows), want)


@pytest.mark.parametrize("k", [8, 16])
def test_cluster_algorithm_real_priorities(k):
    # Real-valued priorities: the model's own prefix is non-decreasing, so
    # its count equals the count over that prefix exactly; against float64
    # it may differ only where a target lies within rounding of a boundary.
    rs = np.random.RandomState(3)
    prio = rs.uniform(0.0, 1.0, 3 * 8192 + 100).astype(np.float32)
    targets = rs.uniform(0.0, float(prio.sum()), 16).astype(np.float32)
    got, prefix = _cluster_model(prio, targets, k, warps=2, rows=4, with_prefix=True)
    # The exactness argument: the virtual prefix never decreases, so the
    # count inside the crossing tile is the count over all leaves.
    assert np.all(np.diff(prefix) >= 0)
    np.testing.assert_array_equal(got, np.searchsorted(prefix, targets, side="right"))
    cs64 = np.cumsum(prio.astype(np.float64))
    want = np.searchsorted(cs64, targets.astype(np.float64), side="right")
    for g, w, t in zip(got, want, targets):
        if g != w:
            assert abs(cs64[min(g, w)] - t) <= 1e-6 * cs64[-1]


def test_cluster_scan_stays_monotone_where_a_tree_sum_does_not():
    # Lane totals 1, 0.4 ulp, 0.4 ulp, 0: the lanes' tree-ordered scan gives
    # 1 + ulp at lane 2 but 1 at lane 3; the running max keeps the lane
    # ends, and so the virtual prefix, from stepping back.
    ulp = np.float32(2.0**-23)
    prio = np.zeros(2 * 128, np.float32)
    prio[[0, 4, 8]] = [1.0, 0.4 * ulp, 0.4 * ulp]
    targets = np.asarray([1.0, 1.0 + ulp, 0.5], np.float32)
    got, prefix = _cluster_model(prio, targets, 8, warps=1, rows=1, with_prefix=True)
    assert np.all(np.diff(prefix) >= 0)
    np.testing.assert_array_equal(got, np.searchsorted(prefix, targets, side="right"))


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
