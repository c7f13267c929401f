// PER prefix sampler for Hopper (sm_90a): one launch of one thread-block
// cluster.
//
//   out[b] = #{ i : cumsum(p)[i] <= t[b] }
//
// the leaf whose cumulative-priority interval holds each target; leaves of
// zero priority are never chosen and a target at or past the total gives C.
// Priorities are non-negative, as a sum tree's leaves are.
//
// Replaces pfrl_tpu/ops/pallas_kernels.py::prefix_sample_pallas (:145, the
// pallas_call at :162; body _prefix_sample_kernel, chunk step
// _prefix_count_chunk). That kernel walks a sequential grid of 64x128
// chunks and carries the running total in SMEM from one grid step to the
// next. On Hopper blocks run in no order, so nothing carries between grid
// steps; what replaces the carry here is one cluster of K = 16 blocks
// (kCluster) on neighbouring SMs whose shared memory every block of the
// cluster can read. 16 is the non-portable maximum; the portable 8 was
// measured 1.3 to 1.8 times slower (PERF.md), as each block streams twice
// the bytes.
//
// Design, per call (one launch, no global scratch, no atomics):
//   1. Block k owns the contiguous segment [k*S, min((k+1)*S, C)), S a
//      multiple of 4; segments at the end are empty when C is small. It
//      streams the segment through two shared-memory tiles of kTile
//      leaves with the 1-D bulk asynchronous copy (cp.async.bulk on an
//      mbarrier), one tile in flight while it scans the other. A head of up
//      to 3 leaves and a ragged tail that break the copy's 16-byte rule take
//      plain loads; the tiles sit in shared memory at the global address's
//      offset modulo 16 bytes, so the copied body is aligned at both ends.
//   2. scan_tile makes each tile its inclusive prefix, in place, in three
//      levels (lane, row, warp; see there) whose dependency chains are a few
//      adds and ten shuffles long. Its total is folded left to right into the
//      running tile ends (kept in shared memory) and the segment total.
//   3. Each block writes its segment total into the shared memory of every
//      block of the cluster (distributed shared memory) with an
//      asynchronous store that completes on the receiving block's mbarrier.
//      Once its own K totals are in, a block folds them left to right, so
//      all hold bit-identical segment ends. No block touches another's
//      shared memory after its stores, and none leaves before every store
//      into it has landed, so no exit barrier is needed.
//   4. Target b is written by exactly one block: the one whose segment is
//      the first to end above t, within it the first tile that ends above
//      t, and within that tile the first leaf whose prefix exceeds t (a
//      binary search). The tiles still in shared memory are searched in
//      place; any other tile is loaded again (from L2) and rescanned with
//      the same scan_tile, so its bits are the ones the tile ends came
//      from. If no segment ends above t the last block writes C. Blocks loop
//      over the targets, so any B works.
//
// Exactness: every prefix is built the same way everywhere,
//   P(i) = seg_off + (tile_base + incl[i]),
// with incl the tile's inclusive scan, tile_base the previous tile end and
// seg_off the previous segment end. At each level (lane, row, warp, tile,
// segment) a value is a base plus a part that never decreases and never
// passes the unit's total, and the next unit's base is exactly base + total
// (the lanes' bases come from a running max over a tree-ordered scan, which
// alone could step back by an ulp). Rounding is monotone, so P never
// decreases over all C leaves, and counting inside the crossing tile is
// exactly the count over all C leaves. Integer-valued priorities sum
// exactly (below 2**24) in any order, so results are bit-equal to
// torch.cumsum's on them; real-valued ones differ from it by rounding.
//
// Bound on this card (H100 SXM, 3.35 TB/s): the function reads 4*C bytes of
// priorities and does C adds, so it is bound by bytes: 0.157 us at
// C = 131,072 (the PER buffer's 2**17-leaf tree), 1.25 us at C = 2**20 (a
// 10**6-slot buffer). What the design does about the earlier two-launch
// kernel's limits: (1) one launch and one cluster barrier instead of two
// dependent launches; (2) no serial walk over all chunk totals per target:
// segment ends are K values in shared memory and tile ends are found by a
// binary search; (3) the wrapper makes one call and allocates only `out`.
// A single cluster uses K of the card's 132 SMs, so at large C the time is
// bounded by what K SMs can pull, not by the card's memory rate.
//
// Limits: any C in [1, 2**31 - 1] and any B in [1, 2**31 - 1]. Shared
// memory is 2 tiles (64 KB) plus one float per tile of a segment (at most
// 64 KB, at C = 2**31 - 1: 128 KB in all). Inputs are f32 and
// contiguous; the wrapper checks them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;  // blocks in the one cluster
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                      // contiguous leaves per lane in a row
constexpr int kRowSpan = 32 * kItems;          // 128 leaves
constexpr int kRows = 4;                       // rows per warp
constexpr int kWarpSpan = kRows * kRowSpan;    // 512 leaves
constexpr int kTile = kWarps * kWarpSpan;      // 8,192 leaves, 32 KB
constexpr int kStages = 2;                     // tiles in shared memory (PERF.md)
constexpr int kBufFloats = kTile + 4;          // room for the 16-byte offset

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// As mbar_wait, for a barrier that other blocks of the cluster complete:
// their stores are visible once it returns.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Orders this thread's generic accesses to shared memory before later bulk
// copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Loading `cnt` leaves from `src` into `dst` (same address modulo 16
// bytes) takes two calls: load_bulk, by one thread, copies the aligned body
// with one bulk copy that completes on `bar` (or just arrives on it);
// load_plain, by every thread, copies the up to 3 head and 3 tail leaves.
__device__ __forceinline__ void load_bulk(float* dst, const float* __restrict__ src, int cnt,
                                          int head, uint64_t* bar) {
  const int h = min(head, cnt);
  const int body = ((cnt - h) / 4) * 4;
  const uint32_t b = smem_addr(bar);
  if (body > 0) {
    const uint32_t bytes = static_cast<uint32_t>(body) * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst + h)), "l"(src + h), "r"(bytes), "r"(b)
        : "memory");
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
  }
}

__device__ __forceinline__ void load_plain(float* dst, const float* __restrict__ src, int cnt,
                                           int head) {
  const int h = min(head, cnt);
  const int tail0 = h + ((cnt - h) / 4) * 4;
  const int tid = threadIdx.x;
  if (tid < h) dst[tid] = src[tid];
  if (tid < cnt - tail0) dst[tail0 + tid] = src[tail0 + tid];
}

// In place: tile[i] becomes the inclusive prefix of tile[0..i] for i < cnt.
// Returns the tile total in every thread: no prefix of the tile exceeds it,
// and it is at least the last one. `aligned`: the tile starts on 16 bytes.
// `reused`: a bulk copy will write this buffer again, so the block's
// accesses are fenced off from it first.
// Starts and ends with the block in step; the order of the additions is
// fixed, so equal inputs give equal bits. Three levels, each a base plus a
// value that never decreases and ends exactly where the next base starts:
//   lane  - 4 contiguous leaves summed in order; the lanes' totals scanned
//           across the warp (Hillis-Steele), then a running max over the
//           lanes (exact) so the lane ends never decrease; each leaf is
//           min(previous lane end + own prefix, own lane end);
//   row   - the warp's 4 rows of 128 leaves chained left to right;
//   warp  - the 16 warp totals folded left to right.
__device__ __forceinline__ float scan_tile(float* tile, int cnt, bool aligned, bool reused,
                                           float* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The rows' shuffle chains go step by step side by side, so their
  // latencies overlap (a shuffle is not reordered past another).
  float s[kRows][kItems];
  float e[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i0 = warp * kWarpSpan + r * kRowSpan + lane * kItems;
    float x[kItems];
    if (aligned && i0 + kItems <= cnt) {
      const float4 q = *reinterpret_cast<const float4*>(tile + i0);
      x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) x[k] = (i0 + k < cnt) ? tile[i0 + k] : 0.f;
    }
    s[r][0] = x[0];
#pragma unroll
    for (int k = 1; k < kItems; ++k) s[r][k] = s[r][k - 1] + x[k];
    e[r] = s[r][kItems - 1];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float y[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) y[r] = __shfl_up_sync(0xffffffffu, e[r], d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) if (lane >= d) e[r] = y[r] + e[r];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float y[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) y[r] = __shfl_up_sync(0xffffffffu, e[r], d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) if (lane >= d) e[r] = fmaxf(y[r], e[r]);
  }
  float v[kRows][kItems];
  float row_tot[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float prev = __shfl_up_sync(0xffffffffu, e[r], 1);
    if (lane == 0) prev = 0.f;
    row_tot[r] = __shfl_sync(0xffffffffu, e[r], 31);
#pragma unroll
    for (int k = 0; k < kItems - 1; ++k) v[r][k] = fminf(prev + s[r][k], e[r]);
    v[r][kItems - 1] = e[r];
  }
  float row_base = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) v[r][k] = row_base + v[r][k];
    row_base = row_base + row_tot[r];
  }
  if (lane == 0) warp_tot[warp] = row_base;
  __syncthreads();
  float wt[kWarps];  // all loads first, then the fold
#pragma unroll
  for (int w = 0; w < kWarps; w += 4) {
    const float4 q = *reinterpret_cast<const float4*>(warp_tot + w);
    wt[w] = q.x, wt[w + 1] = q.y, wt[w + 2] = q.z, wt[w + 3] = q.w;
  }
  float off = 0.f, total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) off = total;
    total = total + wt[w];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i0 = warp * kWarpSpan + r * kRowSpan + lane * kItems;
    if (aligned) {
      *reinterpret_cast<float4*>(tile + i0) =
          make_float4(off + v[r][0], off + v[r][1], off + v[r][2], off + v[r][3]);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) tile[i0 + k] = off + v[r][k];
    }
  }
  if (reused) fence_proxy_async();
  __syncthreads();
  return total;
}

// First i in [0, cnt) with seg_off + (base + tile[i]) > t, else cnt.
__device__ __forceinline__ int search_tile(const float* tile, int cnt, float seg_off, float base,
                                           float t) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_off + (base + tile[mid]) > t) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Smallest `v` over the block; every thread gets it.
__device__ __forceinline__ int block_min(int v, int* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, d));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, red[w]);
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kThreads, 1) prefix_sample_kernel(
    const float* __restrict__ p, long long n, long long seg, const float* __restrict__ targets,
    int nb, int* __restrict__ out) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ __align__(8) uint64_t bar[kStages];
  __shared__ __align__(16) float warp_tot[kWarps];
  __shared__ __align__(8) uint64_t totals_bar;  // completes when all K totals are in
  __shared__ float seg_total[kCluster];  // every block's, written by that block
  __shared__ float seg_end[kCluster];
  __shared__ int red[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const long long s0 = min(static_cast<long long>(rank) * seg, n);
  const long long len = min(s0 + seg, n) - s0;
  const int ntiles = static_cast<int>((len + kTile - 1) / kTile);
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  const int head = (4 - shift) & 3;
  float* const smem = dyn;
  uint64_t* const bars = bar;
  float* tile_end = smem + kStages * kBufFloats;
  auto buf = [=](int s) { return smem + s * kBufFloats + shift; };
  auto tile_len = [&](int j) {
    return static_cast<int>(min(static_cast<long long>(kTile), len - static_cast<long long>(j) * kTile));
  };
  auto tile_src = [&](int j) { return p + s0 + static_cast<long long>(j) * kTile; };
  auto load = [&](int j, int s) {
    load_plain(buf(s), tile_src(j), tile_len(j), head);
    if (tid == 0) load_bulk(buf(s), tile_src(j), tile_len(j), head, bars + s);
  };

  const float t_first = tid < nb ? targets[tid] : 0.f;  // read early, used in step 3
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    mbar_init(&totals_bar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(&totals_bar)), "r"(static_cast<uint32_t>(kCluster * sizeof(float)))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // The first tiles' bulk copies start before the block is in step.
    for (int j = 0; j < kStages - 1 && j < ntiles; ++j)
      load_bulk(buf(j), tile_src(j), tile_len(j), head, bars + j);
  }
  __syncthreads();
  // Arrive now, wait before the first write to another block's shared
  // memory: by then every block of the cluster has started and initialised
  // its barriers.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 1. Scan the segment tile by tile; fold the tile ends left to right.
  uint32_t parity = 0;  // bit s: the phase stage s waits for next
  float run = 0.f;
  for (int j = 0; j < kStages - 1 && j < ntiles; ++j)
    load_plain(buf(j), tile_src(j), tile_len(j), head);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    // The stage tile j + kStages - 1 goes to last held tile j - 1, scanned.
    if (j + kStages - 1 < ntiles) load(j + kStages - 1, (j + kStages - 1) % kStages);
    mbar_wait(bars + s, (parity >> s) & 1u);
    parity ^= 1u << s;
    __syncthreads();  // the plain-loaded head and tail are in place
    run = run + scan_tile(buf(s), tile_len(j), shift == 0, j + kStages < ntiles, warp_tot);
    if (tid == 0) tile_end[j] = run;
  }
  // The tile each stage still holds: the last one of its residue class.
  int resident[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s)
    resident[s] = ntiles > s ? s + (ntiles - 1 - s) / kStages * kStages : -1;

  // 2. Segment ends across the cluster, folded left to right in every block.
  // Each block writes its total into every block's seg_total[rank] with an
  // asynchronous store that completes on that block's totals_bar; each
  // block waits on its own. A block leaves only once all K totals have
  // reached it, and touches no other block's shared memory after its
  // stores, so no exit barrier is needed.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < kCluster) {
    uint32_t dst, dst_bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(dst) : "r"(smem_addr(&seg_total[rank])), "r"(tid));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(dst_bar) : "r"(smem_addr(&totals_bar)), "r"(tid));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
        ::"r"(dst), "r"(__float_as_uint(run)), "r"(dst_bar)
        : "memory");
  }
  mbar_wait_cluster(&totals_bar, 0);
  if (tid < 32) {  // lane k folds totals 0..k left to right (adding 0 past k)
    const float total_k = tid < kCluster ? seg_total[tid] : 0.f;
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) {
      const float x = __shfl_sync(0xffffffffu, total_k, k);
      e = e + (k <= tid ? x : 0.f);
    }
    if (tid < kCluster) seg_end[tid] = e;
  }
  __syncthreads();
  const float seg_off = rank == 0 ? 0.f : seg_end[rank - 1];

  // 3. The targets this block owns.
  for (long long first = 0; first < nb; first += kThreads) {
    const int b = static_cast<int>(min(first + tid, static_cast<long long>(nb)));
    bool pending = false;
    int j = 0;
    float t = 0.f;
    if (b < nb) {
      t = first == 0 ? t_first : targets[b];
      int k = 0, hi = kCluster;  // the first segment ending above t, or K
      while (k < hi) {
        const int mid = (k + hi) >> 1;
        if (seg_end[mid] > t) hi = mid; else k = mid + 1;
      }
      if (k == kCluster && rank == kCluster - 1) {
        out[b] = static_cast<int>(n);
      } else if (k == rank) {
        int lo = 0, hi = ntiles - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (seg_off + tile_end[mid] > t) hi = mid; else lo = mid + 1;
        }
        j = lo;
        pending = true;
      }
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (pending && resident[s] == j) {
        const float base = j == 0 ? 0.f : tile_end[j - 1];
        const int c = search_tile(buf(s), tile_len(j), seg_off, base, t);
        out[b] = static_cast<int>(s0 + static_cast<long long>(j) * kTile + c);
        pending = false;
      }
    }
    // Tiles no longer in shared memory: load and rescan them one at a time
    // into stage 0, fencing the block's accesses off from the copy first.
    while (__syncthreads_or(pending)) {
      fence_proxy_async();
      const int jl = block_min(pending ? j : INT_MAX, red);
      load(jl, 0);
      mbar_wait(bars, parity & 1u);
      parity ^= 1u;
      __syncthreads();
      scan_tile(buf(0), tile_len(jl), shift == 0, false, warp_tot);
      resident[0] = jl;
      if (pending && j == jl) {
        const float base = j == 0 ? 0.f : tile_end[j - 1];
        const int c = search_tile(buf(0), tile_len(j), seg_off, base, t);
        out[b] = static_cast<int>(s0 + static_cast<long long>(j) * kTile + c);
        pending = false;
      }
    }
  }
}

long long segment_len(long long n) {
  const long long s = (n + kCluster - 1) / kCluster;
  return (s + 3) / 4 * 4;
}

size_t smem_bytes(long long n) {
  const long long ntiles = (segment_len(n) + kTile - 1) / kTile;
  return sizeof(float) * (static_cast<size_t>(kStages) * kBufFloats + static_cast<size_t>(ntiles));
}

// Raises the current device's limit on the kernel's dynamic shared memory
// to at least `smem` and allows the non-portable cluster size. Both are
// attributes of the function on each device, so the largest size set so
// far is kept per device; it is never lowered, so earlier sizes stay
// launchable.
constexpr int kMaxDevices = 64;

cudaError_t allow(size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  size_t* done = device < kMaxDevices ? &allowed[device] : nullptr;
  if (done && smem <= *done) return cudaSuccess;
  err = cudaFuncSetAttribute(prefix_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(prefix_sample_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && done) *done = smem;
  return err;
}

// One cluster of kCluster blocks with the shared memory a call over n
// leaves takes.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(long long n, cudaStream_t stream) {
    cfg.gridDim = dim3(kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(n);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace

extern "C" {

// p: f32[n] priorities; t: f32[b] targets; out: int32[b]. Launches once on
// `stream` (of CUDA device `device`) without synchronising; returns
// cudaGetLastError() after the launch.
int prefix_sample_launch(const float* p, long long n, const float* t, int b, int* out,
                         void* stream, int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  ClusterLaunch l(n, static_cast<cudaStream_t>(stream));
  err = allow(l.cfg.dynamicSmemBytes);
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&l.cfg, prefix_sample_kernel, p, n, segment_len(n), t, b, out);
    const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
    if (err == cudaSuccess) err = last;
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

// How many clusters, with the shared memory a call over n leaves takes, the
// current device can hold at once (cudaOccupancyMaxActiveClusters).
int prefix_sample_max_active_clusters(long long n, int* count) {
  ClusterLaunch l(n, nullptr);
  const cudaError_t err = allow(l.cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, prefix_sample_kernel, &l.cfg));
}

// Dynamic shared memory per block of a call over n leaves.
long long prefix_sample_smem_bytes(long long n) {
  return static_cast<long long>(smem_bytes(n));
}

const char* prefix_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
