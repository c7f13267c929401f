// Streaming PER prefix sampler for Hopper (sm_90a).
//
//   out[b] = #{ i : cumsum(p)[i] <= t[b] }
//
// the leaf whose cumulative-priority interval holds each target; leaves of
// zero priority are never chosen and a target at or past the total gives C.
//
// Replaces pfrl_tpu/ops/pallas_kernels.py::prefix_sample_pallas (body
// _prefix_sample_kernel, chunk step _prefix_count_chunk). That kernel walks
// a *sequential* grid of 64x128 chunks and carries the running total in
// SMEM from one grid step to the next, taking prefix sums with triangular
// MXU matmuls. On Hopper blocks run in no order, so no total can be carried
// between them; the work is split into two launches instead:
//
//   1. chunk_totals_kernel, one block per 1024-leaf chunk: the chunk's
//      inclusive scan (4 leaves per thread, sequential in the thread, then a
//      cub::BlockScan over the 256 thread sums) and its last value, the
//      chunk total.
//   2. count_kernel, one block per target: the chunk offsets as a
//      left-to-right running sum of the totals, the first chunk whose end
//      exceeds the target, then the same block scan of that one chunk and a
//      cub::BlockReduce of the leaves at or below the target.
//
// Both kernels scan a chunk with the same device function, so the total a
// chunk ends on in launch 2 is bit-equal to the one launch 1 wrote, and the
// prefix "offset[c] + inclusive[i]" is non-decreasing across chunk
// boundaries. Counting only inside the crossing chunk is then exactly the
// count over all C leaves. Integer-valued priorities sum exactly (below
// 2**24) in any order, so results are bit-equal to torch.cumsum's.
//
// Bound on this card: the function reads 4*C bytes of priorities (512 KB at
// C = 131,072, about 0.16 us at 3.35 TB/s) and does C adds. At the PER
// buffer's sizes two launches of a few microseconds each cost far more than
// that, so the design keeps the work to one pass over the leaves (launch 1)
// plus one chunk per target (launch 2) and stays simple; fusing the two
// launches is left for later.
//
// Limits: any C in [1, 2**31 - 1] (no multiple-of-8192 rule: the ragged last
// chunk is padded with zeros in registers, which cannot change a count) and
// any B in [1, 2**31 - 1] (one block per target; the TPU's B <= 128 was a
// VMEM budget). Inputs are f32 and contiguous; the wrapper checks them.

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;

using BlockScan = cub::BlockScan<float, kThreads>;
using BlockReduce = cub::BlockReduce<int, kThreads>;

// Inclusive prefix, within chunk `c`, at this thread's kItems leaves.
__device__ __forceinline__ void chunk_prefix(
    const float* __restrict__ p, long long n, long long c,
    float (&incl)[kItems], BlockScan::TempStorage& tmp) {
  const long long base = c * kChunk + static_cast<long long>(threadIdx.x) * kItems;
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    run += (i < n) ? p[i] : 0.f;
    incl[k] = run;
  }
  float excl;
  BlockScan(tmp).ExclusiveSum(run, excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) incl[k] = excl + incl[k];
}

__global__ void __launch_bounds__(kThreads) chunk_totals_kernel(
    const float* __restrict__ p, long long n, float* __restrict__ totals) {
  __shared__ BlockScan::TempStorage tmp;
  float incl[kItems];
  chunk_prefix(p, n, blockIdx.x, incl, tmp);
  if (threadIdx.x == kThreads - 1) totals[blockIdx.x] = incl[kItems - 1];
}

__global__ void __launch_bounds__(kThreads) count_kernel(
    const float* __restrict__ p, long long n, const float* __restrict__ totals,
    int nchunks, const float* __restrict__ targets, int* __restrict__ out) {
  __shared__ union {
    BlockScan::TempStorage scan;
    BlockReduce::TempStorage reduce;
  } tmp;
  __shared__ float tile[kThreads];
  __shared__ int crossing;
  __shared__ float offset;

  const float t = targets[blockIdx.x];
  if (threadIdx.x == 0) crossing = nchunks;
  float run = 0.f;  // thread 0's running sum of chunk totals
  for (int base = 0; base < nchunks; base += kThreads) {
    const int m = min(kThreads, nchunks - base);
    __syncthreads();  // the tile of the previous round has been read
    if (threadIdx.x < m) tile[threadIdx.x] = totals[base + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < m; ++j) {
        const float end = run + tile[j];
        if (end > t) {
          crossing = base + j;
          break;
        }
        run = end;
      }
      offset = run;
    }
    __syncthreads();
    if (crossing < nchunks) break;
  }
  const int c = crossing;
  if (c == nchunks) {  // t at or past the total: every leaf counts
    if (threadIdx.x == 0) out[blockIdx.x] = static_cast<int>(n);
    return;
  }

  float incl[kItems];
  chunk_prefix(p, n, c, incl, tmp.scan);
  const float off = offset;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) cnt += (off + incl[k] <= t) ? 1 : 0;
  __syncthreads();  // tmp.scan is reused as tmp.reduce
  const int inside = BlockReduce(tmp.reduce).Sum(cnt);
  if (threadIdx.x == 0) out[blockIdx.x] = c * kChunk + inside;
}

}  // namespace

extern "C" {

// Leaves per chunk, so the caller can size the `totals` scratch.
int prefix_sample_chunk() { return kChunk; }

// p: f32[n] priorities; t: f32[b] targets; totals: f32[ceil(n / chunk)]
// scratch; out: int32[b]. Launches on `stream` without synchronising and
// returns cudaGetLastError() after the launches.
int prefix_sample_launch(const float* p, long long n, const float* t, int b,
                         float* totals, int* out, void* stream) {
  const long long nchunks = (n + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunk_totals_kernel<<<static_cast<unsigned>(nchunks), kThreads, 0, s>>>(p, n, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<static_cast<unsigned>(b), kThreads, 0, s>>>(
      p, n, totals, static_cast<int>(nchunks), t, out);
  return static_cast<int>(cudaGetLastError());
}

const char* prefix_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
