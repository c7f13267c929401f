"""Where a prefix-sample kernel launch spends its time: phase marks and
ablated variants of ``csrc/prefix_sample.cu``.

    python -m pfrl_tpu_torch.experiments.trace_prefix_sample [--calls 50]

The kernel's source carries no instrumentation. This tool writes variants
of it into ``_build/variants/`` by textual edits, builds them all at once
with the package's ``nvcc`` flags, and runs each on the CUDA device at the
main path's C = 131,072 leaves and at C = 2**20, B = 32:

- ``traced``: thread 0 of each block records ``clock64()`` at seven marks
  between the kernel's phases, and the global timer at the first and the
  last; printed are the mean SM cycles of each phase over blocks and calls
  and the span from the first block's start to the last block's end;
- ``stages3``, ``stages4``: three or four shared-memory tiles instead of two;
- ``cluster8``: a cluster of 8 blocks (the portable maximum) instead of 16;
- ``noscan``: each tile's scan replaced by a barrier (a floor; counts wrong);
- ``noload``: no leaf is loaded (a floor; counts wrong);
- ``empty``: the kernel returns at once, so what is timed is the launch of
  one cluster of the same shape and shared memory.

Each is timed beside the unedited kernel (``kernel``) as device time per
call, back to back behind a sleep kernel, in turns (forward, then
backward). ``traced`` and the stage variants must give the kernel's exact
counts. An edit whose anchor is no longer in the source stops the tool and
names the anchor. The wrapper never loads these variants.
"""

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from pfrl_tpu_torch.ops import cuda_build
from pfrl_tpu_torch.ops import prefix_sample as ps

VARIANT_DIR = cuda_build.BUILD_DIR / "variants"

PHASES = (
    "barrier init, first copies issued",
    "first tile load",
    "segment scan (all tiles)",
    "wait for the cluster to start",
    "segment totals exchanged and folded",
    "targets searched and written",
)
MARKS = len(PHASES) + 1

_TRACE_GLOBALS = f"""
__device__ long long g_trace_clock[kCluster][{MARKS}];
__device__ long long g_trace_time[kCluster][2];
#define TRACE_MARK(i) \\
  do {{ \\
    if (threadIdx.x == 0) {{ \\
      g_trace_clock[blockIdx.x][i] = clock64(); \\
      if ((i) == 0 || (i) == {MARKS - 1}) {{ \\
        long long now; \\
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now)); \\
        g_trace_time[blockIdx.x][(i) == 0 ? 0 : 1] = now; \\
      }} \\
    }} \\
  }} while (0)
"""

_TRACE_READ = """
extern "C" int prefix_sample_trace_read(long long* clock, long long* time) {
  cudaError_t err = cudaMemcpyFromSymbol(clock, g_trace_clock, sizeof(g_trace_clock));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyFromSymbol(time, g_trace_time, sizeof(g_trace_time)));
}
"""

_KERNEL_END = "        pending = false;\n      }\n    }\n  }\n}\n\nlong long segment_len"
_STAGES = "constexpr int kStages = 2;"

# (anchor, replacement) pairs; each anchor must occur exactly once.
EDITS = {
    "traced": (
        ("constexpr int kBufFloats", _TRACE_GLOBALS + "constexpr int kBufFloats"),
        ("  const float t_first", "  TRACE_MARK(0);\n  const float t_first"),
        ("  // 1. Scan the segment", "  TRACE_MARK(1);\n  // 1. Scan the segment"),
        ("  // the plain-loaded head and tail are in place\n",
         "  // the plain-loaded head and tail are in place\n    if (j == 0) TRACE_MARK(2);\n"),
        ("  // 2. Segment ends across", "  TRACE_MARK(3);\n  // 2. Segment ends across"),
        ('  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n',
         '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n  TRACE_MARK(4);\n'),
        ("  // 3. The targets this block owns.", "  TRACE_MARK(5);\n  // 3. The targets this block owns."),
        (_KERNEL_END, _KERNEL_END.replace("  }\n}\n\n", f"  }}\n  TRACE_MARK({MARKS - 1});\n}}\n\n")),
        ('}  // extern "C"\n', '}  // extern "C"\n' + _TRACE_READ),
    ),
    "stages3": ((_STAGES, _STAGES.replace("2", "3")),),
    "stages4": ((_STAGES, _STAGES.replace("2", "4")),),
    "cluster8": (("constexpr int kCluster = 16;", "constexpr int kCluster = 8;"),),
    "noscan": (
        ("                                           float* warp_tot) {\n",
         "                                           float* warp_tot) {\n"
         "  __syncthreads();\n  if (cnt >= 0) return static_cast<float>(cnt);\n"),
    ),
    "noload": (
        ("  const uint32_t b = smem_addr(bar);\n  if (body > 0) {",
         "  const uint32_t b = smem_addr(bar);\n  if (body < 0) {"),
        ("  const int tail0 = h + ((cnt - h) / 4) * 4;\n",
         "  const int tail0 = h + ((cnt - h) / 4) * 4;\n  if (cnt >= 0) return;\n"),
    ),
    "empty": (
        ("    int nb, int* __restrict__ out) {\n", "    int nb, int* __restrict__ out) {\n  if (n >= 0) return;\n"),
    ),
}
EXACT = ("traced", "stages3", "stages4")


def variant_source(name: str, src: str) -> str:
    for anchor, new in EDITS[name]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"variant {name}: anchor found {src.count(anchor)} times: {anchor!r}")
        src = src.replace(anchor, new)
    return src


def build_variants() -> dict:
    """Writes and compiles every variant, all ``nvcc`` processes at once;
    returns each one's bound library."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / "prefix_sample.cu").read_text()
    jobs = {}
    for name in EDITS:
        cu = VARIANT_DIR / f"prefix_sample_{name}.cu"
        cu.write_text(variant_source(name, src))
        so = VARIANT_DIR / f"libprefix_sample_{name}.{os.getpid()}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        libs[name] = ps._bind(ctypes.CDLL(str(so)))
    if failed:
        raise RuntimeError("variant build failed:\n" + "\n".join(failed))
    libs["kernel"] = ps._library()
    return libs


def device_us(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over back-to-back calls behind a sleep
    kernel, so that the host's cost of issuing them is hidden."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def launcher(lib, p, t, out, device):
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        err = lib.prefix_sample_launch(
            p.data_ptr(), p.shape[0], t.data_ptr(), t.shape[0], out.data_ptr(), stream, device.index
        )
        if err:
            raise RuntimeError(f"launch failed ({lib.prefix_sample_error_string(err).decode()})")

    return launch


def trace_phases(lib, launch, calls: int) -> dict:
    clock = np.zeros((ps.CLUSTER, MARKS), np.int64)
    span = np.zeros((ps.CLUSTER, 2), np.int64)
    lib.prefix_sample_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    cycles, spans = [], []
    for i in range(calls + 5):
        launch()
        torch.cuda.synchronize()
        if lib.prefix_sample_trace_read(clock.ctypes.data, span.ctypes.data):
            raise RuntimeError("reading the trace failed")
        if i >= 5:  # the first calls warm the caches
            cycles.append(np.diff(clock, axis=1).mean(0))
            spans.append(span[:, 1].max() - span[:, 0].min())
    return {
        "cycles": dict(zip(PHASES, np.mean(cycles, 0).round(1).tolist())),
        "first_start_to_last_end_ns": float(np.mean(spans)),
    }


def run(calls: int) -> dict:
    device = torch.device("cuda", torch.cuda.current_device())
    libs = build_variants()
    record = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip(),
        "cluster": ps.CLUSTER,
        "shapes": [],
    }
    rs = np.random.RandomState(0)
    names = list(libs)
    for c in (131072, 1 << 20):
        p = torch.from_numpy(rs.uniform(0.0, 1.0, c).astype(np.float32)).to(device)
        t = torch.from_numpy(np.sort(rs.uniform(0.0, float(p.sum()), 32)).astype(np.float32)).to(device)
        outs = {n: torch.empty(32, dtype=torch.int32, device=device) for n in names}
        launch = {n: launcher(libs[n], p, t, outs[n], device) for n in names}
        for n in names:
            launch[n]()
        torch.cuda.synchronize()
        for n in EXACT:
            if not torch.equal(outs[n], outs["kernel"]):
                raise AssertionError(f"variant {n} disagrees with the kernel at C={c}")
        turns = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                turns[n].append(device_us(launch[n]))
        record["shapes"].append({
            "C": c,
            "B": 32,
            "device_us": {n: float(np.mean(v)) for n, v in turns.items()},
            "device_us_turns": turns,
            "traced": trace_phases(libs["traced"], launch["traced"], calls),
        })
    return record


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_prefix_sample: needs a CUDA device")
    print(json.dumps(run(args.calls), indent=1))


if __name__ == "__main__":
    main()
