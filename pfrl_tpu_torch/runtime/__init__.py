"""Native host runtime: C++ frame ops for the host side of the Atari path
(counterpart of ``pfrl_tpu/runtime``).

The card owns the compute path; the host still has a hot loop feeding it,
Atari frame preprocessing above all (the reference spends it in cv2 per env
per step, pfrl/wrappers/atari_wrappers.py:159-183). It lives here as a
small C++ library (``csrc/frame_ops.cpp``, a copy of the JAX package's)
built by ``g++`` at first use into ``pfrl_tpu_torch/_build/`` (a directory
git ignores), keyed by a hash of the source, the flags and the CPU that
``-march=native`` resolves to, and loaded with ctypes. Nothing is built on
import; :func:`build` builds it ahead of time (the Atari pipeline does so
before it spawns its actor processes, so that they never race to build).

There is no quiet fallback: a failed build raises :class:`FrameOpsBuildError`.
The numpy versions are the plain versions and the test oracle; a caller
reaches them only by asking, ``plain=True``. They compute the same
semantics, ``gray = round(0.299 R + 0.587 G + 0.114 B)`` and ``out =
round(area_average(gray))``, but they are not bit-identical to the library:
the float32 sums round in another order, so a pixel at a .5 boundary may
come out 1 apart, in under 1% of the pixels (``tests/test_runtime.py`` holds
the JAX package's pair to that bound, ``tests/test_torch_frame_ops.py`` the
port's).

Public API (numpy uint8 arrays in and out):
  warp_frames(frames, out_h=84, out_w=84)  fused RGB->gray + area resize,
                                           batched: [n,H,W,3]|[n,H,W] ->
                                           [n,out_h,out_w]
  frame_max(a, b)                          elementwise uint8 max
  build()                                  the library's path, building it
                                           if needed
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parent / "csrc" / "frame_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The JAX package's first choice of flags; -march=native lets g++ vectorize
# the luma and resize loops for the host it runs on.
GXX_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-fPIC", "-fno-math-errno", "-funroll-loops", "-march=native",
)

_lock = threading.Lock()
_lib = None


class FrameOpsBuildError(RuntimeError):
    """``g++`` could not build or load ``frame_ops.cpp``."""


def _native_target() -> str:
    """The CPU that ``-march=native`` resolves to: a library built for one
    host must not be loaded on another."""
    try:
        out = subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise FrameOpsBuildError(f"frame_ops: g++ is needed to build {_CSRC.name}: {e}") from e
    return " ".join(line.split()[-1] for line in out.splitlines() if line.strip().startswith(("-march=", "-mtune=")))


def library_path() -> Path:
    h = hashlib.sha256(_CSRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_native_target().encode())
    return BUILD_DIR / f"libframe_ops-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path. Builds into
    a temporary name and renames it, so concurrent builds never load a
    half-written file."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, str(_CSRC), "-o", str(tmp)],
            check=True, capture_output=True, text=True, timeout=300,
        )
    except subprocess.CalledProcessError as e:
        raise FrameOpsBuildError(f"frame_ops: g++ exited {e.returncode}:\n{e.stderr}") from e
    except (OSError, subprocess.SubprocessError) as e:
        raise FrameOpsBuildError(f"frame_ops: g++ failed: {e}") from e
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise FrameOpsBuildError(f"frame_ops: cannot load {path}: {e}") from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for fn in (lib.warp_frames_rgb, lib.warp_frames_gray):
            fn.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
            fn.restype = None
        lib.frame_max_u8.argtypes = [u8p, u8p, u8p, ctypes.c_int64]
        lib.frame_max_u8.restype = None
        _lib = lib
        return _lib


# ------------------------------------------------------------ plain versions
def _axis_weights(in_size: int, out_size: int) -> np.ndarray:
    """Fractional box-overlap weights as a dense [out, in] matrix."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        lo, hi = o * scale, (o + 1) * scale
        ilo, ihi = int(np.floor(lo)), min(int(np.ceil(hi)), in_size)
        for i in range(ilo, ihi):
            w[o, i] = (min(i + 1, hi) - max(i, lo)) / scale
    return w


_weight_cache = {}


def _weights(in_size: int, out_size: int) -> np.ndarray:
    key = (in_size, out_size)
    if key not in _weight_cache:
        _weight_cache[key] = _axis_weights(in_size, out_size)
    return _weight_cache[key]


def _warp_numpy(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    if frames.ndim == 4:  # RGB
        f = frames.astype(np.float32)
        gray = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        gray = np.floor(gray + 0.5).astype(np.uint8)
    else:
        gray = frames
    wy = _weights(gray.shape[1], out_h)  # [out_h, H]
    wx = _weights(gray.shape[2], out_w)  # [out_w, W]
    resized = np.einsum("yh,nhw,xw->nyx", wy, gray.astype(np.float32), wx, optimize=True)
    return np.minimum(np.floor(resized + 0.5), 255).astype(np.uint8)


# ----------------------------------------------------------------- public API
def warp_frames(frames: np.ndarray, out_h: int = 84, out_w: int = 84, *, plain: bool = False) -> np.ndarray:
    """Fused grayscale + INTER_AREA-style resize, batched over frames.

    Accepts ``[n, H, W, 3]`` (RGB) or ``[n, H, W]`` (already gray) uint8 and
    returns ``[n, out_h, out_w]`` uint8, from the C++ library, or from the
    numpy version with ``plain=True``.
    """
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim == 3 and frames.shape[-1] == 3:
        raise ValueError("pass a batch: [n, H, W, 3] or [n, H, W]")
    if plain:
        return _warp_numpy(frames, out_h, out_w)
    lib = _load()
    n, in_h, in_w = frames.shape[:3]
    out = np.empty((n, out_h, out_w), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fn = lib.warp_frames_rgb if frames.ndim == 4 else lib.warp_frames_gray
    fn(frames.ctypes.data_as(u8p), n, in_h, in_w, out.ctypes.data_as(u8p), out_h, out_w)
    return out


def frame_max(a: np.ndarray, b: np.ndarray, *, plain: bool = False) -> np.ndarray:
    """Elementwise uint8 max (MaxAndSkip's two-frame pooling), from the C++
    library, or ``np.maximum`` with ``plain=True``."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    if a.shape != b.shape:
        raise ValueError(f"frame_max of shapes {a.shape} and {b.shape}")
    if plain:
        return np.maximum(a, b)
    lib = _load()
    out = np.empty_like(a)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.frame_max_u8(a.ctypes.data_as(u8p), b.ctypes.data_as(u8p), out.ctypes.data_as(u8p), a.size)
    return out


__all__ = ["FrameOpsBuildError", "build", "frame_max", "library_path", "warp_frames"]
