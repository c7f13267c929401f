"""The port's native frame ops (``pfrl_tpu_torch/runtime``) against the JAX
package's (``pfrl_tpu/runtime``).

Both libraries are built here by ``g++`` from the same source with the same
flags, so the port's native ``warp_frames`` and ``frame_max`` equal the JAX
package's native ones to the bit; the port's numpy versions equal the JAX
package's numpy versions to the bit. Native against numpy may differ by 1
at a .5 boundary, in under 1% of the pixels (``tests/test_runtime.py``'s
bound). A failed build raises by name: there is no numpy fallback.
"""

import numpy as np
import pytest

from pfrl_tpu import runtime as jruntime
from pfrl_tpu_torch import runtime

SHAPES = [  # (n, H, W, channels or None, out_h, out_w)
    (4, 210, 160, 3, 84, 84),   # raw Atari frames
    (3, 210, 160, None, 84, 84),
    (2, 168, 168, None, 84, 84),  # an integer downscale
    (5, 250, 160, 3, 84, 84),   # another Atari frame size
    (2, 210, 160, 3, 42, 53),   # another output size
]


def _frames(n, h, w, c, seed):
    rs = np.random.RandomState(seed)
    shape = (n, h, w) if c is None else (n, h, w, c)
    return rs.randint(0, 256, size=shape, dtype=np.uint8)


def test_both_libraries_build_and_load():
    assert jruntime.native_available()
    path = runtime.build()
    assert path.exists() and path.parent == runtime.BUILD_DIR and path.name.startswith("libframe_ops-")
    assert runtime.library_path() == path


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(str(x) for x in s if x is not None))
def test_warp_frames_native_and_plain_equal_the_jax_packages(shape):
    n, h, w, c, out_h, out_w = shape
    frames = _frames(n, h, w, c, seed=sum(shape[:3]))
    native = runtime.warp_frames(frames, out_h, out_w)
    plain = runtime.warp_frames(frames, out_h, out_w, plain=True)
    assert native.shape == plain.shape == (n, out_h, out_w) and native.dtype == plain.dtype == np.uint8
    np.testing.assert_array_equal(native, jruntime.warp_frames(frames, out_h, out_w))
    np.testing.assert_array_equal(plain, jruntime.warp_frames(frames, out_h, out_w, _force_numpy=True))
    # Native against numpy: float32 sums in another order, 1 apart at .5.
    diff = np.abs(native.astype(int) - plain.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_frame_max_native_and_plain_equal_the_jax_packages():
    a, b = _frames(2, 210, 160, 3, 0), _frames(2, 210, 160, 3, 1)
    got = runtime.frame_max(a, b)
    np.testing.assert_array_equal(got, jruntime.frame_max(a, b))
    np.testing.assert_array_equal(got, np.maximum(a, b))
    np.testing.assert_array_equal(runtime.frame_max(a, b, plain=True), got)
    with pytest.raises(ValueError):
        runtime.frame_max(a, b[:1])


def test_warp_semantics():
    for v in (0, 17, 255):
        assert (runtime.warp_frames(np.full((1, 210, 160, 3), v, np.uint8)) == v).all()
    frames = _frames(1, 168, 168, None, 3)
    boxes = frames[0].reshape(84, 2, 84, 2).astype(np.float32).mean(axis=(1, 3))
    expected = np.floor(boxes + 0.5).astype(np.uint8)
    assert np.abs(runtime.warp_frames(frames)[0].astype(int) - expected.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        runtime.warp_frames(np.zeros((210, 160, 3), np.uint8))


def test_a_failed_build_raises_by_name_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "GXX_FLAGS", runtime.GXX_FLAGS + ("-fno-such-flag",))
    monkeypatch.setattr(runtime, "_lib", None)
    with pytest.raises(runtime.FrameOpsBuildError, match="g\\+\\+ exited"):
        runtime.build()
    with pytest.raises(runtime.FrameOpsBuildError):
        runtime.warp_frames(_frames(1, 210, 160, 3, 0))
    with pytest.raises(runtime.FrameOpsBuildError):
        runtime.frame_max(np.zeros(4, np.uint8), np.ones(4, np.uint8))
    assert not list(tmp_path.iterdir())  # no library, no temporary left behind
    # The plain versions are still there for whoever asks for them.
    assert runtime.warp_frames(np.zeros((1, 210, 160, 3), np.uint8), plain=True).shape == (1, 84, 84)


def test_the_build_is_keyed_by_source_and_flags(monkeypatch):
    path = runtime.library_path()
    monkeypatch.setattr(runtime, "GXX_FLAGS", runtime.GXX_FLAGS[:-1])
    assert runtime.library_path() != path
