"""Episode video recording as MJPEG-in-AVI (counterpart of
``pfrl_tpu/wrappers/video.py``; reference parity: pfrl/wrappers/monitor.py:22-30,
which delegates to gym's Monitor and ffmpeg).

Each frame is a Pillow-encoded JPEG dropped into a hand-assembled RIFF
container ('00dc' chunks + idx1 index) that every mainstream player
accepts: the same bytes as the JAX package's writer. Stdlib + Pillow, and
no torch. Pillow is imported at the first frame; without it that call
raises an ``ImportError`` naming Pillow, so a run never goes on without
its videos unnoticed.
"""

import struct
from typing import List


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"MJPEG video needs Pillow (the PIL package) to encode and decode JPEG frames: {e}") from e
    return Image


class MJPEGVideoWriter:
    """Accumulate RGB frames, write one .avi on close."""

    def __init__(self, path: str, fps: int = 30, quality: int = 85):
        self.path = path
        self.fps = fps
        self.quality = quality
        self._jpegs: List[bytes] = []
        self._size = None
        self._closed = False

    def add_frame(self, frame) -> None:
        """frame: [H, W, 3] uint8 RGB array."""
        import io

        import numpy as np

        Image = _pil_image()
        arr = np.asarray(frame)
        assert arr.ndim == 3 and arr.shape[2] == 3, arr.shape
        if self._size is None:
            self._size = (arr.shape[1], arr.shape[0])  # (W, H)
        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=self.quality)
        self._jpegs.append(buf.getvalue())

    @property
    def num_frames(self) -> int:
        return len(self._jpegs)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if not self._jpegs:
            return
        w, h = self._size
        n = len(self._jpegs)

        def chunk(fcc, payload):
            pad = b"\x00" if len(payload) % 2 else b""
            return _fourcc(fcc) + struct.pack("<I", len(payload)) + payload + pad

        def lst(kind, payload):
            return chunk("LIST", _fourcc(kind) + payload)

        max_bytes = max(len(j) for j in self._jpegs)
        # MainAVIHeader (56 bytes after fcc+size).
        avih = chunk(
            "avih",
            struct.pack(
                "<14I",
                1_000_000 // self.fps,  # usec per frame
                max_bytes * self.fps,   # max bytes/sec
                0,                      # padding granularity
                0x10,                   # AVIF_HASINDEX
                n, 0, 1, max_bytes,
                w, h, 0, 0, 0, 0,
            ),
        )
        strh = chunk(
            "strh",
            _fourcc("vids")
            + _fourcc("MJPG")
            + struct.pack(
                "<IHHIIIIIIII4H",
                0, 0, 0, 0,             # flags, prio, lang, initial frames
                1, self.fps,            # scale, rate -> fps
                0, n,                   # start, length
                max_bytes, 10_000, 0,   # sug. buffer, quality, sample size
                0, 0, w, h,             # rcFrame
            ),
        )
        strf = chunk(
            "strf",
            struct.pack(
                "<IiiHH4sIiiII",
                40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0,
            ),
        )
        hdrl = lst("hdrl", avih + lst("strl", strh + strf))

        movi_chunks = []
        offsets = []
        off = 4  # after the 'movi' fourcc
        for j in self._jpegs:
            c = chunk("00dc", j)
            offsets.append((off, len(j)))
            off += len(c)
            movi_chunks.append(c)
        movi = lst("movi", b"".join(movi_chunks))
        idx1 = chunk(
            "idx1",
            b"".join(
                _fourcc("00dc") + struct.pack("<III", 0x10, o, ln)
                for o, ln in offsets
            ),
        )
        body = _fourcc("AVI ") + hdrl + movi + idx1
        with open(self.path, "wb") as f:
            f.write(_fourcc("RIFF") + struct.pack("<I", len(body)) + body)


def read_mjpeg_frames(path: str):
    """Decode every frame of an MJPEG AVI written by MJPEGVideoWriter back
    into RGB arrays (test/verification helper)."""
    import io

    import numpy as np

    Image = _pil_image()
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", "not an AVI file"
    frames = []
    pos = 12
    stack = [len(data)]
    while pos + 8 <= stack[0]:
        fcc = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        if fcc == b"LIST":
            pos += 12  # descend into the list (skip its kind fourcc)
            continue
        if fcc == b"00dc":
            jpeg = data[pos + 8 : pos + 8 + size]
            frames.append(np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")))
        pos += 8 + size + (size % 2)
    return frames
