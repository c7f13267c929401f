"""Stats- and video-recording monitor wrapper (counterpart of
``pfrl_tpu/wrappers/monitor.py``; reference parity:
pfrl/wrappers/monitor.py:22-30, gym's Monitor with ``needs_reset`` support).

Episode stats land in ``monitor.csv`` (``r``, ``l``, ``t``), a row at each
``done`` or ``info["needs_reset"]``; when the env renders RGB frames, the
episodes of the video schedule are written as MJPEG AVI files
(:mod:`pfrl_tpu_torch.wrappers.video`). The default schedule is gym's
capped cubic one (episodes 0, 1, 8, 27, ..., then every 1000th). No torch.
"""

import csv
import os
import time

from pfrl_tpu_torch.wrappers.misc import _Wrapper


def capped_cubic_video_schedule(episode_id: int) -> bool:
    """gym.wrappers.monitor's default schedule."""
    if episode_id < 1000:
        return round(episode_id ** (1.0 / 3)) ** 3 == episode_id
    return episode_id % 1000 == 0


class Monitor(_Wrapper):
    def __init__(
        self,
        env,
        directory: str,
        video_callable=None,
        fps: int = 30,
    ):
        """``video_callable``: episode_id -> bool, as in gym's Monitor.
        None = capped cubic schedule; ``False`` disables video. Videos
        require the env to expose ``render()`` returning an RGB array
        (``mode="rgb_array"`` is tried first)."""
        super().__init__(env)
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._path = os.path.join(directory, "monitor.csv")
        self._start = time.time()
        self._episode_r = 0.0
        self._episode_len = 0
        self._episode_id = 0
        if video_callable is False:
            self._video_callable = lambda _ep: False
        else:
            self._video_callable = video_callable or capped_cubic_video_schedule
        self._fps = fps
        self._writer = None
        with open(self._path, "w", newline="") as f:
            csv.writer(f).writerow(["r", "l", "t"])

    # --------------------------------------------------------------- video
    def _render_frame(self):
        render = getattr(self.env, "render", None)
        if render is None:
            return None
        try:
            frame = render(mode="rgb_array")
        except TypeError:
            frame = render()
        return frame

    def _begin_video(self):
        if not self._video_callable(self._episode_id):
            return
        frame = self._render_frame()
        if frame is None:
            return
        from pfrl_tpu_torch.wrappers.video import MJPEGVideoWriter

        self._writer = MJPEGVideoWriter(
            os.path.join(
                self._dir, f"video.episode{self._episode_id:06d}.avi"
            ),
            fps=self._fps,
        )
        self._writer.add_frame(frame)

    def _capture(self):
        if self._writer is None:
            return
        frame = self._render_frame()
        if frame is not None:
            self._writer.add_frame(frame)

    def _end_video(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def close(self):
        self._end_video()
        return super().close()

    # ---------------------------------------------------------------- steps
    def reset(self):
        self._end_video()
        self._episode_r = 0.0
        self._episode_len = 0
        obs = self.env.reset()
        self._begin_video()
        return obs

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        self._episode_r += r
        self._episode_len += 1
        self._capture()
        if done or info.get("needs_reset", False):
            with open(self._path, "a", newline="") as f:
                csv.writer(f).writerow(
                    [
                        round(self._episode_r, 6),
                        self._episode_len,
                        round(time.time() - self._start, 6),
                    ]
                )
            self._end_video()
            self._episode_id += 1
        return obs, r, done, info


class Render(_Wrapper):
    """Call env.render() every step (reference: pfrl/wrappers/render.py)."""

    def __init__(self, env, **kwargs):
        super().__init__(env)
        self._kwargs = kwargs

    def reset(self):
        ret = self.env.reset()
        if hasattr(self.env, "render"):
            self.env.render(**self._kwargs)
        return ret

    def step(self, action):
        ret = self.env.step(action)
        if hasattr(self.env, "render"):
            self.env.render(**self._kwargs)
        return ret
