"""AtariSim's arithmetic, frozen: frames, rewards, episode ends and resets.

A frame is a pure function of a lane's step within its episode ``t`` and
its episode seed: ``(rows*31 + cols*17 + chans*97 + t*13 + seed*7919) & 0xFF``
as uint8. An episode lasts ``int32(1 + -log1p(-u) * mean_len)`` steps; the
reward of an action ``a`` at step ``t`` is ``(seed + t) % 37 == a % 37 % 7``.
"""

import torch


class AtariSimReference:
    def __init__(self, n_actions: int, frame_shape, mean_episode_len: int, device):
        self.n_actions = n_actions
        self.frame_shape = tuple(frame_shape)
        self.mean_episode_len = mean_episode_len
        self.device = torch.device(device)
        h, w, c = self.frame_shape
        ar = lambda n: torch.arange(n, dtype=torch.int64, device=self.device)  # noqa: E731
        self.pattern = ar(h)[:, None, None] * 31 + ar(w)[None, :, None] * 17 + ar(c) * 97

    def frames(self, t: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        """uint8 ``[N, h, w, c]`` for int ``t [N]`` and ``seed [N]``."""
        shift = t.to(torch.int64) * 13 + seed.to(torch.int64) * 7919
        return ((self.pattern[None] + shift[:, None, None, None]) & 0xFF).to(torch.uint8)

    def reset(self, draws, n: int):
        """``(t, seed, ep_len)`` of ``n`` fresh episodes: the seeds' draw,
        then the lengths' uniform draw."""
        seed = draws.randint(1 << 20, n)
        u = draws.uniform(n)
        ep_len = (1.0 + -torch.log1p(-u) * self.mean_episode_len).to(torch.int32)
        return torch.zeros(n, dtype=torch.int32, device=self.device), seed, ep_len

    @staticmethod
    def step(t, seed, ep_len, actions):
        """``(t + 1, reward, terminated)`` of one step of every lane."""
        t1 = t + 1
        reward = (((seed + t1) % 37) == (actions.to(torch.int32) % 37 % 7)).to(torch.float32)
        return t1, reward, t1 >= ep_len
