"""Policy protocol (counterpart of ``pfrl_tpu/policy.py``; reference parity:
pfrl/policy.py:7-17).

A policy is any module mapping observations to a
:class:`pfrl_tpu_torch.distributions.Distribution`.
"""


class Policy:
    def __call__(self, state):
        raise NotImplementedError
