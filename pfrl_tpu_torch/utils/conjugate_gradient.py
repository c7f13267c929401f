"""Conjugate gradient with a fixed budget (counterpart of
``pfrl_tpu/utils/conjugate_gradient.py``), for TRPO's ``A x = b`` where ``A``
is the Fisher-vector product.

The JAX solver is a ``lax.fori_loop`` that freezes the iterate once the
residual is small; here the loop runs on the host for ``max_iter`` steps and
the iterate is frozen by ``torch.where`` once ``r.r < tol``. There is no
early exit: it would read the residual on the host and wait for the device.
"""

from typing import Callable

import torch


def conjugate_gradient(
    A_product_func: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    tol: float = 1e-10,
    max_iter: int = 10,
) -> torch.Tensor:
    x = torch.zeros_like(b)
    r = b - A_product_func(x)
    p = r
    rr = torch.dot(r, r)
    for _ in range(max_iter):
        ap = A_product_func(p)
        alpha = rr / (torch.dot(p, ap) + 1e-38)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        rr_new = torch.dot(r_new, r_new)
        beta = rr_new / (rr + 1e-38)
        p_new = r_new + beta * p
        done = rr < tol
        x = torch.where(done, x, x_new)
        r = torch.where(done, r, r_new)
        p = torch.where(done, p, p_new)
        rr = torch.where(done, rr, rr_new)
    return x
