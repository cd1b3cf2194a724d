"""Batched affine models along trajectories (counterpart of
``gpmpc_tpu/dynamics/linearize.py::trajectory_jacobians``)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jacfwd, vmap


def trajectory_jacobians(F: Callable, X: torch.Tensor, U: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact forward-mode Jacobians of the discrete step ``F(x, u)`` at every
    knot of a batch of trajectories. X is (B, N+1, n_x) or (B, N, n_x),
    U is (B, N, n_u); returns A (B,N,n_x,n_x), B (B,N,n_x,n_u) and
    c (B,N,n_x) with F(x,u) ≈ A x + B u + c. ``F`` must take unbatched
    vectors and use no in-place ops (``torch.func`` vmaps it over the B·N
    knots)."""
    if X.shape[1] == U.shape[1] + 1:
        X = X[:, :-1]
    Bsz, N, n_x = X.shape
    n_u = U.shape[-1]
    x = X.reshape(Bsz * N, n_x)
    u = U.reshape(Bsz * N, n_u)

    def one(xk, uk):
        Ak, Bk = jacfwd(F, argnums=(0, 1))(xk, uk)
        return Ak, Bk, F(xk, uk) - Ak @ xk - Bk @ uk

    A, Bm, c = vmap(one)(x, u)
    return (A.reshape(Bsz, N, n_x, n_x), Bm.reshape(Bsz, N, n_x, n_u),
            c.reshape(Bsz, N, n_x))
