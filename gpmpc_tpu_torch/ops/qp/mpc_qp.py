"""Decision-vector helpers of the sparse MPC layout z = [x₀,u₀,x₁,u₁,…,x_N]
(counterpart of the part of ``gpmpc_tpu/ops/qp/mpc_qp.py`` that the condensed
GP-MPC path touches). The sparse QP builder itself arrives with a later slice;
the condensed controllers raise ``NotImplementedError`` for
``condensed=False``."""

from __future__ import annotations

from typing import Tuple

import torch


def join_z(X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """(B,N+1,n_x), (B,N,n_u) → interleaved decision vectors (B, n_vars)."""
    Bsz, N, n_u = U.shape
    body = torch.cat([X[:, :-1], U], dim=2).reshape(Bsz, -1)
    return torch.cat([body, X[:, -1]], dim=1)


def split_z(z: torch.Tensor, N: int, n_x: int, n_u: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decision vectors (B, n_vars) → (X (B,N+1,n_x), U (B,N,n_u))."""
    Bsz = z.shape[0]
    body = z[:, : N * (n_x + n_u)].reshape(Bsz, N, n_x + n_u)
    X = torch.cat([body[:, :, :n_x], z[:, None, N * (n_x + n_u):]], dim=1)
    return X, body[:, :, n_x:]
