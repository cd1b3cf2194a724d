"""Ruiz equilibration for batched QP data (counterpart of
``gpmpc_tpu/ops/qp/ruiz.py``; modified Ruiz, OSQP-style)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .types import QPData

_MIN_SCALE = 1e-4
_MAX_SCALE = 1e4


class Scaling(NamedTuple):
    D: torch.Tensor  # (B, n) primal variable scaling
    E: torch.Tensor  # (B, m) constraint scaling
    c: torch.Tensor  # (B,) cost scaling


def _safe_limit(s: torch.Tensor) -> torch.Tensor:
    return s.clamp(_MIN_SCALE, _MAX_SCALE)


def ruiz_equilibrate(data: QPData, iters: int = 10) -> tuple[QPData, Scaling]:
    """Return (scaled QPData, Scaling). Scaled problem per lane:

        P̄ = c·D P D,  q̄ = c·D q,  Ā = E A D,  l̄ = E l,  ū = E u

    Recover the unscaled solution with x = D x̄, y = c⁻¹ E ȳ.
    """
    P, q, A, l, u = data.P, data.q, data.A, data.l, data.u
    B, n, m = data.batch, data.n, data.m
    D = torch.ones(B, n, dtype=P.dtype, device=P.device)
    E = torch.ones(B, m, dtype=P.dtype, device=P.device)
    c = torch.ones(B, dtype=P.dtype, device=P.device)
    for _ in range(iters):
        # column ∞-norms of [[P],[A]] for D; row ∞-norms of A for E
        col_norm = torch.maximum(P.abs().amax(dim=-2), A.abs().amax(dim=-2))
        row_norm = A.abs().amax(dim=-1)
        d = _safe_limit(1.0 / torch.sqrt(col_norm.clamp_min(_MIN_SCALE)))
        e = _safe_limit(1.0 / torch.sqrt(row_norm.clamp_min(_MIN_SCALE)))
        P = d[:, :, None] * P * d[:, None, :]
        q = d * q
        A = e[:, :, None] * A * d[:, None, :]
        l = e * l
        u = e * u
        # cost scaling: mean column norm of P (plus |q|∞) toward 1
        p_norm = P.abs().amax(dim=-2).mean(dim=-1)
        gamma = _safe_limit(
            1.0 / torch.maximum(p_norm, q.abs().amax(dim=-1)).clamp_min(_MIN_SCALE)
        )
        P = gamma[:, None, None] * P
        q = gamma[:, None] * q
        D, E, c = D * d, E * e, c * gamma
    return QPData(P=P, q=q, A=A, l=l, u=u), Scaling(D=D, E=E, c=c)
