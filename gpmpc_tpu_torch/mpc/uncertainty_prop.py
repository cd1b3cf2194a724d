"""Linear uncertainty propagation and box tightening, batch-first
(counterpart of the linear part of ``gpmpc_tpu/mpc/uncertainty_prop.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .constraints import normal_quantile


class PropagatedUncertainty(NamedTuple):
    means: torch.Tensor  # (B, N+1, n_x)
    covariances: torch.Tensor  # (B, N+1, n_x, n_x)


def gp_process_noise(gp_var: torch.Tensor, n_x: int, dt: float) -> torch.Tensor:
    """Q_GP = diag with GP variances ×dt² in the velocity slice [4:7] (and
    the rate slice [11:14] for 14 states); gp_var (..., n_gp) → (..., n_x, n_x)."""
    lead = gp_var.shape[:-1]
    parts = [gp_var.new_zeros(*lead, 4), gp_var[..., :3] * dt * dt]
    if n_x >= 14:
        parts += [gp_var.new_zeros(*lead, 4), gp_var[..., 3:6] * dt * dt]
    d = torch.cat(parts, dim=-1)
    if d.shape[-1] < n_x:
        d = torch.cat([d, gp_var.new_zeros(*lead, n_x - d.shape[-1])], dim=-1)
    return torch.diag_embed(d)


def propagate_linear(Aks, means, Sigma0, gp_vars: Optional[torch.Tensor] = None,
                     dt: float = 0.1) -> PropagatedUncertainty:
    """Σ_{k+1} = A_k Σ_k A_kᵀ + Q_GP,k per lane. Aks (B,N,n_x,n_x), means
    (B,N+1,n_x), Sigma0 (n_x,n_x) or (B,n_x,n_x), gp_vars (B,N,n_gp)."""
    Bsz, N, n_x, _ = Aks.shape
    if gp_vars is None:
        gp_vars = means.new_zeros(Bsz, N, 3 if n_x < 14 else 6)
    Qs = gp_process_noise(gp_vars, n_x, dt)
    S = torch.broadcast_to(Sigma0, (Bsz, n_x, n_x))
    Sigmas = [S]
    for k in range(N):
        A = Aks[:, k]
        S = A @ S @ A.transpose(1, 2) + Qs[:, k]
        Sigmas.append(S)
    return PropagatedUncertainty(means=means, covariances=torch.stack(Sigmas, dim=1))


def box_tightening(Sigmas: torch.Tensor, confidence: float = 0.95,
                   kappa: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-coordinate back-offs κ·σ_i for box bounds, (..., n_x).
    ``kappa`` overrides the Gaussian quantile."""
    if kappa is None:
        kappa = normal_quantile(torch.tensor(confidence, dtype=Sigmas.dtype,
                                             device=Sigmas.device))
    return kappa * torch.sqrt(torch.diagonal(Sigmas, dim1=-2, dim2=-1).clamp_min(0.0))
