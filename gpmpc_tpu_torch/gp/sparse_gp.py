"""Sparse (inducing-point) multi-output GPs, FITC and VFE (counterpart of the
multi-output part of ``gpmpc_tpu/gp/sparse_gp.py``).

The outputs share inducing inputs Z and training inputs X; every factor
carries a leading output axis, so the per-output ``vmap`` of the JAX code is
one batched call here. Training data is capacity-padded with a mask (masked
points get unit Λ and zero cross-covariance, which drops them from every
factor exactly). Factors are cached as explicit inverses of the Cholesky
factors, so prediction is matmuls only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.kmeans import kmeans
from ..ops.linalg import robust_cholesky
from .exact_gp import GPPrediction
from .kernels import SquaredExponentialARD


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _factors(kernel: SquaredExponentialARD, Z, X, Y, mask, log_noise, method: str):
    """FITC/VFE factors for every output: Y is (n_out, cap), log_noise
    (n_out,). Returns (Luu_inv, LB_inv, c)."""
    jitter = 1e-6
    M = Z.shape[0]
    mf = mask.to(X.dtype)
    noise = torch.exp(2.0 * log_noise)[:, None]
    eye = torch.eye(M, dtype=X.dtype, device=X.device)

    Kuu = kernel(Z, Z) + jitter * eye
    Kuf = kernel(Z, X) * mf
    kff = kernel.diagonal(X)

    # two jitter levels, as in the JAX package: healthy matrices take level
    # 0; degenerate ones jump straight to the big relative jitter
    Luu, _ = robust_cholesky(Kuu, jitters=(0.0, 1e-3))
    Luu_inv = _tri_inv(Luu)
    V = Luu_inv @ Kuf  # (o, M, cap)
    qff = (V * V).sum(-2)

    if method == "fitc":
        lam = (kff - qff).clamp_min(1e-8) + noise
    elif method == "vfe":
        lam = noise.expand_as(kff)
    else:
        raise ValueError(f"unknown sparse-GP method {method!r}")
    lam = torch.where(mask, lam, torch.ones_like(lam))

    A = V / torch.sqrt(lam)[:, None, :]
    Bm = eye + A @ A.transpose(-1, -2)
    # B ⪰ I by construction: one jitter level always works
    LB, _ = robust_cholesky(Bm, jitters=(0.0,))
    LB_inv = _tri_inv(LB)
    ym = (Y * mf) / torch.sqrt(lam)
    c = (LB_inv @ (A @ ym[:, :, None]))[:, :, 0]
    return Luu_inv, LB_inv, c


def init_inducing_points(X, n_inducing: int, mask=None,
                         generator: Optional[torch.Generator] = None,
                         init_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-means centroids as inducing points."""
    Z, _ = kmeans(X, n_inducing, mask=mask, generator=generator, init_idx=init_idx)
    return Z


@dataclass
class MultiOutputSparseGPState:
    kernels: SquaredExponentialARD  # stacked, leading axis n_out
    Z: torch.Tensor  # (M, d) shared inducing inputs
    X: torch.Tensor  # (cap, d) shared training inputs
    Y: torch.Tensor  # (n_out, cap)
    mask: torch.Tensor  # (cap,)
    log_noise: torch.Tensor  # (n_out,)
    method: str = "fitc"
    Luu_inv: Optional[torch.Tensor] = None  # (n_out, M, M)
    LB_inv: Optional[torch.Tensor] = None  # (n_out, M, M)
    c: Optional[torch.Tensor] = None  # (n_out, M)


def refit_sparse_multi(kernels, Z, X, YT, mask, log_noise, method: str = "fitc"
                       ) -> MultiOutputSparseGPState:
    Luu_inv, LB_inv, c = _factors(kernels, Z, X, YT, mask, log_noise, method)
    return MultiOutputSparseGPState(
        kernels=kernels, Z=Z, X=X, Y=YT, mask=mask, log_noise=log_noise,
        method=method, Luu_inv=Luu_inv, LB_inv=LB_inv, c=c,
    )


def fit_sparse_multi(kernels, X, Y, Z, noise: float = 1e-2, mask=None,
                     method: str = "fitc") -> MultiOutputSparseGPState:
    """``Y`` is (n, n_out); kernels stacked with leading axis n_out."""
    n_out = Y.shape[1]
    m = torch.ones(X.shape[0], dtype=torch.bool, device=X.device) if mask is None else mask
    ln = torch.full((n_out,), math.log(noise), dtype=X.dtype, device=X.device)
    return refit_sparse_multi(kernels, Z, X, Y.T.contiguous(), m, ln, method)


def predict_sparse_multi(state: MultiOutputSparseGPState, Xs: torch.Tensor) -> GPPrediction:
    """Posterior mean and variance (n_s, n_out) at Xs (n_s, d): O(M²) per
    point, v = Luu⁻¹k*, w = LB⁻¹v, as matmuls against the cached inverses."""
    Ksu = state.kernels(Xs, state.Z)  # (o, n_s, M)
    v = state.Luu_inv @ Ksu.transpose(-1, -2)  # (o, M, n_s)
    w = state.LB_inv @ v
    mean = (state.c[:, None, :] @ w)[:, 0]
    var = state.kernels.diagonal(Xs) - (v * v).sum(-2) + (w * w).sum(-2)
    return GPPrediction(mean=mean.T, variance=var.clamp_min(0.0).T)
