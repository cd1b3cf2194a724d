"""Sparse (inducing-point) multi-output GPs, FITC and VFE (counterpart of the
multi-output part of ``gpmpc_tpu/gp/sparse_gp.py``).

The outputs share inducing inputs Z and training inputs X; every factor
carries a leading output axis, so the per-output ``vmap`` of the JAX code is
one batched call here. Ahead of the output axis every array may carry one
more batch axis, the lane axis of the online controller, where each lane
holds its own GP (the JAX package's ``vmap`` over lanes): Z (B, M, d), X
(B, cap, d), Y (B, n_out, cap), mask (B, cap), the kernel parameters and
log_noise (B, n_out, ...), the factors (B, n_out, ...).

Training data is capacity-padded with a mask (masked points get unit Λ and
zero cross-covariance, which drops them from every factor exactly). Factors are cached as explicit inverses of the Cholesky
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
    """FITC/VFE factors for every output: Y is (..., n_out, cap), log_noise
    (..., n_out). Returns (Luu_inv, LB_inv, c, lam, qff, kff, ym); the last
    four (each (..., n_out, cap)) are what the marginal likelihood needs."""
    jitter = 1e-6
    M = Z.shape[-2]
    mf = mask.to(X.dtype)[..., None, :]  # (..., 1, cap) against the output axis
    noise = torch.exp(2.0 * log_noise)[..., None]
    eye = torch.eye(M, dtype=X.dtype, device=X.device)

    Kuu = kernel(Z, Z) + jitter * eye
    Kuf = kernel(Z, X) * mf[..., None, :, :]
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
    lam = torch.where(mask[..., None, :], lam, torch.ones_like(lam))

    A = V / torch.sqrt(lam)[..., None, :]
    Bm = eye + A @ A.transpose(-1, -2)
    # B ⪰ I holds in exact arithmetic only: where Z sits on stored points (the
    # online refit re-centres it on the latest ones), Λ falls to its floor,
    # AAᵀ dwarfs the identity and a plain f32 factorization can fail. The
    # JAX package factors B at one level and then carries a NaN factor; here
    # such a B takes the relative jitter Kuu takes. A B that factors plainly
    # takes level 0, as in the JAX package.
    LB, _ = robust_cholesky(Bm, jitters=(0.0, 1e-3))
    LB_inv = _tri_inv(LB)
    ym = (Y * mf) / torch.sqrt(lam)
    c = (LB_inv @ (A @ ym[..., None]))[..., 0]
    return Luu_inv, LB_inv, c, lam, qff, kff, ym


def sparse_lml(kernels, Z, X, Y, mask, log_noise, method: str = "fitc") -> torch.Tensor:
    """FITC marginal likelihood / VFE ELBO of every output, (n_out,): Y is
    (..., n_out, cap), the kernel parameters and log_noise carry the output
    axis (behind any lane axis). Differentiable in the kernel parameters,
    log_noise and Z."""
    _, LB_inv, c, lam, qff, kff, ym = _factors(kernels, Z, X, Y, mask, log_noise, method)
    n = mask.sum(-1)[..., None]
    mask = mask[..., None, :]
    quad = (ym * ym).sum(-1) - (c * c).sum(-1)
    # log|B| = −2 Σ log diag(LB⁻¹): the inverse of a triangular factor has
    # the reciprocal diagonal
    zero = torch.zeros_like(lam)
    logdet = (-2.0 * torch.log(torch.diagonal(LB_inv, dim1=-2, dim2=-1)).sum(-1)
              + torch.where(mask, torch.log(lam), zero).sum(-1))
    lml = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
    if method == "vfe":
        noise = torch.exp(2.0 * log_noise)
        lml = lml - 0.5 * torch.where(mask, kff - qff, zero).sum(-1) / noise
    return lml


def init_inducing_points(X, n_inducing: int, mask=None,
                         generator: Optional[torch.Generator] = None,
                         init_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-means centroids as inducing points."""
    Z, _ = kmeans(X, n_inducing, mask=mask, generator=generator, init_idx=init_idx)
    return Z


@dataclass
class MultiOutputSparseGPState:
    """One multi-output sparse GP, or one per lane: every field then carries
    the lane axis B first."""

    kernels: SquaredExponentialARD  # stacked, axis n_out: ([B,] n_out, ...)
    Z: torch.Tensor  # ([B,] M, d) shared inducing inputs
    X: torch.Tensor  # ([B,] cap, d) shared training inputs
    Y: torch.Tensor  # ([B,] n_out, cap)
    mask: torch.Tensor  # ([B,] cap)
    log_noise: torch.Tensor  # ([B,] n_out)
    method: str = "fitc"
    Luu_inv: Optional[torch.Tensor] = None  # ([B,] n_out, M, M)
    LB_inv: Optional[torch.Tensor] = None  # ([B,] n_out, M, M)
    c: Optional[torch.Tensor] = None  # ([B,] n_out, M)


def refit_sparse_multi(kernels, Z, X, YT, mask, log_noise, method: str = "fitc"
                       ) -> MultiOutputSparseGPState:
    Luu_inv, LB_inv, c, *_ = _factors(kernels, Z, X, YT, mask, log_noise, method)
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
    """Posterior mean and variance ([B,] n_s, n_out) at Xs ([B,] n_s, d), a
    lane's queries against the lane's GP: O(M²) per point, v = Luu⁻¹k*,
    w = LB⁻¹v, as matmuls against the cached inverses."""
    Ksu = state.kernels(Xs, state.Z)  # ([B,] o, n_s, M)
    v = state.Luu_inv @ Ksu.transpose(-1, -2)  # ([B,] o, M, n_s)
    w = state.LB_inv @ v
    mean = (state.c[..., None, :] @ w)[..., 0, :]
    var = state.kernels.diagonal(Xs) - (v * v).sum(-2) + (w * w).sum(-2)
    return GPPrediction(mean=mean.transpose(-1, -2),
                        variance=var.clamp_min(0.0).transpose(-1, -2))
