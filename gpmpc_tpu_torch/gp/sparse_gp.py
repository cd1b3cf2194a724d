"""Sparse (inducing-point) GPs, FITC and VFE (counterpart of
``gpmpc_tpu/gp/sparse_gp.py``): the single-output state with its fit, refit,
prediction, ring-buffer update and Adam hyperparameter fit, and the
multi-output state.

The outputs of a multi-output GP share inducing inputs Z and training inputs X; every factor
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
from .exact_gp import GPPrediction, _pad, adam_fit


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _factors(kernel, Z, X, Y, mask, log_noise, method: str):
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
    """FITC marginal likelihood / VFE ELBO of every output, ([B,] n_out): Y is
    ([B,] n_out, cap), the kernel parameters and log_noise carry the output
    axis (behind any lane axis). One output (Y (cap,), an unstacked kernel, a
    scalar log_noise) gives a scalar. Differentiable in the kernel
    parameters, log_noise and Z."""
    if Y.dim() == 1:
        return sparse_lml(_one_output(kernels), Z, X, Y[None], mask, log_noise[None], method)[0]
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
    """k-means centroids as inducing points: X ([B,] cap, d) → ([B,] M, d),
    one k-means per lane (see :func:`~gpmpc_tpu_torch.ops.kmeans.kmeans`)."""
    Z, _ = kmeans(X, n_inducing, mask=mask, generator=generator, init_idx=init_idx)
    return Z


def _one_output(kernel):
    """A single kernel seen as a stack of one output."""
    return kernel.map_params(lambda p: p[None])


@dataclass
class SparseGPState:
    """One single-output sparse GP: Z (M, d), padded X (cap, d), y (cap,),
    mask (cap,), scalar log_noise, and the cached triangular inverses."""

    kernel: object
    Z: torch.Tensor
    X: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    log_noise: torch.Tensor
    method: str = "fitc"
    Luu_inv: Optional[torch.Tensor] = None  # (M, M)
    LB_inv: Optional[torch.Tensor] = None  # (M, M)
    c: Optional[torch.Tensor] = None  # (M,)

    @property
    def n_inducing(self) -> int:
        return self.Z.shape[0]

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum()


def refit_sparse(kernel, Z, X, y, mask, log_noise, method: str = "fitc") -> SparseGPState:
    Luu_inv, LB_inv, c, *_ = _factors(_one_output(kernel), Z, X, y[None], mask,
                                      log_noise[None], method)
    return SparseGPState(kernel=kernel, Z=Z, X=X, y=y, mask=mask, log_noise=log_noise,
                         method=method, Luu_inv=Luu_inv[0], LB_inv=LB_inv[0], c=c[0])


def fit_sparse(kernel, X, y, Z, noise: float = 1e-2, mask=None,
               capacity: Optional[int] = None, method: str = "fitc") -> SparseGPState:
    """Fit on X (n, d), y (n,), padded with masked rows to ``capacity``."""
    X, y, m = _pad(X, y, mask, capacity)
    log_noise = torch.tensor(math.log(noise), dtype=X.dtype, device=X.device)
    return refit_sparse(kernel, Z, X, y, m, log_noise, method)


def predict_sparse(state: SparseGPState, Xs: torch.Tensor) -> GPPrediction:
    """Posterior mean and variance (n_s,) at Xs (n_s, d): O(M²) per point
    as matmuls against the cached inverses."""
    Ksu = state.kernel(Xs, state.Z)
    v = state.Luu_inv @ Ksu.T
    w = state.LB_inv @ v
    var = state.kernel.diagonal(Xs) - (v * v).sum(0) + (w * w).sum(0)
    return GPPrediction(mean=w.T @ state.c, variance=var.clamp_min(0.0))


def _ring_slots(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The k slots after the active count, wrapping (the oldest rows are
    overwritten once the store is full)."""
    return (mask.sum() + torch.arange(k, device=mask.device)) % mask.shape[0]


def update_sparse(state: SparseGPState, X_new, y_new) -> SparseGPState:
    """Write X_new (k, d), y_new (k,) into the store, then refit."""
    idx = _ring_slots(state.mask, X_new.shape[0])
    X, y, mask = state.X.clone(), state.y.clone(), state.mask.clone()
    X[idx], y[idx], mask[idx] = X_new, y_new, True
    return refit_sparse(state.kernel, state.Z, X, y, mask, state.log_noise, state.method)


def optimize_sparse_hyperparameters(kernel, Z, X, y, mask, log_noise, steps: int = 200,
                                    learning_rate: float = 0.05,
                                    optimize_inducing: bool = False, method: str = "fitc"):
    """Adam on (kernel, log_noise[, Z]) against the negative FITC/VFE
    objective. Returns (kernel, log_noise, Z, the loss at the last step)."""
    n_k = len(kernel.params())

    def loss(leaves):
        zz = leaves[-1] if optimize_inducing else Z
        return -sparse_lml(kernel.with_params(leaves[:n_k]), zz, X, y, mask,
                                  leaves[n_k], method)

    leaves = kernel.params() + [log_noise] + ([Z] if optimize_inducing else [])
    leaves, last = adam_fit(loss, leaves, steps, learning_rate)
    return (kernel.with_params(leaves[:n_k]), leaves[n_k],
            leaves[-1] if optimize_inducing else Z, last)


@dataclass
class MultiOutputSparseGPState:
    """One multi-output sparse GP, or one per lane: every field then carries
    the lane axis B first."""

    kernels: object  # stacked, axis n_out: ([B,] n_out, ...)
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
                     capacity: Optional[int] = None, method: str = "fitc"
                     ) -> MultiOutputSparseGPState:
    """``Y`` is ([B,] n, n_out); kernels stacked with leading axis n_out
    (behind the lane axis of a GP per lane). ``capacity`` pads one GP's
    rows."""
    if X.dim() == 2:
        X, Y, mask = _pad(X, Y, mask, capacity)
    n_out = Y.shape[-1]
    m = torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device) if mask is None else mask
    ln = torch.full((*X.shape[:-2], n_out), math.log(noise), dtype=X.dtype, device=X.device)
    return refit_sparse_multi(kernels, Z, X, Y.transpose(-1, -2).contiguous(), m, ln, method)


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


def update_sparse_multi(state: MultiOutputSparseGPState, X_new, Y_new
                        ) -> MultiOutputSparseGPState:
    """Write X_new (k, d), Y_new (k, n_out) into the store, then refit."""
    idx = _ring_slots(state.mask, X_new.shape[0])
    X, Y, mask = state.X.clone(), state.Y.clone(), state.mask.clone()
    X[idx], mask[idx] = X_new, True
    Y[:, idx] = Y_new.T
    return refit_sparse_multi(state.kernels, state.Z, X, Y, mask, state.log_noise, state.method)
