"""Predict-only GP states with precomputed factors (counterpart of
``gpmpc_tpu/gp/fast_gp.py``): the exact predictor (Cholesky factor and
α = K⁻¹y), an ε-ball query cache with hit statistics carried as state, and
the sparse (FITC/VFE) predictor on cached triangular inverses."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..ops.linalg import robust_cholesky


@dataclass
class FastGPPredictor:
    """Training inputs, α and the Cholesky factor of the noisy Gram matrix."""

    kernel: object
    X: torch.Tensor  # (n, d)
    alpha: torch.Tensor  # (n,)
    L: torch.Tensor  # (n, n)
    mask: torch.Tensor  # (n,)

    @classmethod
    def from_data(cls, kernel, X, y, noise: float = 1e-2, mask=None) -> "FastGPPredictor":
        m = torch.ones(X.shape[0], dtype=torch.bool, device=X.device) if mask is None else mask
        mf = m.to(X.dtype)
        K = kernel(X, X) * (mf[:, None] * mf[None, :]) + torch.diag(
            torch.where(m, torch.full_like(mf, noise), torch.ones_like(mf)))
        L, _ = robust_cholesky(K)
        alpha = torch.cholesky_solve((y * mf)[:, None], L)[:, 0]
        return cls(kernel=kernel, X=X, alpha=alpha, L=L, mask=m)

    def _cross(self, Xq):
        return self.kernel(Xq, self.X) * self.mask.to(Xq.dtype)[None, :]

    def predict_mean(self, x) -> torch.Tensor:
        return self._cross(x[None])[0] @ self.alpha

    def predict_batch(self, X) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance (n_q,) at X (n_q, d)."""
        Ks = self._cross(X)
        V = torch.linalg.solve_triangular(self.L, Ks.T, upper=False)
        var = self.kernel.diagonal(X) - (V * V).sum(0)
        return Ks @ self.alpha, var.clamp_min(0.0)

    def predict(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, var = self.predict_batch(x[None])
        return mean[0], var[0]


@dataclass
class CachedGPPredictor:
    """Returns the cached value when a query lies within ``cache_radius`` of
    the last cached query; the cache and its hit counts ride in the state,
    so ``predict`` returns a new predictor."""

    predictor: object
    cache_radius: float = 1e-3
    cached_x: Optional[torch.Tensor] = None
    cached_mean: Optional[torch.Tensor] = None
    cached_var: Optional[torch.Tensor] = None
    hits: Optional[torch.Tensor] = None
    misses: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, predictor, cache_radius: float = 1e-3) -> "CachedGPPredictor":
        X = predictor.X
        zero = lambda dt: torch.zeros((), dtype=dt, device=X.device)
        return cls(predictor=predictor, cache_radius=cache_radius,
                   cached_x=torch.full((X.shape[1],), float("inf"), device=X.device),
                   cached_mean=zero(X.dtype), cached_var=zero(X.dtype),
                   hits=zero(torch.int32), misses=zero(torch.int32))

    def predict(self, x) -> Tuple[torch.Tensor, torch.Tensor, "CachedGPPredictor"]:
        hit = torch.linalg.vector_norm(x - self.cached_x) < self.cache_radius
        mean_new, var_new = self.predictor.predict(x)
        mean = torch.where(hit, self.cached_mean, mean_new)
        var = torch.where(hit, self.cached_var, var_new)
        return mean, var, replace(
            self, cached_x=torch.where(hit, self.cached_x, x), cached_mean=mean,
            cached_var=var, hits=self.hits + hit.to(torch.int32),
            misses=self.misses + (~hit).to(torch.int32))

    def hit_rate(self) -> torch.Tensor:
        return self.hits / (self.hits + self.misses).clamp_min(1)


@dataclass
class SparseGPPredictor:
    """The factors of a fitted single-output sparse GP, predict only."""

    kernel: object
    Z: torch.Tensor  # (M, d)
    Luu_inv: torch.Tensor
    LB_inv: torch.Tensor
    c: torch.Tensor

    @classmethod
    def from_sparse_state(cls, state) -> "SparseGPPredictor":
        return cls(kernel=state.kernel, Z=state.Z, Luu_inv=state.Luu_inv,
                   LB_inv=state.LB_inv, c=state.c)

    def predict_batch(self, X) -> Tuple[torch.Tensor, torch.Tensor]:
        v = self.Luu_inv @ self.kernel(X, self.Z).T
        w = self.LB_inv @ v
        var = self.kernel.diagonal(X) - (v * v).sum(0) + (w * w).sum(0)
        return w.T @ self.c, var.clamp_min(0.0)

    def predict(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, var = self.predict_batch(x[None])
        return mean[0], var[0]


def create_fast_gp(kernel, X, y, noise: float = 1e-2, sparse_state=None):
    """The sparse predictor of a fitted sparse state when one is given, else
    the exact one fitted on (X, y)."""
    if sparse_state is not None:
        return SparseGPPredictor.from_sparse_state(sparse_state)
    return FastGPPredictor.from_data(kernel, X, y, noise)
