"""Exact O(n³) GP regression with capacity-padded data (counterpart of
``gpmpc_tpu/gp/exact_gp.py``): Cholesky fit with jitter escalation, the log
marginal likelihood, posterior mean, variance and covariance, prior and
posterior sampling from a ``torch.Generator``, Adam hyperparameter fitting,
and independent multi-output GPs sharing their inputs.

Masked rows are replaced by identity rows in the Gram matrix, which the
Cholesky factorization maps to unit diagonal and zero off-diagonal entries,
so one padded shape serves any active count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..ops.linalg import robust_cholesky
from .kernels import stack_kernels  # noqa: F401  (the JAX module exports it)


class GPPrediction(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    covariance: Optional[torch.Tensor] = None

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.variance.clamp_min(0.0))


def adam_fit(loss_fn: Callable[[List[torch.Tensor]], torch.Tensor],
             leaves: List[torch.Tensor], steps: int, learning_rate: float
             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``steps`` Adam steps on the scalar ``loss_fn(leaves)``. Returns the
    final leaves and the loss of the last step (taken before its update)."""
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    opt = torch.optim.Adam(ps, lr=learning_rate)
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(ps)
        loss.backward()
        opt.step()
    return [p.detach() for p in ps], loss.detach()


def _solve_lower(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


@dataclass
class ExactGPState:
    """Fitted posterior: kernel, padded data, masked Cholesky factor, α = K⁻¹y."""

    kernel: object
    X: torch.Tensor  # (cap, d)
    y: torch.Tensor  # (cap,)
    mask: torch.Tensor  # (cap,) bool
    log_noise: torch.Tensor  # ()
    L: torch.Tensor  # (cap, cap)
    alpha: torch.Tensor  # (cap,)

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum()


def _masked_gram(kernel, X, mask, log_noise):
    """Gram matrix with masked rows and columns replaced by identity and the
    noise on the active diagonal."""
    K = kernel(X, X)
    mf = mask.to(K.dtype)
    diag = torch.where(mask, torch.exp(2.0 * log_noise), torch.ones_like(mf))
    return K * (mf[:, None] * mf[None, :]) + torch.diag(diag)


def _pad(X, y, mask, capacity: Optional[int]):
    """Rows (n, …) padded with zero, masked-off rows up to ``capacity``."""
    n = X.shape[0]
    m = torch.ones(n, dtype=torch.bool, device=X.device) if mask is None else mask
    if capacity is None or capacity <= n:
        return X, y, m
    pad = lambda t: torch.cat([t, t.new_zeros(capacity - n, *t.shape[1:])])
    return pad(X), pad(y), torch.cat([m, m.new_zeros(capacity - n)])


def fit(kernel, X, y, noise: float = 1e-2, mask=None, capacity: Optional[int] = None
        ) -> ExactGPState:
    """Gram, robust Cholesky and α on X (n, d), y (n,), padded to ``capacity``."""
    X, y, m = _pad(X, y, mask, capacity)
    log_noise = torch.tensor(math.log(noise), dtype=X.dtype, device=X.device)
    return refit(kernel, X, y * m.to(y.dtype), m, log_noise)


def refit(kernel, X, y, mask, log_noise) -> ExactGPState:
    """The factors for given padded data."""
    L, _ = robust_cholesky(_masked_gram(kernel, X, mask, log_noise))
    alpha = torch.cholesky_solve((y * mask.to(y.dtype))[:, None], L)[:, 0]
    return ExactGPState(kernel=kernel, X=X, y=y, mask=mask, log_noise=log_noise, L=L,
                        alpha=alpha)


def log_marginal_likelihood(kernel, X, y, mask, log_noise) -> torch.Tensor:
    """log p(y|X,θ) over the active rows (masked identity rows add zero)."""
    L, _ = robust_cholesky(_masked_gram(kernel, X, mask, log_noise))
    z = _solve_lower(L, (y * mask.to(y.dtype))[:, None])[:, 0]
    logdet = 2.0 * torch.where(mask, torch.log(torch.diagonal(L)), torch.zeros_like(z)).sum()
    return -0.5 * (z * z).sum() - 0.5 * logdet - 0.5 * mask.sum() * math.log(2.0 * math.pi)


def predict(state: ExactGPState, Xs, full_cov: bool = False) -> GPPrediction:
    """Posterior mean and variance (n_s,) at Xs (n_s, d), with the covariance
    (n_s, n_s) when ``full_cov``."""
    Ks = state.kernel(Xs, state.X) * state.mask.to(Xs.dtype)[None, :]
    mean = Ks @ state.alpha
    V = _solve_lower(state.L, Ks.T)
    if full_cov:
        cov = state.kernel(Xs, Xs) - V.T @ V
        return GPPrediction(mean=mean, variance=torch.diagonal(cov).clamp_min(0.0),
                            covariance=cov)
    var = state.kernel.diagonal(Xs) - (V * V).sum(0)
    return GPPrediction(mean=mean, variance=var.clamp_min(0.0))


def predict_one(state: ExactGPState, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar posterior mean and variance at one point x (d,)."""
    pr = predict(state, x[None])
    return pr.mean[0], pr.variance[0]


def _normal(generator: Optional[torch.Generator], shape, like: torch.Tensor):
    gdev = like.device if generator is None else generator.device
    return torch.randn(shape, generator=generator, device=gdev).to(like.device, like.dtype)


def sample_prior(kernel, generator: Optional[torch.Generator], Xs, n_samples: int = 1
                 ) -> torch.Tensor:
    """(n_samples, n_s) prior function draws at Xs."""
    K = kernel(Xs, Xs)
    L, _ = robust_cholesky(K)
    return _normal(generator, (n_samples, Xs.shape[0]), K) @ L.T


def sample_posterior(state: ExactGPState, generator: Optional[torch.Generator], Xs,
                     n_samples: int = 1) -> torch.Tensor:
    """(n_samples, n_s) posterior function draws at Xs."""
    pr = predict(state, Xs, full_cov=True)
    L, _ = robust_cholesky(pr.covariance)
    return pr.mean[None, :] + _normal(generator, (n_samples, Xs.shape[0]), L) @ L.T


def optimize_hyperparameters(kernel, X, y, mask=None, log_noise=None, steps: int = 200,
                             learning_rate: float = 0.05, optimize_noise: bool = True):
    """Maximum likelihood by Adam on (kernel, log_noise). Returns (kernel,
    log_noise, the negative LML of the last step)."""
    m = torch.ones(X.shape[0], dtype=torch.bool, device=X.device) if mask is None else mask
    ln = (torch.tensor(math.log(1e-2), dtype=X.dtype, device=X.device)
          if log_noise is None else log_noise)
    n_k = len(kernel.params())

    def nll(leaves):
        ln_eff = leaves[n_k] if optimize_noise else leaves[n_k].detach()
        return -log_marginal_likelihood(kernel.with_params(leaves[:n_k]), X, y, m, ln_eff)

    leaves, last = adam_fit(nll, kernel.params() + [ln], steps, learning_rate)
    return kernel.with_params(leaves[:n_k]), leaves[n_k], last


@dataclass
class MultiOutputExactGPState:
    """Independent GPs per output on shared inputs: the kernel parameters,
    Y, L and α carry a leading output axis."""

    kernels: object
    X: torch.Tensor  # (cap, d)
    Y: torch.Tensor  # (n_out, cap)
    mask: torch.Tensor  # (cap,)
    log_noise: torch.Tensor  # (n_out,)
    L: torch.Tensor  # (n_out, cap, cap)
    alpha: torch.Tensor  # (n_out, cap)

    @property
    def n_outputs(self) -> int:
        return self.Y.shape[0]


def fit_multi(kernels, X, Y, noise: float = 1e-2, mask=None,
              capacity: Optional[int] = None) -> MultiOutputExactGPState:
    """``kernels`` stacked along the output axis (:func:`stack_kernels`);
    ``Y`` is (n, n_out)."""
    X, Y, m = _pad(X, Y, mask, capacity)
    ln = torch.full((Y.shape[1],), math.log(noise), dtype=X.dtype, device=X.device)
    return refit_multi(kernels, X, Y.T.contiguous(), m, ln)


def refit_multi(kernels, X, YT, mask, log_noise) -> MultiOutputExactGPState:
    mf = mask.to(X.dtype)
    K = kernels(X, X) * (mf[:, None] * mf[None, :])
    diag = torch.where(mask, torch.exp(2.0 * log_noise)[:, None], torch.ones_like(mf))
    L, _ = robust_cholesky(K + torch.diag_embed(diag))
    alpha = torch.cholesky_solve((YT * mf)[..., None], L)[..., 0]
    return MultiOutputExactGPState(kernels=kernels, X=X, Y=YT, mask=mask,
                                   log_noise=log_noise, L=L, alpha=alpha)


def predict_multi(state: MultiOutputExactGPState, Xs) -> GPPrediction:
    """(n_s, n_out) posterior mean and variance."""
    Ks = state.kernels(Xs, state.X) * state.mask.to(Xs.dtype)  # (o, n_s, cap)
    mean = (Ks @ state.alpha[..., None])[..., 0]
    V = _solve_lower(state.L, Ks.transpose(-1, -2))
    var = state.kernels.diagonal(Xs) - (V * V).sum(-2)
    return GPPrediction(mean=mean.T, variance=var.clamp_min(0.0).T)
