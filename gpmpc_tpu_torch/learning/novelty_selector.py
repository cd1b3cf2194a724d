"""Novelty scoring and diverse data selection for GP training (counterpart
of ``gpmpc_tpu/learning/novelty_selector.py``): distance novelty
1 − e^(−d/τ) from a batched min-distance, GP-variance and residual-magnitude
novelty, their weighted blend, top-k and threshold selection, greedy
farthest-point diverse selection, and acquisition-driven selection."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.kmeans import farthest_point_sampling


@dataclass(frozen=True)
class NoveltyConfig:
    distance_scale: float = 1.0  # τ in 1 − exp(−d/τ)
    w_distance: float = 0.5
    w_variance: float = 0.3
    w_residual: float = 0.2
    threshold: float = 0.3


def distance_novelty(X_new, X_ref, ref_mask, tau) -> torch.Tensor:
    """1 − e^(−d_min/τ), d_min the distance from each row of X_new (n, d) to
    the nearest active row of X_ref; an empty reference makes everything
    novel."""
    d2 = ((X_new ** 2).sum(1)[:, None] + (X_ref ** 2).sum(1)[None, :]
          - 2.0 * X_new @ X_ref.T)
    d2 = torch.where(ref_mask[None, :], d2, torch.full_like(d2, float("inf")))
    d = torch.sqrt(d2.amin(1).clamp_min(0.0))
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, 1e3))
    return 1.0 - torch.exp(-d / tau)


def variance_novelty(variances, prior_variance) -> torch.Tensor:
    """σ²/σ²_prior clipped to [0, 1]."""
    prior = torch.as_tensor(prior_variance, dtype=variances.dtype, device=variances.device)
    return (variances / prior.clamp_min(1e-12)).clamp(0.0, 1.0)


def residual_novelty(residuals, scale) -> torch.Tensor:
    """‖r‖/scale clipped to [0, 1]."""
    s = torch.as_tensor(scale, dtype=residuals.dtype, device=residuals.device)
    return (torch.linalg.vector_norm(residuals, dim=-1) / s.clamp_min(1e-12)).clamp(0.0, 1.0)


def novelty_scores(config: NoveltyConfig, X_new, X_ref, ref_mask, variances=None,
                   residuals=None, prior_variance: float = 1.0,
                   residual_scale: float = 1.0) -> torch.Tensor:
    """Weighted blend of the three novelty signals (the variance one on the
    mean over outputs)."""
    s = config.w_distance * distance_novelty(X_new, X_ref, ref_mask, config.distance_scale)
    if variances is not None:
        v = variances.mean(-1) if variances.dim() > 1 else variances
        s = s + config.w_variance * variance_novelty(v, prior_variance)
    if residuals is not None:
        s = s + config.w_residual * residual_novelty(residuals, residual_scale)
    return s


def select_top_k(scores, k: int) -> torch.Tensor:
    """Indices of the k most novel points."""
    return torch.topk(scores, k).indices


def select_threshold_mask(scores, threshold) -> torch.Tensor:
    return scores >= threshold


def select_diverse(generator: Optional[torch.Generator], X, k: int, mask=None,
                   first: Optional[int] = None) -> torch.Tensor:
    """Greedy farthest-point diverse subset of k rows (the first drawn with
    ``generator``, or given)."""
    return farthest_point_sampling(X, k, mask, generator=generator, first=first)


class NoveltySelector:
    def __init__(self, config: Optional[NoveltyConfig] = None):
        self.config = config or NoveltyConfig()

    def scores(self, X_new, X_ref, ref_mask, **kw):
        return novelty_scores(self.config, X_new, X_ref, ref_mask, **kw)

    def select(self, scores, k: int):
        return select_top_k(scores, k)

    def select_above_threshold(self, scores):
        return select_threshold_mask(scores, self.config.threshold)


class ActiveDataSelector:
    """Acquisition-driven selection: ``"uncertainty"`` picks the points of
    largest variance; ``"ei"`` adds an exploitation bonus from the residual
    magnitude."""

    def __init__(self, strategy: str = "uncertainty", beta: float = 1.0):
        self.strategy = strategy
        self.beta = beta

    def acquire(self, k: int, variances, residuals=None) -> torch.Tensor:
        v = variances.mean(-1) if variances.dim() > 1 else variances
        if self.strategy == "uncertainty" or residuals is None:
            score = v
        elif self.strategy == "ei":
            score = (torch.sqrt(v.clamp_min(0.0)) * self.beta
                     + torch.linalg.vector_norm(residuals, dim=-1))
        else:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        return torch.topk(score, k).indices
