"""Local safe sets: weighted k-nearest-neighbour queries over the safe set
(counterpart of ``gpmpc_tpu/terminal/local_safe_set.py``), lanes first.

One query per lane: the (B, cap) weighted distance matrix is one f32 matmul
against the store (TF32 off), masked to the active and fuel-feasible rows,
and ``torch.topk`` takes each lane's K nearest. Exact ties in distance (the
frozen touchdown rows of a landed lane repeat one state) may be ordered
differently from XLA's top-k, which puts the lower index first; the tied
rows are then copies of one state with one Q-value.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import torch

from ..ops.linalg import weighted_sq_dists
from .safe_set import SafeSet

Tensor = torch.Tensor

_BIG = 1e30


def default_state_weights(n_x: int, device=None) -> Tensor:
    """Per-coordinate query weights: fuel 0.1, position 1.0, velocity 0.5,
    attitude 0.3, rate 0.2."""
    if n_x >= 14:
        w = [0.1] + [1.0] * 3 + [0.5] * 3 + [0.3] * 4 + [0.2] * 3
    else:
        w = [0.1] + [1.0] * 3 + [0.5] * 3
    return torch.tensor(w[:n_x], device=device)


@dataclass(frozen=True)
class LocalSafeSetConfig:
    """K = 10 neighbours (K_min 4, K_max 50 for the adaptive query)."""

    K: int = 10
    K_min: int = 4
    K_max: int = 50
    density_radius: float = 2.0
    interpolation: str = "idw"
    idw_power: float = 2.0

    def replace(self, **kw) -> "LocalSafeSetConfig":
        return replace(self, **kw)


class KNNResult(NamedTuple):
    indices: Tensor  # (B, K) into the flat safe-set rows
    distances: Tensor  # (B, K) weighted distances
    states: Tensor  # (B, K, n_x)
    q_values: Tensor  # (B, K)
    valid: Tensor  # (B, K) bool — False rows are padding

    def take(self, sel: Tensor) -> "KNNResult":
        """The rows ``sel`` (B, k) of every lane."""
        g = lambda t: torch.take_along_dim(t, sel if t.dim() == 2 else sel[..., None], dim=1)
        return KNNResult(*[g(t) for t in self])


def _weights(ss: SafeSet, weights: Optional[Tensor]) -> Tensor:
    if weights is None:
        return default_state_weights(ss.states.shape[1], ss.device)
    return torch.as_tensor(weights, dtype=ss.states.dtype, device=ss.device)


def knn_query(ss: SafeSet, x: Tensor, K: int, weights: Optional[Tensor] = None,
              fuel_available=None, fallback_unfiltered: bool = False) -> KNNResult:
    """Each lane's K nearest active rows to x (B, n_x) under the weighted
    distance, restricted to rows with fuel_required ≤ ``fuel_available``
    (scalar or (B,)). Infeasible and inactive rows get distance +inf and
    ``valid`` False.

    ``fallback_unfiltered``: a lane whose fuel filter leaves no row takes the
    unfiltered active rows instead (the LMPC endgame, where a lane about to
    touch down holds less fuel than every stored row requires)."""
    w = _weights(ss, weights)
    d2 = weighted_sq_dists(x, ss.states, w)  # (B, cap)
    if fuel_available is None:
        feas = ss.mask[None]
    else:
        fa = torch.as_tensor(fuel_available, dtype=ss.fuel_required.dtype, device=ss.device)
        fa = fa.expand(x.shape[0]) if fa.dim() == 0 else fa
        feas = ss.feasible_mask(fa)
        if fallback_unfiltered:
            feas = torch.where(ss.any_feasible(fa)[:, None], feas, ss.mask[None])
    d2 = torch.where(feas, d2, torch.full_like(d2, _BIG))
    neg, idx = torch.topk(-d2, K, dim=-1)
    return KNNResult(indices=idx, distances=torch.sqrt((-neg).clamp_min(0.0)),
                     states=ss.states[idx], q_values=ss.q_values[idx],
                     valid=-neg < _BIG * 0.5)


def adaptive_k(ss: SafeSet, x: Tensor, config: LocalSafeSetConfig,
               weights: Optional[Tensor] = None) -> Tensor:
    """Local density → K per lane: active rows within ``density_radius``,
    clipped to [K_min, K_max] ((B,) int; mask a K_max query with it)."""
    d2 = weighted_sq_dists(x, ss.states, _weights(ss, weights))
    inside = ss.mask[None] & (d2 <= config.density_radius ** 2)
    return inside.sum(-1).clamp(config.K_min, config.K_max)


def interpolate_q(result: KNNResult, x: Tensor, config: LocalSafeSetConfig,
                  k_effective: Optional[Tensor] = None) -> Tensor:
    """Q estimate per lane from its neighbours: 'nearest', 'idw' (inverse
    distance^p) or 'barycentric' (distance softmin)."""
    valid = result.valid
    if k_effective is not None:
        k_eff = torch.as_tensor(k_effective, device=valid.device)
        ar = torch.arange(valid.shape[-1], device=valid.device)
        valid = valid & (ar < (k_eff[..., None] if k_eff.dim() else k_eff))
    vf = valid.to(x.dtype)
    d = result.distances
    if config.interpolation == "nearest":
        i = torch.where(valid, d, torch.full_like(d, float("inf"))).argmin(-1, keepdim=True)
        return torch.take_along_dim(result.q_values, i, dim=-1)[..., 0]
    if config.interpolation == "idw":
        wgt = vf / d.clamp_min(1e-6) ** config.idw_power
    elif config.interpolation == "barycentric":
        dd = torch.where(valid, d, torch.full_like(d, _BIG))
        wgt = vf * torch.softmax(-dd / dd.amin(-1, keepdim=True).clamp_min(1e-6), dim=-1)
    else:
        raise ValueError(f"unknown interpolation {config.interpolation!r}")
    return (wgt * result.q_values).sum(-1) / wgt.sum(-1).clamp_min(1e-12)


class LocalSafeSet:
    """OO facade: holds the config and weights, delegates to the queries."""

    def __init__(self, config: Optional[LocalSafeSetConfig] = None,
                 weights: Optional[Tensor] = None):
        self.config = config or LocalSafeSetConfig()
        self.weights = weights

    def query(self, ss: SafeSet, x: Tensor, fuel_available=None) -> KNNResult:
        return knn_query(ss, x, self.config.K, self.weights, fuel_available)

    def query_adaptive(self, ss: SafeSet, x: Tensor, fuel_available=None):
        k_eff = adaptive_k(ss, x, self.config, self.weights)
        return knn_query(ss, x, self.config.K_max, self.weights, fuel_available), k_eff

    def q_value(self, ss: SafeSet, x: Tensor, fuel_available=None) -> Tensor:
        return interpolate_q(self.query(ss, x, fuel_available), x, self.config)


class MultiResolutionLocalSafeSet:
    """Several K levels blended by level weights."""

    def __init__(self, levels=(5, 15, 40), level_weights=None,
                 config: Optional[LocalSafeSetConfig] = None):
        self.levels = levels
        self.level_weights = level_weights or [1.0 / len(levels)] * len(levels)
        self.config = config or LocalSafeSetConfig()

    def q_value(self, ss: SafeSet, x: Tensor, fuel_available=None) -> Tensor:
        total = 0.0
        for K, lw in zip(self.levels, self.level_weights):
            total = total + lw * interpolate_q(knn_query(ss, x, K, None, fuel_available),
                                               x, self.config)
        return total
