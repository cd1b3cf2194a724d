"""Terminal Q-function approximators over the safe set (counterpart of
``gpmpc_tpu/terminal/q_function.py``), lanes first: inverse-distance KNN Q,
local weighted linear regression, a sparse-GP Q-function on the port's
sparse GP, the refit manager, and per-iteration Q^j for monotonicity
checks.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..gp.kernels import create_kernel
from ..gp.sparse_gp import SparseGPState, fit_sparse, init_inducing_points, predict_sparse
from .local_safe_set import knn_query
from .safe_set import SafeSet

Tensor = torch.Tensor


def idw_q(ss: SafeSet, x: Tensor, K: int = 10, power: float = 2.0,
          fuel_available=None) -> Tensor:
    """Inverse-distance-weighted KNN Q per lane, x (B, n_x) → (B,)."""
    res = knn_query(ss, x, K, None, fuel_available)
    w = res.valid.to(x.dtype) / res.distances.clamp_min(1e-6) ** power
    return (w * res.q_values).sum(-1) / w.sum(-1).clamp_min(1e-12)


def local_linear_q(ss: SafeSet, x: Tensor, K: int = 20, reg: float = 1e-4,
                   fuel_available=None) -> Tensor:
    """Locally weighted linear regression Q(x) ≈ [1, x − x_q]ᵀβ per lane with
    Gaussian distance weights and a ridge term; returns β₀, the value at the
    query point."""
    res = knn_query(ss, x, K, None, fuel_available)
    Bsz, n_x = x.shape
    vf = res.valid.to(x.dtype)
    zero = torch.zeros_like(res.distances)
    bw = torch.where(res.valid, res.distances, zero).mean(-1, keepdim=True).clamp_min(1e-3)
    w = vf * torch.exp(-0.5 * (res.distances / bw) ** 2)
    Phi = torch.cat([torch.ones(Bsz, K, 1, dtype=x.dtype, device=x.device),
                     res.states - x[:, None]], dim=-1)
    PhiT = Phi.transpose(-1, -2)
    G = PhiT @ (w[..., None] * Phi) + reg * torch.eye(n_x + 1, dtype=x.dtype, device=x.device)
    b = (PhiT @ (w * res.q_values)[..., None])[..., 0]
    return torch.linalg.solve(G, b)[:, 0]


@dataclass
class GPQFunction:
    """Sparse-GP Q-function over the safe set's active rows."""

    gp_state: Optional[SparseGPState] = None
    fitted: bool = False

    @classmethod
    def fit(cls, generator: Optional[torch.Generator], ss: SafeSet, n_inducing: int = 50,
            kernel: str = "se_ard") -> "GPQFunction":
        """Fit on the active rows: k-means inducing points (the start rows
        drawn with ``generator``), noise 1e-2."""
        k = create_kernel(kernel, ss.states.shape[1], device=ss.device)
        Z = init_inducing_points(ss.states, n_inducing, mask=ss.mask, generator=generator)
        y = torch.where(ss.mask, ss.q_values, torch.zeros_like(ss.q_values))
        return cls(gp_state=fit_sparse(k, ss.states, y, Z, noise=1e-2, mask=ss.mask),
                   fitted=True)

    def value(self, x: Tensor) -> Tensor:
        return predict_sparse(self.gp_state, x).mean

    def value_and_std(self, x: Tensor):
        pr = predict_sparse(self.gp_state, x)
        return pr.mean, torch.sqrt(pr.variance.clamp_min(0.0))


# name-parity aliases
InverseDistanceQFunction = idw_q
LocalLinearQFunction = local_linear_q


@dataclass
class QFunctionManager:
    """Q evaluation plus the periodic refit of the GP approximator:
    ``update`` returns an updated manager."""

    method: str = "idw"
    K: int = 10
    refit_every: int = 5
    updates_seen: int = 0
    gp_q: Optional[GPQFunction] = None

    def replace(self, **kw) -> "QFunctionManager":
        return replace(self, **kw)

    def value(self, ss: SafeSet, x: Tensor, fuel_available=None) -> Tensor:
        if self.method == "idw":
            return idw_q(ss, x, self.K, fuel_available=fuel_available)
        if self.method == "linear":
            return local_linear_q(ss, x, self.K, fuel_available=fuel_available)
        if self.method == "gp":
            if self.gp_q is None or not self.gp_q.fitted:
                return idw_q(ss, x, self.K, fuel_available=fuel_available)
            return self.gp_q.value(x)
        raise ValueError(f"unknown Q method {self.method!r}")

    def update(self, generator: Optional[torch.Generator], ss: SafeSet) -> "QFunctionManager":
        n = self.updates_seen + 1
        mgr = self.replace(updates_seen=n)
        if self.method == "gp" and n % self.refit_every == 0:
            mgr = mgr.replace(gp_q=GPQFunction.fit(generator, ss))
        return mgr


def iteration_q_values(ss: SafeSet, x: Tensor, n_iterations: int, K: int = 10) -> Tensor:
    """Q^j(x) for j < ``n_iterations``, (B, n_iterations): each estimate
    uses only the rows of iterations ≤ j."""
    out = []
    for j in range(n_iterations):
        allowed = ss.mask & (ss.iterations <= j)
        ss_j = ss.replace(traj_ids=torch.where(allowed, ss.traj_ids,
                                               torch.full_like(ss.traj_ids, -1)))
        out.append(idw_q(ss_j, x, K))
    return torch.stack(out, dim=-1)


IterativeQFunction = iteration_q_values
