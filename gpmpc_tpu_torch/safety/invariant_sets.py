"""Invariant sets, lanes first (counterpart of
``gpmpc_tpu/safety/invariant_sets.py``): the ellipsoid S = {x : (x−x_eq)ᵀP(x−x_eq)
≤ α} from the LQR Riccati matrix, the soft-landing funnel, the maximal α by
a fixed-depth bisection over boundary samples (no host sync), the LQR tube
controller with its robust positive-invariant widths, polytopes and the
Lyapunov-equation invariant-set matrix. Every set evaluates states with any
leading axes."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def _quad(e: Tensor, P: Tensor) -> Tensor:
    return torch.einsum("...i,ij,...j->...", e, P, e)


def _unit_directions(generator: torch.Generator, n: int, d: int, like: Tensor) -> Tensor:
    dirs = torch.randn(n, d, generator=generator, device=generator.device,
                       dtype=like.dtype).to(like.device)
    return dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)


@dataclass(frozen=True)
class EllipsoidalInvariantSet:
    """S = {x : (x−x_eq)ᵀ P (x−x_eq) ≤ α}."""

    P: Tensor
    x_eq: Tensor
    alpha: Tensor

    def replace(self, **kw) -> "EllipsoidalInvariantSet":
        return replace(self, **kw)

    def value(self, x: Tensor) -> Tensor:
        return _quad(x - self.x_eq, self.P)

    def contains(self, x: Tensor) -> Tensor:
        return self.value(x) <= self.alpha

    def project(self, x: Tensor) -> Tensor:
        """Scale x radially onto the ellipsoid where it lies outside."""
        v = self.value(x)
        scale = torch.sqrt(self.alpha / v.clamp_min(1e-12))[..., None]
        return torch.where((v <= self.alpha)[..., None], x, self.x_eq + scale * (x - self.x_eq))

    def sample_boundary(self, generator: torch.Generator, n: int) -> Tensor:
        """n points of the α-level set along uniform directions drawn from
        ``generator``."""
        dirs = _unit_directions(generator, n, self.P.shape[0], self.P)
        s = torch.sqrt(self.alpha / _quad(dirs, self.P).clamp_min(1e-12))
        return self.x_eq + s[:, None] * dirs


@dataclass(frozen=True)
class DescentFunnelSet:
    """Soft-landing funnel S = {x : |v|² ≤ v_free² + slope·altitude}: the
    speed allowance shrinks to ``v_free`` at the ground. Under the
    emergency-braking backup it is invariant for slope ≤ 2·a_net·(|v|/|v_vert|),
    a_net = T_max/m − g. ``value`` is smooth (the filter linearizes it by
    autograd) and ``alpha`` = v_free². Altitude is x[1], velocity x[4:7]
    (3-DoF and 6-DoF alike)."""

    slope: float = 0.6
    v_free: float = 1.5

    @property
    def alpha(self) -> float:
        return self.v_free**2

    def value(self, x: Tensor) -> Tensor:
        return (x[..., 4:7] ** 2).sum(-1) - self.slope * x[..., 1].clamp_min(0.0)

    def contains(self, x: Tensor) -> Tensor:
        return self.value(x) <= self.alpha


def compute_from_lqr(P: Tensor, x_eq: Tensor, alpha: float = 1.0) -> EllipsoidalInvariantSet:
    """The ellipsoid of the LQR cost-to-go matrix P at level α."""
    return EllipsoidalInvariantSet(P=P, x_eq=x_eq,
                                   alpha=torch.tensor(alpha, dtype=P.dtype, device=P.device))


def compute_maximal_alpha(P: Tensor, x_eq: Tensor, constraint_fn: Callable[[Tensor], Tensor],
                          generator: torch.Generator, n_samples: int = 256,
                          alpha_max: float = 1e3, bisection_iters: int = 30) -> Tensor:
    """The largest α whose boundary samples all satisfy ``constraint_fn(x)
    ≤ 0``: a fixed-depth bisection on the device, no host sync.
    ``constraint_fn`` maps points (S, d) to values (S,) or (S, k); the
    sample directions come from ``generator``."""
    dirs = _unit_directions(generator, n_samples, P.shape[0], P)
    quad = _quad(dirs, P).clamp_min(1e-12)
    lo = torch.zeros((), dtype=P.dtype, device=P.device)
    hi = torch.full((), alpha_max, dtype=P.dtype, device=P.device)
    for _ in range(bisection_iters):
        mid = 0.5 * (lo + hi)
        pts = x_eq + torch.sqrt(mid / quad)[:, None] * dirs
        ok = (constraint_fn(pts) <= 0.0).all()
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


@dataclass(frozen=True)
class TubeController:
    """LQR tube gain and the robust positive-invariant widths Σ_k |A_cl|ᵏ w."""

    K: Tensor
    e_rpi: Tensor  # per-coordinate tube widths

    @classmethod
    def create(cls, A: Tensor, B: Tensor, K: Tensor, w: Tensor, terms: int = 50
               ) -> "TubeController":
        A_cl = (A - B @ K).abs()
        n = A.shape[-1]
        e = A.new_zeros(n)
        Ak = torch.eye(n, dtype=A.dtype, device=A.device)
        for _ in range(terms):
            e, Ak = e + Ak @ w, A_cl @ Ak
        return cls(K=K, e_rpi=e)

    def ancillary_control(self, x: Tensor, x_nom: Tensor, u_nom: Tensor) -> Tensor:
        return u_nom - (x - x_nom) @ self.K.T


@dataclass(frozen=True)
class PolytopeInvariantSet:
    """{x : H x ≤ h}."""

    H: Tensor
    h: Tensor

    def contains(self, x: Tensor) -> Tensor:
        return (x @ self.H.T <= self.h).all(-1)

    def margin(self, x: Tensor) -> Tensor:
        return (x @ self.H.T - self.h).amax(-1)


def compute_lmi_invariant_set(A_cl: Tensor, Q: Optional[Tensor] = None, iters: int = 200
                              ) -> Tensor:
    """The Lyapunov-equation invariant-set matrix: A_clᵀ P A_cl − P = −Q by
    the fixed-point series P = Σ (A_clᵀ)ᵏ Q A_clᵏ."""
    n = A_cl.shape[-1]
    eye = torch.eye(n, dtype=A_cl.dtype, device=A_cl.device)
    Q = eye if Q is None else Q
    P, Ak = torch.zeros_like(eye), eye
    for _ in range(iters):
        P, Ak = P + Ak.T @ Q @ Ak, A_cl @ Ak
    return P
