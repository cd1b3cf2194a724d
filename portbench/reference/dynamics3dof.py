"""3-DoF point-mass powered descent, written plainly from its equations.

State x = [m, r (3), v (3)], control u = thrust (3), gravity along −r₁:

    ṁ = −‖T‖ / (I_sp g₀),   ṙ = v,   v̇ = T/m + g − ½ρ C_D A_ref ‖v‖ v / m

(‖·‖ smoothed by 1e-10 so that the Jacobians stay finite at 0), stepped by
classic RK4 with the control held over the step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import jacfwd, vmap

from .prec import Prec

EPS = 1e-10


@dataclass(frozen=True)
class Rocket:
    """The normalized units of the configurations: m_wet 2, m_dry 1, I_sp
    30, g₀ 1, ‖T‖ ≤ 6.5, g = (−1, 0, 0); drag off unless rho·C_D·A_ref > 0."""

    I_sp: float = 30.0
    g0: float = 1.0
    T_min: float = 0.0
    T_max: float = 6.5
    m_dry: float = 1.0
    rho: float = 0.0
    C_D: float = 0.0
    A_ref: float = 0.0

    @property
    def alpha(self) -> float:
        return 1.0 / (self.I_sp * self.g0)

    @property
    def drag(self) -> float:
        return 0.5 * self.rho * self.C_D * self.A_ref


def f(p: Rocket, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    m, v = x[..., 0:1], x[..., 4:7]
    T = torch.sqrt((u * u).sum(-1, keepdim=True) + EPS**2)
    speed = torch.sqrt((v * v).sum(-1, keepdim=True) + EPS**2)
    g = torch.zeros_like(v)
    g = torch.cat([g[..., :1] - 1.0, g[..., 1:]], dim=-1)
    a = u / m + g - p.drag * speed * v / m
    return torch.cat([-p.alpha * T, v, a], dim=-1)


def step(p: Rocket, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One RK4 step; dt a number or a tensor broadcasting against x."""
    k1 = f(p, x, u)
    k2 = f(p, x + 0.5 * dt * k1, u)
    k3 = f(p, x + 0.5 * dt * k2, u)
    k4 = f(p, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rollout(p: Rocket, x0: torch.Tensor, U: torch.Tensor, dt) -> torch.Tensor:
    """x0 (B, 7), U (B, N, 3), dt a number or (B, 1) → X (B, N+1, 7)."""
    xs = [x0]
    for k in range(U.shape[1]):
        xs.append(step(p, xs[-1], U[:, k], dt))
    return torch.stack(xs, dim=1)


def jacobians(P: Prec, p: Rocket, X: torch.Tensor, U: torch.Tensor, dt=None):
    """The discrete step's Jacobians at every knot: X (B, N(+1), 7), U (B, N,
    3), dt a number or (B,) → A (B,N,7,7), B (B,N,7,3), c (B,N,7) with
    step(x, u) ≈ A x + B u + c."""
    Bsz, N = U.shape[:2]
    X = X[:, :N]
    x, u = X.reshape(Bsz * N, 7), U.reshape(Bsz * N, 3)
    if dt is None or not torch.is_tensor(dt):
        h = torch.full((Bsz * N,), float(dt if dt is not None else 0.1), dtype=x.dtype,
                       device=x.device)
    else:
        h = dt.to(x.dtype).repeat_interleave(N)
    one = lambda xk, uk, hk: step(p, xk, uk, hk)
    A, B = vmap(jacfwd(one, argnums=(0, 1)))(x, u, h)
    Fx = step(p, x, u, h[:, None])
    c = Fx - P.mv(A, x) - P.mv(B, u)
    return A.reshape(Bsz, N, 7, 7), B.reshape(Bsz, N, 7, 3), c.reshape(Bsz, N, 7)


def clamp_thrust(p: Rocket, u: torch.Tensor) -> torch.Tensor:
    """‖u‖ clamped into [T_min, T_max], its direction kept."""
    T = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    up = torch.zeros_like(u)
    up[..., 0] = 1.0
    d = torch.where(T > 1e-10, u / T.clamp_min(1e-10), up)
    return d * T.clamp(p.T_min, p.T_max)
