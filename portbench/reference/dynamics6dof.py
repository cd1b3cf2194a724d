"""6-DoF quaternion rigid-body powered descent (Szmuk's model), written
plainly from its equations.

State x = [m, r_I (3), v_I (3), q_BI (4, scalar first), ω_B (3)], control
u = thrust in the body frame (3); gravity g_I = (−1, 0, 0), body +x the long
axis:

    ṁ = −‖T_B‖ / (I_sp g₀)
    ṙ = v
    v̇ = C_IB(q) (T_B + F_A) / m + g_I
    q̇ = ½ [−ω·q_v ; q_w ω + ω × q_v]
    ω̇ = J⁻¹ (r_T × T_B + r_cp × F_A − ω × J ω)

with the aero force in the body frame F_A = −½ ρ S_ref C_A ‖v‖ v_B, v_B =
C_IB(q)ᵀ v (zero where ρ = 0). One step is classic RK4 with the control held
over it, then the quaternion divided by its norm.

Departures from the published model: ‖T‖ and ‖v‖ are smoothed by 1e-10
(√(‖·‖² + 1e-20)) so that the Jacobians stay finite at 0; C_A is diagonal
(the configurations use C_A = c·I); J is diagonal, so J⁻¹ is taken exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import jacfwd, vmap

from .prec import Prec

EPS = 1e-10


@dataclass(frozen=True)
class Rocket:
    """Szmuk's normalized units: m_dry 1, I_sp 30, g₀ 1, J = 0.168·diag(0.02,
    1, 1), thrust 0.25 behind the centre of mass, centre of pressure 0.05
    ahead of it; aero off unless ρ·S_ref·C_A > 0."""

    I_sp: float = 30.0
    g0: float = 1.0
    J_B: tuple = (0.168 * 0.02, 0.168, 0.168)  # the diagonal
    r_T_B: tuple = (-0.25, 0.0, 0.0)
    r_cp_B: tuple = (0.05, 0.0, 0.0)
    g_I: tuple = (-1.0, 0.0, 0.0)
    rho: float = 0.0
    S_ref: float = 1.0
    C_A: tuple = (0.0, 0.0, 0.0)  # the diagonal

    @property
    def alpha(self) -> float:
        return 1.0 / (self.I_sp * self.g0)


def dcm(q: torch.Tensor) -> torch.Tensor:
    """C_IB (…, 3, 3), body to inertial, of unit scalar-first quaternions."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rotate(C: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """C v, as sums of products."""
    return (C * v[..., None, :]).sum(-1)


def rotate_back(C: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cᵀ v, as sums of products."""
    return (C * v[..., :, None]).sum(-2)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def body_velocity(x: torch.Tensor) -> torch.Tensor:
    """v_B = C_IB(q)ᵀ v_I."""
    return rotate_back(dcm(x[..., 7:11]), x[..., 4:7])


def f(p: Rocket, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    vec = lambda t: torch.as_tensor(t, dtype=x.dtype, device=x.device)
    m, v, q, w = x[..., 0:1], x[..., 4:7], x[..., 7:11], x[..., 11:14]
    C = dcm(q)
    T = torch.sqrt((u * u).sum(-1, keepdim=True) + EPS**2)
    speed = torch.sqrt((v * v).sum(-1, keepdim=True) + EPS**2)
    F_A = -(0.5 * p.rho * p.S_ref) * vec(p.C_A) * rotate_back(C, v) * speed
    m_dot = -p.alpha * T
    v_dot = rotate(C, u + F_A) / m + vec(p.g_I)
    qw, qv = q[..., 0:1], q[..., 1:4]
    q_dot = 0.5 * torch.cat([-(w * qv).sum(-1, keepdim=True), qw * w + cross(w, qv)], -1)
    J = vec(p.J_B)
    torque = cross(vec(p.r_T_B), u) + cross(vec(p.r_cp_B), F_A)
    w_dot = (torque - cross(w, J * w)) / J
    return torch.cat([m_dot, v, v_dot, q_dot, w_dot], -1)


def normalize(x: torch.Tensor) -> torch.Tensor:
    q = x[..., 7:11]
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True))
    return torch.cat([x[..., :7], q, x[..., 11:]], -1)


def step(p: Rocket, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """One RK4 step, the quaternion renormalized after it."""
    k1 = f(p, x, u)
    k2 = f(p, x + 0.5 * dt * k1, u)
    k3 = f(p, x + 0.5 * dt * k2, u)
    k4 = f(p, x + dt * k3, u)
    return normalize(x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4))


def jacobians(P: Prec, p: Rocket, X: torch.Tensor, U: torch.Tensor, dt: float):
    """The step's Jacobians at every knot by forward-mode autodiff: X (B,
    N(+1), 14), U (B, N, 3) → A (B,N,14,14), B (B,N,14,3), c (B,N,14) with
    step(x, u) ≈ A x + B u + c."""
    Bsz, N = U.shape[:2]
    x, u = X[:, :N].reshape(Bsz * N, 14), U.reshape(Bsz * N, 3)
    A, B = vmap(jacfwd(lambda xk, uk: step(p, xk, uk, dt), argnums=(0, 1)))(x, u)
    c = step(p, x, u, dt) - P.mv(A, x) - P.mv(B, u)
    return A.reshape(Bsz, N, 14, 14), B.reshape(Bsz, N, 14, 3), c.reshape(Bsz, N, 14)
