"""Backup controllers, lanes first (counterpart of
``gpmpc_tpu/safety/backup_controller.py``): LQR about an equilibrium from the
discrete ARE (``ops.linalg.dlqr``) with the PD gain selected where the
Riccati recursion returns non-finite values (a select, no host read), the
canonical 3-DoF hover backup, a PD hold and emergency braking. ``control``
maps states (..., n_x) to controls (..., n_u)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch.func import jacfwd

from ..ops.linalg import dlqr

Tensor = torch.Tensor


@dataclass(frozen=True)
class LQRBackupController:
    """LQR about an equilibrium (x_eq, u_eq) with clamped feedback."""

    K: Tensor  # (n_u, n_x)
    P: Tensor  # (n_x, n_x) Riccati cost-to-go (the Lyapunov matrix)
    x_eq: Tensor
    u_eq: Tensor
    u_min: Tensor
    u_max: Tensor

    @classmethod
    def create(cls, linearize_fn: Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]],
               x_eq: Tensor, u_eq: Tensor, Q: Tensor, R: Tensor, u_min: Tensor, u_max: Tensor,
               fallback_K: Optional[Tensor] = None) -> "LQRBackupController":
        """``linearize_fn(x, u) → (A_d, B_d)`` at the equilibrium. Where the
        Riccati recursion gives non-finite values, ``fallback_K`` (default:
        :func:`pd_gain_matrix`) and P = Q are selected instead."""
        A, B = linearize_fn(x_eq, u_eq)
        K, P = dlqr(A, B, Q, R)
        ok = torch.isfinite(K).all() & torch.isfinite(P).all()
        if fallback_K is None:
            fallback_K = pd_gain_matrix(Q.shape[0], B.shape[1], device=K.device)
        return cls(K=torch.where(ok, K, fallback_K), P=torch.where(ok, P, Q), x_eq=x_eq,
                   u_eq=u_eq, u_min=u_min, u_max=u_max)

    def control(self, x: Tensor) -> Tensor:
        """Saturated u = u_eq − K(x − x_eq)."""
        u = self.u_eq - (x - self.x_eq) @ self.K.T
        return torch.minimum(torch.maximum(u, self.u_min), self.u_max)

    def lyapunov_value(self, x: Tensor) -> Tensor:
        e = x - self.x_eq
        return torch.einsum("...i,ij,...j->...", e, self.P, e)

    def rollout(self, step_fn: Callable, x0: Tensor, n_steps: int) -> Tensor:
        """Closed-loop backup rollout of x0 (..., n_x) → (..., n_steps+1, n_x)."""
        xs = [x0]
        for _ in range(n_steps):
            xs.append(step_fn(xs[-1], self.control(xs[-1])))
        return torch.stack(xs, dim=-2)


def pd_gain_matrix(n_x: int, n_u: int, kp: float = 2.0, kd: float = 3.0,
                   device=None) -> Tensor:
    """Hand-tuned PD gain in LQR-gain form: each thrust axis feeds back its
    position and velocity error."""
    K = torch.zeros(n_u, n_x, device=device)
    for i in range(min(n_u, 3)):
        K[i, 1 + i], K[i, 4 + i] = kp, kd
    return K


def hover_backup_3dof(params, altitude: float = 0.0, mass: Optional[float] = None,
                      Q: Optional[Tensor] = None, R: Optional[Tensor] = None,
                      dt: float = 0.1) -> LQRBackupController:
    """The canonical 3-DoF hover LQR backup (u_eq = −m·g), on the device of
    ``params``. The default Q puts 1e-4 on the mass coordinate so that the
    mass mode's unit eigenvalue does not make the ARE ill-posed."""
    from ..dynamics import rocket3dof as r3

    dev = params.device
    m = params.m_wet if mass is None else mass
    x_eq = torch.tensor([m, altitude, 0.0, 0.0, 0.0, 0.0, 0.0], device=dev)
    u_eq = -m * params.g_I
    Q = torch.diag(torch.tensor([1e-4, 10.0, 10.0, 10.0, 5.0, 5.0, 5.0], device=dev)) \
        if Q is None else Q
    R = torch.eye(3, device=dev) * 0.1 if R is None else R
    lin = lambda x, u: jacfwd(lambda xx, uu: r3.step(params, xx, uu, dt), argnums=(0, 1))(x, u)
    T = params.T_max
    return LQRBackupController.create(
        lin, x_eq, u_eq, Q, R, u_min=torch.tensor([params.T_min, -T, -T], device=dev),
        u_max=torch.tensor([T, T, T], device=dev))


@dataclass(frozen=True)
class PDBackupController:
    """Hand-tuned PD altitude and position hold."""

    x_eq: Tensor
    u_eq: Tensor
    kp_pos: float = 2.0
    kd_vel: float = 3.0
    u_min: Optional[Tensor] = None
    u_max: Optional[Tensor] = None

    def control(self, x: Tensor) -> Tensor:
        e_pos = x[..., 1:4] - self.x_eq[1:4]
        e_vel = x[..., 4:7] - self.x_eq[4:7]
        u = self.u_eq - self.kp_pos * e_pos - self.kd_vel * e_vel
        if self.u_min is not None:
            u = torch.minimum(torch.maximum(u, self.u_min), self.u_max)
        return u

    def lyapunov_value(self, x: Tensor) -> Tensor:
        return ((x[..., 1:7] - self.x_eq[1:7]) ** 2).sum(-1)


@dataclass(frozen=True)
class EmergencyBrakingController:
    """Maximum deceleration against the velocity, cancelling gravity as far
    as the thrust budget allows."""

    T_max: float
    g_I: Tensor

    def control(self, x: Tensor) -> Tensor:
        # the norms are guarded where they are taken, not only behind the
        # select: at v = 0 (a lane at rest, a frozen landed lane) the
        # derivative of ‖v‖ is 0/0 and would reach the filter's gradient as
        # NaN through the discarded branch
        v = x[..., 4:7]
        vsq = (v * v).sum(-1, keepdim=True)
        moving = vsq > 1e-12  # ‖v‖ > 1e-6
        vmag = torch.sqrt(torch.where(moving, vsq, torch.ones_like(vsq)))
        up = torch.cat([torch.ones_like(v[..., :1]), torch.zeros_like(v[..., 1:])], dim=-1)
        dir_ = torch.where(moving, -v / vmag, up)
        u = dir_ * self.T_max - x[..., 0:1] * self.g_I
        umag = torch.sqrt((u * u).sum(-1, keepdim=True).clamp_min(1e-12))
        return u * torch.clamp(self.T_max / umag, max=1.0)


def create_backup_controller(kind: str, **kw):
    """"lqr" (:func:`hover_backup_3dof`), "pd" or "braking"."""
    if kind == "lqr":
        return hover_backup_3dof(**kw)
    if kind == "pd":
        return PDBackupController(**kw)
    if kind == "braking":
        return EmergencyBrakingController(**kw)
    raise ValueError(f"unknown backup controller {kind!r}")
