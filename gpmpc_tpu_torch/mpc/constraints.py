"""Constraint parameters, batched evaluators and chance-constraint
tightening (counterpart of ``gpmpc_tpu/mpc/constraints.py``). Every
evaluator takes states and controls with any leading axes (lanes first)."""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch.func import jacfwd, vmap

Tensor = torch.Tensor


@dataclass(frozen=True)
class ConstraintParams:
    """The rocket-landing constraint set, angles in radians (field names and
    defaults are those of the JAX ``ConstraintParams``; :meth:`from_degrees`
    converts)."""

    T_min: float = 0.5
    T_max: float = 5.0
    delta_max: float = math.radians(20.0)
    theta_max: float = math.radians(90.0)
    gamma_gs: float = math.radians(30.0)
    omega_max: float = math.radians(60.0)
    v_max: float = 50.0
    # terminal tolerances
    r_tol: float = 0.1
    v_tol: float = 0.1
    q_tol: float = math.radians(5.0)
    omega_tol: float = math.radians(1.0)

    @classmethod
    def from_degrees(cls, delta_max: float = 20.0, theta_max: float = 90.0,
                     gamma_gs: float = 30.0, omega_max: float = 60.0, q_tol: float = 5.0,
                     omega_tol: float = 1.0, **kw) -> "ConstraintParams":
        return cls(delta_max=math.radians(delta_max), theta_max=math.radians(theta_max),
                   gamma_gs=math.radians(gamma_gs), omega_max=math.radians(omega_max),
                   q_tol=math.radians(q_tol), omega_tol=math.radians(omega_tol), **kw)


def eval_thrust_magnitude(u: Tensor) -> Tensor:
    return torch.linalg.vector_norm(u, dim=-1)


def eval_gimbal_angle(u: Tensor) -> Tensor:
    """Angle between the thrust and the body long axis (+x)."""
    T = torch.linalg.vector_norm(u, dim=-1)
    return torch.arccos((u[..., 0] / T.clamp_min(1e-10)).clamp(-1.0, 1.0))


def eval_tilt_angle(q: Tensor) -> Tensor:
    """Tilt from vertical of a scalar-first q: cos θ = 1 − 2(q_y² + q_z²)."""
    return torch.arccos((1.0 - 2.0 * (q[..., 2] ** 2 + q[..., 3] ** 2)).clamp(-1.0, 1.0))


def eval_glideslope(r: Tensor, gamma) -> Tensor:
    """h·tan(γ) − ‖r_horizontal‖ (positive: satisfied)."""
    horiz = torch.sqrt(r[..., 1] ** 2 + r[..., 2] ** 2)
    tan = torch.tan(gamma) if isinstance(gamma, Tensor) else math.tan(gamma)
    return r[..., 0] * tan - horiz


def eval_angular_rate(omega: Tensor) -> Tensor:
    return torch.linalg.vector_norm(omega, dim=-1)


def check_all_constraints(x: Tensor, u: Tensor, params: ConstraintParams) -> Dict:
    """The full 6-DoF constraint report, per leading index."""
    r, v, q, omega = x[..., 1:4], x[..., 4:7], x[..., 7:11], x[..., 11:14]
    T = eval_thrust_magnitude(u)
    gim = eval_gimbal_angle(u)
    tilt = eval_tilt_angle(q)
    gs = eval_glideslope(r, params.gamma_gs)
    w = eval_angular_rate(omega)
    vmag = torch.linalg.vector_norm(v, dim=-1)
    sat = ((T >= params.T_min) & (T <= params.T_max) & (gim <= params.delta_max)
           & (tilt <= params.theta_max) & (gs >= 0) & (w <= params.omega_max)
           & (vmag <= params.v_max))
    return {
        "thrust_magnitude": T,
        "thrust_min_satisfied": T >= params.T_min,
        "thrust_max_satisfied": T <= params.T_max,
        "gimbal_angle": gim,
        "gimbal_satisfied": gim <= params.delta_max,
        "tilt_angle": tilt,
        "tilt_satisfied": tilt <= params.theta_max,
        "glideslope_margin": gs,
        "glideslope_satisfied": gs >= 0,
        "angular_rate": w,
        "angular_rate_satisfied": w <= params.omega_max,
        "velocity_mag": vmag,
        "velocity_satisfied": vmag <= params.v_max,
        "all_satisfied": sat,
    }


def check_constraints_3dof(x: Tensor, u: Tensor, params: ConstraintParams) -> Dict:
    """The 3-DoF subset: thrust magnitude, glideslope and velocity."""
    T = eval_thrust_magnitude(u)
    gs = eval_glideslope(x[..., 1:4], params.gamma_gs)
    vmag = torch.linalg.vector_norm(x[..., 4:7], dim=-1)
    sat = (T >= params.T_min) & (T <= params.T_max) & (gs >= 0) & (vmag <= params.v_max)
    return {"thrust_magnitude": T, "glideslope_margin": gs, "velocity_mag": vmag,
            "all_satisfied": sat}


def normal_quantile(confidence: Tensor) -> Tensor:
    """κ = Φ⁻¹(confidence)."""
    return torch.special.ndtri(confidence)


@functools.lru_cache(maxsize=64)
def quantile_constant(confidence: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    """κ = Φ⁻¹(confidence) on ``device``, computed once per (confidence,
    dtype, device) by the same ``ndtri`` on the device as
    ``normal_quantile(torch.tensor(confidence, dtype=dtype, device=device))``,
    and the same bits. Shared between callers: never written to."""
    return normal_quantile(torch.tensor(confidence, dtype=dtype, device=device))


@dataclass(frozen=True)
class TightenedConstraints:
    """Back-offs κσ per constraint from propagated state covariances, one per
    horizon step (and lane)."""

    glideslope_backoff: Tensor
    velocity_backoff: Tensor
    tilt_backoff: Tensor
    omega_backoff: Tensor

    @classmethod
    def from_covariances(cls, Sigmas: Tensor, confidence: float = 0.95
                         ) -> "TightenedConstraints":
        """σ of each constraint from the block traces of Σ (..., n, n): the
        position block for the glideslope, the velocity block for v_max,
        the attitude and rate blocks for 14 states."""
        kappa = normal_quantile(torch.tensor(confidence, dtype=Sigmas.dtype,
                                             device=Sigmas.device))
        tr = lambda a, b: torch.diagonal(Sigmas[..., a:b, a:b], dim1=-2, dim2=-1).sum(-1)
        pos_var, vel_var = tr(1, 4), tr(4, 7)
        if Sigmas.shape[-1] >= 14:
            att_var, om_var = tr(7, 11), tr(11, 14)
        else:
            att_var = om_var = torch.zeros_like(pos_var)
        return cls(glideslope_backoff=kappa * torch.sqrt(pos_var),
                   velocity_backoff=kappa * torch.sqrt(vel_var),
                   tilt_backoff=kappa * torch.sqrt(att_var),
                   omega_backoff=kappa * torch.sqrt(om_var))


def tighten_bounds(lo: Tensor, hi: Tensor, backoff: Tensor) -> Tuple[Tensor, Tensor]:
    """Shrink a box [lo, hi] inward by ``backoff`` without crossing over."""
    mid = 0.5 * (lo + hi)
    return torch.minimum(lo + backoff, mid), torch.maximum(hi - backoff, mid)


def constraint_jacobians(constraint_fn: Callable, x: Tensor, u: Tensor) -> Tuple[Tensor, Tensor]:
    """Forward-mode Jacobians (∂c/∂x, ∂c/∂u) of ``constraint_fn(x, u)`` at a
    point (x (n_x,), u (n_u,)) or, for x (B, n_x) and u (B, n_u), at each
    lane's point. ``constraint_fn`` takes unbatched vectors and uses no
    in-place ops."""
    jac = jacfwd(constraint_fn, argnums=(0, 1))
    return jac(x, u) if x.dim() == 1 else vmap(jac)(x, u)
