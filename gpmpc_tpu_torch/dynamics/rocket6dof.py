"""6-DoF quaternion rigid-body powered-descent dynamics (counterpart of
``gpmpc_tpu/dynamics/rocket6dof.py``, with its object facade ``Rocket6DoF``).

State  x = [m, r_I(3), v_I(3), q_BI(4, scalar-first), ω_B(3)]  (n_x = 14)
Control u = T_B(3)  thrust in the body frame                   (n_u = 3)

    ṁ  = −α ‖T_B‖
    ṙ  = v
    v̇  = C_IB(q) T_B / m + g_I
    q̇  = ½ [−ω·q_v ; q_w ω + ω × q_v]
    ω̇  = J⁻¹ (r_T_B × T_B − ω × J ω)

Szmuk-normalized defaults: J_B = 0.168·diag(0.02, 1, 1), r_T_B = [−0.25,0,0],
g_I = [−1,0,0]. Body +x is the rocket's long axis. The functions take any
leading batch dimensions (``x[..., k]``) and use no in-place ops, so
``torch.func.jacfwd`` under ``vmap`` differentiates them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .integrators import get_step_fn
from .linearize import ad_jacobians

N_STATE = 14
N_CONTROL = 3

IDX_MASS = 0
IDX_POS = slice(1, 4)
IDX_VEL = slice(4, 7)
IDX_QUAT = slice(7, 11)
IDX_OMEGA = slice(11, 14)

_EPS_THRUST = 1e-10  # guards ‖T‖ = 0 and ‖v‖ = 0 in the AD Jacobian

_DEFAULTS = {
    "J_B": [[0.168 * 0.02, 0.0, 0.0], [0.0, 0.168, 0.0], [0.0, 0.0, 0.168]],
    "r_T_B": [-0.25, 0.0, 0.0],
    "r_cp_B": [0.05, 0.0, 0.0],
    "g_I": [-1.0, 0.0, 0.0],
    "C_A": [[0.0] * 3] * 3,
}


@dataclass(frozen=True)
class Rocket6DoFParams:
    """Physical parameters; defaults mirror the JAX package's (Szmuk
    normalized units). ``J_B``, ``r_T_B``, ``r_cp_B``, ``g_I`` and ``C_A``
    take anything ``torch.as_tensor`` reads (``None``: the default) and are
    held as float32 tensors on ``device``, built once here, together with
    J_B⁻¹, so the dynamics never solve with J_B per call."""

    m_dry: float = 1.0
    m_wet: float = 2.0
    J_B: Any = None
    I_sp: float = 30.0
    g0: float = 1.0
    T_min: float = 1.5
    T_max: float = 6.5
    r_T_B: Any = None
    r_cp_B: Any = None
    g_I: Any = None
    # constraint angles [rad]
    delta_max: float = math.radians(20.0)
    theta_max: float = math.radians(90.0)
    gamma_gs: float = math.radians(30.0)
    omega_max: float = math.radians(60.0)
    # aero (zero coefficients disable)
    rho: float = 0.0
    S_ref: float = 1.0
    C_A: Any = None
    default_dt: float = 0.1
    integrator: str = "rk4"
    device: DeviceLike = "cuda"
    J_B_inv: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        for name, default in _DEFAULTS.items():
            v = getattr(self, name)
            object.__setattr__(self, name, torch.as_tensor(
                default if v is None else v, dtype=torch.float32).to(dev))
        object.__setattr__(self, "J_B_inv", torch.linalg.inv(
            self.J_B.double()).float())

    @property
    def alpha(self) -> float:
        """Mass-flow coefficient α = 1/(I_sp g₀)."""
        return 1.0 / (self.I_sp * self.g0)

    @property
    def g(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.g_I)

    @classmethod
    def szmuk_defaults(cls, device: DeviceLike = "cuda") -> "Rocket6DoFParams":
        return cls(device=device)

    def replace(self, **kw) -> "Rocket6DoFParams":
        return replace(self, **kw)


# the JAX package's name for the parameters
Rocket6DoFConfig = Rocket6DoFParams


def dcm_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Body→inertial rotation matrix C_IB(q) (…, 3, 3) of scalar-first
    quaternions q (…, 4), in the JAX package's algebraic form."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx**2 + qy**2)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def tilt_angle(q: torch.Tensor) -> torch.Tensor:
    """Tilt from vertical, cos θ = 1 − 2(q_y² + q_z²) (body long axis +x)."""
    cos_theta = 1.0 - 2.0 * (q[..., 2] ** 2 + q[..., 3] ** 2)
    return torch.arccos(cos_theta.clamp(-1.0, 1.0))


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M (…, i, j) times v (…, j), broadcast over the leading dims."""
    return (M @ v[..., None])[..., 0]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def f(params: Rocket6DoFParams, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Continuous dynamics ẋ = f(x, u)."""
    m = x[..., 0:1]
    v = x[..., 4:7]
    q = x[..., 7:11]
    omega = x[..., 11:14]

    C_IB = dcm_from_quaternion(q)
    T_mag = torch.sqrt((u * u).sum(-1, keepdim=True) + _EPS_THRUST**2)

    # aero force in the body frame: F_A = −½ ρ S C_A ‖v‖ v_B (zero when ρ = 0);
    # the smooth ‖v‖ keeps the AD Jacobian finite at v = 0
    v_B = _mv(C_IB.transpose(-1, -2), v)
    v_mag = torch.sqrt((v * v).sum(-1, keepdim=True) + _EPS_THRUST**2)
    F_A_B = -(0.5 * params.rho * params.S_ref) * _mv(params.C_A, v_B) * v_mag

    m_dot = -params.alpha * T_mag
    v_dot = _mv(C_IB, u + F_A_B) / m + params.g_I

    qw, qv = q[..., 0:1], q[..., 1:4]
    q_dot = 0.5 * torch.cat(
        [-(omega * qv).sum(-1, keepdim=True), qw * omega + _cross(omega, qv)], dim=-1)

    torque = _cross(params.r_T_B, u) + _cross(params.r_cp_B, F_A_B)
    omega_dot = _mv(params.J_B_inv, torque - _cross(omega, _mv(params.J_B, omega)))

    return torch.cat([m_dot, v, v_dot, q_dot, omega_dot], dim=-1)


def normalize_quaternion(x: torch.Tensor) -> torch.Tensor:
    """Renormalize the quaternion block of state vectors (…, 14)."""
    q = x[..., 7:11]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([x[..., :7], q, x[..., 11:]], dim=-1)


def step(params: Rocket6DoFParams, x, u, dt=None) -> torch.Tensor:
    """Discrete step with the quaternion renormalized after it."""
    dt = params.default_dt if dt is None else dt
    return normalize_quaternion(get_step_fn(params.integrator)(partial(f, params), x, u, dt))


def simulate(params: Rocket6DoFParams, x0, U, dt=None) -> torch.Tensor:
    """Open-loop rollout: x0 (…, 14), U (…, N, 3) → (…, N+1, 14)."""
    xs = [x0]
    for k in range(U.shape[-2]):
        xs.append(step(params, xs[-1], U[..., k, :], dt))
    return torch.stack(xs, dim=-2)


# Constraints (negative = satisfied)


def thrust_constraint(params, u) -> Tuple[torch.Tensor, torch.Tensor]:
    T_mag = torch.linalg.vector_norm(u, dim=-1)
    return params.T_min - T_mag, T_mag - params.T_max


def gimbal_constraint(params, u) -> torch.Tensor:
    """Gimbal angle δ between the thrust and body +x, minus δ_max."""
    T_mag = torch.linalg.vector_norm(u, dim=-1)
    cos_delta = u[..., 0] / T_mag.clamp_min(1e-10)
    return torch.arccos(cos_delta.clamp(-1.0, 1.0)) - params.delta_max


def tilt_constraint(params, x) -> torch.Tensor:
    return tilt_angle(x[..., 7:11]) - params.theta_max


def glide_slope_constraint(params, x) -> torch.Tensor:
    horiz = torch.sqrt(x[..., 2] ** 2 + x[..., 3] ** 2)
    return horiz - x[..., 1] * math.tan(params.gamma_gs)


def angular_rate_constraint(params, x) -> torch.Tensor:
    return torch.linalg.vector_norm(x[..., 11:14], dim=-1) - params.omega_max


def evaluate_constraints(params, x, u) -> dict:
    lo, hi = thrust_constraint(params, u)
    return {
        "thrust_lower": lo,
        "thrust_upper": hi,
        "gimbal": gimbal_constraint(params, u),
        "tilt": tilt_constraint(params, x),
        "glide_slope": glide_slope_constraint(params, x),
        "angular_rate": angular_rate_constraint(params, x),
    }


# Control utilities


def hover_thrust(params, x) -> torch.Tensor:
    """Body-frame thrust cancelling gravity at the current attitude and
    mass: −m g_I taken into the body frame."""
    C_IB = dcm_from_quaternion(x[..., 7:11])
    return _mv(C_IB.transpose(-1, -2), -x[..., 0:1] * params.g_I)


def clamp_thrust(params, u) -> torch.Tensor:
    """Clamp ‖T‖ into [T_min, T_max] preserving direction (+x at u = 0)."""
    T_mag = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    up = torch.zeros_like(u)
    up[..., 0] = 1.0
    safe_dir = torch.where(T_mag > 1e-10, u / T_mag.clamp_min(1e-10), up)
    return safe_dir * T_mag.clamp(params.T_min, params.T_max)


def clamp_gimbal(params, u) -> torch.Tensor:
    """Project the thrust into the gimbal cone about body +x, keeping its
    magnitude."""
    T_mag = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    ux = u[..., 0:1]
    u_perp = u[..., 1:]
    perp = torch.linalg.vector_norm(u_perp, dim=-1, keepdim=True)
    inside = torch.atan2(perp, ux) <= params.delta_max
    # rotate onto the cone edge: keep the magnitude, set the angle to δ_max
    new_ux = T_mag * math.cos(params.delta_max)
    new_perp_mag = T_mag * math.sin(params.delta_max)
    dir_perp = torch.where(perp > 1e-10, u_perp / perp.clamp_min(1e-10),
                           torch.zeros_like(u_perp))
    proj = torch.cat([new_ux, new_perp_mag * dir_perp], dim=-1)
    return torch.where(inside, u, proj)


def create_initial_state(
    params: Optional[Rocket6DoFParams] = None,
    altitude: float = 10.0,
    mass: Optional[float] = None,
    horizontal: Tuple[float, float] = (0.0, 0.0),
    velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    quaternion: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0),
    omega: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    device: DeviceLike = None,
) -> torch.Tensor:
    """A (14,) state on ``device`` (default: the params' device; without
    params, CUDA)."""
    if params is None:
        params = Rocket6DoFParams(device="cuda" if device is None else device)
    dev = params.device if device is None else resolve_device(device)
    m = params.m_wet if mass is None else mass
    return torch.tensor([m, altitude, *horizontal, *velocity, *quaternion, *omega],
                        dtype=torch.float32, device=dev)


# Jacobians (forward-mode AD, exact)


def linearize_continuous(params: Rocket6DoFParams, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A_c, B_c) = (∂f/∂x, ∂f/∂u) at (x, u)."""
    return ad_jacobians(partial(f, params), x, u)


def linearize_discrete(params: Rocket6DoFParams, x, u, dt=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact discrete linearization of the renormalized step."""
    dt = params.default_dt if dt is None else dt
    F = lambda xx, uu: step(params, xx, uu, dt)
    A_d, B_d = ad_jacobians(F, x, u)
    return A_d, B_d, F(x, u) - _mv(A_d, x) - _mv(B_d, u)


class Rocket6DoF:
    """Object facade with the JAX package's method names; every method takes
    any leading batch dimensions."""

    N_STATE = N_STATE
    N_CONTROL = N_CONTROL
    IDX_MASS = IDX_MASS
    IDX_POS = IDX_POS
    IDX_VEL = IDX_VEL
    IDX_QUAT = IDX_QUAT
    IDX_OMEGA = IDX_OMEGA

    def __init__(self, params: Optional[Rocket6DoFParams] = None, device: DeviceLike = "cuda"):
        self.params = params or Rocket6DoFParams(device=device)

    @property
    def config(self):
        return self.params

    @property
    def n_state(self):
        return N_STATE

    @property
    def n_control(self):
        return N_CONTROL

    def f(self, x, u):
        return f(self.params, x, u)

    dynamics = f

    def step(self, x, u, dt=None):
        return step(self.params, x, u, dt)

    f_discrete = step

    def simulate(self, x0, U, dt=None):
        return simulate(self.params, x0, U, dt)

    def jacobian_x(self, x, u):
        return linearize_continuous(self.params, x, u)[0]

    def jacobian_u(self, x, u):
        return linearize_continuous(self.params, x, u)[1]

    A = jacobian_x
    B = jacobian_u

    def linearize(self, x, u, dt=None):
        A_c, B_c = linearize_continuous(self.params, x, u)
        if dt is not None:
            return torch.eye(N_STATE, dtype=x.dtype, device=x.device) + A_c * dt, B_c * dt
        return A_c, B_c

    def linearize_discrete(self, x, u, dt=None):
        return linearize_discrete(self.params, x, u, dt)

    def get_dcm(self, x):
        return dcm_from_quaternion(x[..., 7:11])

    def get_tilt_angle(self, x):
        return tilt_angle(x[..., 7:11])

    def thrust_constraint(self, u):
        return thrust_constraint(self.params, u)

    def gimbal_constraint(self, u):
        return gimbal_constraint(self.params, u)

    def tilt_constraint(self, x):
        return tilt_constraint(self.params, x)

    def glide_slope_constraint(self, x):
        return glide_slope_constraint(self.params, x)

    def angular_rate_constraint(self, x):
        return angular_rate_constraint(self.params, x)

    def evaluate_constraints(self, x, u):
        return evaluate_constraints(self.params, x, u)

    def hover_thrust(self, x):
        return hover_thrust(self.params, x)

    def clamp_thrust(self, u):
        return clamp_thrust(self.params, u)

    def clamp_gimbal(self, u):
        return clamp_gimbal(self.params, u)

    def fuel_remaining(self, x):
        return x[..., 0] - self.params.m_dry

    def fuel_fraction(self, x):
        return (x[..., 0] - self.params.m_dry) / (self.params.m_wet - self.params.m_dry)

    def create_initial_state(self, **kw):
        return create_initial_state(self.params, **kw)


def create_szmuk_rocket(device: DeviceLike = "cuda") -> Rocket6DoF:
    """A facade with the Szmuk-normalized parameters."""
    return Rocket6DoF(Rocket6DoFParams.szmuk_defaults(device))


# the JAX package's name for the facade
Rocket6DoFDynamics = Rocket6DoF
