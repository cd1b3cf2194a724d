"""3-DoF point-mass powered-descent dynamics (counterpart of
``gpmpc_tpu/dynamics/rocket3dof.py``).

State  x = [m, r_x, r_y, r_z, v_x, v_y, v_z]   (n_x = 7)
Control u = [T_x, T_y, T_z]  thrust in the inertial frame (n_u = 3)

    ṁ = −α ‖T‖,  α = 1/(I_sp g₀)
    ṙ = v
    v̇ = T/m + g_I  (− ½ρ C_D A_ref ‖v‖ v / m when drag is enabled)

Gravity is along −x, so x[1] is altitude and x[4] vertical velocity. The
functions take any leading batch dimensions (``x[..., k]``) and use no
in-place ops, so ``torch.func.jacfwd`` under ``vmap`` differentiates them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .integrators import get_step_fn, integrate_trajectory
from .linearize import ad_jacobians

N_STATE = 7
N_CONTROL = 3

IDX_MASS = 0
IDX_POS = slice(1, 4)
IDX_VEL = slice(4, 7)

_EPS_THRUST = 1e-10  # guards ‖T‖ = 0 in α‖T‖ gradients


@dataclass(frozen=True)
class Rocket3DoFParams:
    """Physical parameters; defaults mirror the JAX package's normalized
    units. ``g_I`` is held as a tensor on ``device`` (built once here, so
    the dynamics never copy it to the device per call)."""

    m_dry: float = 1.0
    m_wet: float = 2.0
    I_sp: float = 30.0
    g0: float = 1.0
    T_min: float = 0.0
    T_max: float = 6.5
    gravity: tuple = (-1.0, 0.0, 0.0)
    rho: float = 0.0
    C_D: float = 0.0
    A_ref: float = 0.0
    gamma_gs: float = math.radians(30.0)
    v_max: float = 1e9
    default_dt: float = 0.1
    integrator: str = "rk4"
    device: DeviceLike = "cuda"
    g_I: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "g_I", torch.tensor(
            self.gravity, dtype=torch.float32, device=dev))

    @property
    def alpha(self) -> float:
        """Mass-flow coefficient α = 1/(I_sp g₀)."""
        return 1.0 / (self.I_sp * self.g0)

    @property
    def g(self) -> torch.Tensor:
        """Gravity magnitude."""
        return torch.linalg.vector_norm(self.g_I)

    @classmethod
    def normalized_defaults(cls, device: DeviceLike = "cuda") -> "Rocket3DoFParams":
        return cls(device=device)

    @classmethod
    def fuel_optimal_defaults(cls, device: DeviceLike = "cuda") -> "Rocket3DoFParams":
        """Parameters for fuel-optimal optimization (the JAX package's)."""
        return cls(m_wet=2.0, m_dry=1.0, T_min=0.3, T_max=5.0, I_sp=300.0,
                   gravity=(-9.81, 0.0, 0.0), device=device)

    def replace(self, **kw) -> "Rocket3DoFParams":
        return replace(self, **kw)


# the JAX package's name for the parameters
Rocket3DoFConfig = Rocket3DoFParams


def f(params: Rocket3DoFParams, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Continuous dynamics ẋ = f(x, u)."""
    m = x[..., 0:1]
    v = x[..., 4:7]
    T_mag = torch.sqrt((u * u).sum(-1, keepdim=True) + _EPS_THRUST**2)
    m_dot = -params.alpha * T_mag
    # smooth ‖v‖ so the Jacobian is finite at v = 0
    v_mag = torch.sqrt((v * v).sum(-1, keepdim=True) + _EPS_THRUST**2)
    a_drag = -(0.5 * params.rho * params.C_D * params.A_ref) * v_mag * v / m
    v_dot = u / m + params.g_I + a_drag
    return torch.cat([m_dot, v, v_dot], dim=-1)


def step(params: Rocket3DoFParams, x, u, dt=None) -> torch.Tensor:
    """Discrete step x⁺ = F(x, u) using the configured integrator."""
    dt = params.default_dt if dt is None else dt
    return get_step_fn(params.integrator)(partial(f, params), x, u, dt)


def hover_thrust(params: Rocket3DoFParams, x) -> torch.Tensor:
    """Thrust that exactly cancels gravity at the current mass."""
    return -x[..., 0:1] * params.g_I


def clamp_thrust(params: Rocket3DoFParams, u) -> torch.Tensor:
    """Clamp ‖T‖ into [T_min, T_max] preserving direction."""
    T_mag = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    up = torch.zeros_like(u)
    up[..., 0] = 1.0
    safe_dir = torch.where(T_mag > 1e-10, u / T_mag.clamp_min(1e-10), up)
    return safe_dir * T_mag.clamp(params.T_min, params.T_max)


def simulate(params: Rocket3DoFParams, x0, U, dt=None) -> torch.Tensor:
    """Open-loop rollout: x0 (…, 7), U (…, N, 3) → states (…, N+1, 7)."""
    dt = params.default_dt if dt is None else dt
    return integrate_trajectory(partial(f, params), x0, U, dt, params.integrator)


# Jacobians (closed-form continuous; forward-mode AD for the exact ones)


def A_continuous(params: Rocket3DoFParams, x, u) -> torch.Tensor:
    """Closed-form ∂f/∂x (…, 7, 7) of the drag-free rows."""
    m = x[..., 0]
    A = x.new_zeros(*x.shape[:-1], N_STATE, N_STATE)
    i = torch.arange(3, device=x.device)
    A[..., 1 + i, 4 + i] = 1.0  # ṙ = v
    A[..., 4:7, 0] = -u / (m**2)[..., None]  # ∂(T/m)/∂m
    return A


def B_continuous(params: Rocket3DoFParams, x, u) -> torch.Tensor:
    """Closed-form ∂f/∂u (…, 7, 3)."""
    m = x[..., 0]
    T_mag = torch.sqrt((u * u).sum(-1, keepdim=True) + _EPS_THRUST**2)
    B = x.new_zeros(*x.shape[:-1], N_STATE, N_CONTROL)
    B[..., 0, :] = -params.alpha * u / T_mag
    i = torch.arange(3, device=x.device)
    B[..., 4 + i, i] = (1.0 / m)[..., None]
    return B


def linearize_continuous(params: Rocket3DoFParams, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A_c, B_c) at (x, u) by forward-mode AD (exact with drag on too)."""
    return ad_jacobians(partial(f, params), x, u)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def linearize_discrete(params: Rocket3DoFParams, x, u, dt=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact discrete linearization x⁺ ≈ A_d x + B_d u + c: the AD Jacobians
    of the discrete step, so c carries the whole integrator."""
    dt = params.default_dt if dt is None else dt
    F = lambda xx, uu: step(params, xx, uu, dt)
    A_d, B_d = ad_jacobians(F, x, u)
    return A_d, B_d, F(x, u) - _mv(A_d, x) - _mv(B_d, u)


def linearize_discrete_euler(params: Rocket3DoFParams, x, u, dt=None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Euler discretization of the continuous Jacobians, A_d = I + A_c dt,
    B_d = B_c dt, c = F(x,u) − A_d x − B_d u (kept for parity testing)."""
    dt = params.default_dt if dt is None else dt
    A_c, B_c = linearize_continuous(params, x, u)
    A_d = torch.eye(N_STATE, dtype=x.dtype, device=x.device) + A_c * dt
    B_d = B_c * dt
    return A_d, B_d, step(params, x, u, dt) - _mv(A_d, x) - _mv(B_d, u)


# Constraints (negative = satisfied) and fuel


def thrust_constraint(params: Rocket3DoFParams, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T_min − ‖T‖, ‖T‖ − T_max)."""
    T_mag = torch.linalg.vector_norm(u, dim=-1)
    return params.T_min - T_mag, T_mag - params.T_max


def glide_slope_constraint(params: Rocket3DoFParams, x) -> torch.Tensor:
    """‖r_horiz‖ − h·tan(γ) (altitude is x[1])."""
    horiz = torch.sqrt(x[..., 2] ** 2 + x[..., 3] ** 2)
    return horiz - x[..., 1] * math.tan(params.gamma_gs)


def evaluate_constraints(params: Rocket3DoFParams, x, u) -> dict:
    lo, hi = thrust_constraint(params, u)
    return {"thrust_lower": lo, "thrust_upper": hi,
            "glide_slope": glide_slope_constraint(params, x)}


def fuel_remaining(params: Rocket3DoFParams, x) -> torch.Tensor:
    return x[..., 0] - params.m_dry


def fuel_fraction(params: Rocket3DoFParams, x) -> torch.Tensor:
    return (x[..., 0] - params.m_dry) / (params.m_wet - params.m_dry)


def create_initial_state(params: Optional[Rocket3DoFParams] = None, altitude: float = 10.0,
                         mass: Optional[float] = None,
                         horizontal: Tuple[float, float] = (0.0, 0.0),
                         velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                         device: DeviceLike = None) -> torch.Tensor:
    """x0 = [m, alt, y, z, vx, vy, vz] (7,) on ``device`` (default: the
    params' device; without params, CUDA)."""
    if params is None:
        params = Rocket3DoFParams(device="cuda" if device is None else device)
    dev = params.device if device is None else resolve_device(device)
    m = params.m_wet if mass is None else mass
    return torch.tensor([m, altitude, horizontal[0], horizontal[1], *velocity],
                        dtype=torch.float32, device=dev)


class Rocket3DoF:
    """Object facade over the pure functions, with the JAX package's method
    names; every method takes any leading batch dimensions."""

    N_STATE = N_STATE
    N_CONTROL = N_CONTROL
    IDX_MASS = IDX_MASS
    IDX_POS = IDX_POS
    IDX_VEL = IDX_VEL

    def __init__(self, params: Optional[Rocket3DoFParams] = None, device: DeviceLike = "cuda"):
        self.params = params or Rocket3DoFParams(device=device)

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

    def thrust_constraint(self, u):
        return thrust_constraint(self.params, u)

    def glide_slope_constraint(self, x):
        return glide_slope_constraint(self.params, x)

    def evaluate_constraints(self, x, u):
        return evaluate_constraints(self.params, x, u)

    def hover_thrust(self, x):
        return hover_thrust(self.params, x)

    def clamp_thrust(self, u):
        return clamp_thrust(self.params, u)

    def fuel_remaining(self, x):
        return fuel_remaining(self.params, x)

    def fuel_fraction(self, x):
        return fuel_fraction(self.params, x)

    def create_initial_state(self, **kw):
        return create_initial_state(self.params, **kw)

    def get_control_bounds(self):
        b = self.params.T_max
        dev = self.params.device
        return (torch.tensor([-b, -b, -b], device=dev), torch.tensor([b, b, b], device=dev))

    def get_state_bounds(self):
        inf, p = math.inf, self.params
        return (torch.tensor([p.m_dry, 0.0, -inf, -inf, -inf, -inf, -inf], device=p.device),
                torch.tensor([p.m_wet, inf, inf, inf, inf, inf, inf], device=p.device))


def create_rocket_3dof(preset: str = "normalized", device: DeviceLike = "cuda") -> Rocket3DoF:
    """A facade with the "normalized" or "fuel_optimal" parameters."""
    if preset == "normalized":
        return Rocket3DoF(Rocket3DoFParams.normalized_defaults(device))
    if preset == "fuel_optimal":
        return Rocket3DoF(Rocket3DoFParams.fuel_optimal_defaults(device))
    raise ValueError(f"unknown preset {preset!r}")


# the JAX package's name for the facade
Rocket3DoFDynamics = Rocket3DoF
