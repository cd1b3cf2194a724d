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

import torch

from .._device import DeviceLike, resolve_device
from .integrators import get_step_fn

N_STATE = 7
N_CONTROL = 3

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

    def replace(self, **kw) -> "Rocket3DoFParams":
        return replace(self, **kw)


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
