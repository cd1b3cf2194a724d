"""6-DoF quaternion RTI-MPC configuration and constraint handling
(counterpart of ``gpmpc_tpu/mpc/rti6dof.py``).

The QP works in the full 14-dim state with the renormalized discrete step
linearized by AD. The nonconvex thrust annulus and gimbal cone are handled
by an inner box in the QP (every box point satisfies ‖u‖ ≤ T_max and the
cone; the lower bound keeps ‖u‖ ≥ T_min) or by polyhedral cone facets
(``cone_facets``), and always by the exact projection ``clamp_thrust ∘
clamp_gimbal`` of the applied u0. Tilt and rate limits are inner boxes on
q_y, q_z and ω. The glideslope cone enters as facets (``glideslope_facets``)
or as one row a stage linearized around the trajectory every cycle
(``glideslope_smooth``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from .._device import DeviceLike
from ..dynamics.rocket6dof import Rocket6DoFParams, clamp_gimbal, clamp_thrust
from ..ops.qp import ADMMConfig
from .cost_functions import CostWeights
from .rti import RTIConfig, make_rti_controller

Tensor = torch.Tensor


def control_box_6dof(params: Rocket6DoFParams) -> Tuple[Tensor, Tensor]:
    """Inner box of the thrust annulus ∩ gimbal cone (body frame, +x axis):
    the lateral half-width is set by the lowest admissible u_x, and u_x's
    upper bound keeps the max-thrust corner inside ‖u‖ ≤ T_max."""
    ux_min = params.T_min * math.cos(params.delta_max)
    lat = params.T_min * math.sin(params.delta_max) / math.sqrt(2.0)
    ux_max = math.sqrt(max(params.T_max**2 - 2.0 * lat**2, ux_min**2))
    return (torch.tensor([ux_min + 1e-3, -lat, -lat], device=params.device),
            torch.tensor([ux_max, lat, lat], device=params.device))


def _facet_angles(n_facets: int) -> Tensor:
    return 2.0 * math.pi * torch.arange(n_facets) / n_facets


def gimbal_cone_rows(params: Rocket6DoFParams, n_facets: int = 8
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Inner polyhedral facets of the gimbal cone ‖u_perp‖ ≤ u_x·tanδ_max:
    facet j is cosφ_j·u_y + sinφ_j·u_z ≤ cos(π/n)·tanδ_max·u_x. Returns (Gu,
    gu_l, gu_u) for :class:`RTIConfig`."""
    phis = _facet_angles(n_facets)
    shrink = math.cos(math.pi / n_facets) * math.tan(params.delta_max)
    Gu = torch.stack([-shrink * torch.ones(n_facets), torch.cos(phis), torch.sin(phis)], dim=1)
    return Gu, torch.full((n_facets,), -math.inf), torch.zeros(n_facets)


def glideslope_rows(gamma_gs: float, n_x: int, n_facets: int = 8, h_offset: float = 0.2
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Inner polyhedral facets of the glideslope cone ‖r_horiz‖ ≤ (h + h₀)·tanγ
    on the state layout x = [m, h, r_y, r_z, …]; ``h_offset`` drops the cone
    vertex below the pad so the terminal-approach QPs stay feasible. Returns
    (Gx, gx_l, gx_u)."""
    phis = _facet_angles(n_facets)
    shrink = math.cos(math.pi / n_facets) * math.tan(gamma_gs)
    cols = [torch.zeros(n_facets), torch.full((n_facets,), -shrink), torch.cos(phis),
            torch.sin(phis)] + [torch.zeros(n_facets)] * (n_x - 4)
    return (torch.stack(cols, dim=1), torch.full((n_facets,), -math.inf),
            torch.full((n_facets,), shrink * h_offset))


def glideslope_linearized(gamma_gs: float, h_offset: float = 0.2, eps: float = 1e-3
                          ) -> Callable[[Tensor], Tuple[Tensor, Tensor, Tensor]]:
    """The smooth glideslope cone ‖r_horiz‖ ≤ (h + h₀)·tanγ linearized around
    the trajectory every cycle, one row a stage. Returns an
    ``RTIConfig.stage_rows_fn``:

        fn(X_lin (B, N+1, n_x)) → (Gx (B, N, 1, n_x), gx_l (B, N, 1), gx_u (B, N, 1))

    The norm is ε-smoothed (‖r‖_ε = √(r·r + ε²)) so the row is defined on the
    cone axis; the linearized set is an outer approximation that the SCP
    tightens as the iterate converges."""
    tan_g = math.tan(gamma_gs)

    def fn(X_lin: Tensor):
        Xs = X_lin[:, 1:]  # stage rows apply at x_1..x_N
        r = Xs[..., 2:4]
        nrm = torch.sqrt((r * r).sum(-1) + eps * eps)
        zero = torch.zeros_like(nrm)
        cols = ([zero, torch.full_like(nrm, tan_g), -r[..., 0] / nrm, -r[..., 1] / nrm]
                + [zero] * (Xs.shape[-1] - 4))
        G = torch.stack(cols, dim=-1)[:, :, None]
        # tanγ·h − (r̄/‖r̄‖ε)·r ≥ −tanγ·h₀ + ‖r̄‖ε − r̄·r̄/‖r̄‖ε = −tanγ·h₀ + ε²/‖r̄‖ε
        lo = (-tan_g * h_offset + eps * eps / nrm)[..., None]
        return G, lo, torch.full_like(lo, math.inf)

    return fn


def state_box_6dof(params: Rocket6DoFParams) -> Tuple[Tensor, Tensor]:
    """State bounds: loose translation boxes, tilt and rate inner boxes."""
    big = 1e20
    q_tilt = math.sin(min(params.theta_max, math.pi * 0.499) / 2.0)
    w_ax = params.omega_max / math.sqrt(3.0)
    lo = torch.tensor([-big, -10.0, -100.0, -100.0, -50.0, -50.0, -50.0,
                       -1.0, -1.0, -q_tilt, -q_tilt, -w_ax, -w_ax, -w_ax], device=params.device)
    hi = torch.tensor([big, 500.0, 100.0, 100.0, 50.0, 50.0, 50.0,
                       1.0, 1.0, q_tilt, q_tilt, w_ax, w_ax, w_ax], device=params.device)
    return lo, hi


def rti_config_6dof(
    params: Optional[Rocket6DoFParams] = None,
    N: int = 15,
    dt: float = 0.1,
    weights: Optional[CostWeights] = None,
    admm: Optional[ADMMConfig] = None,
    cone_facets: int = 0,
    glideslope_facets: int = 0,
    glideslope_smooth: bool = False,
    bound_translation: bool = True,
    device: DeviceLike = None,
) -> RTIConfig:
    """An :class:`RTIConfig` for the 14-state quaternion model, on ``device``
    (default: the params' device).

    ``cone_facets > 0`` replaces the lateral-thrust box with that many gimbal
    cone rows (the box then caps u_x and the outer lateral extent
    T_max·sinδ). ``glideslope_facets > 0`` adds position glideslope facets,
    ``glideslope_smooth`` the linearized smooth cone instead.
    ``bound_translation=False`` drops the condensed QP's bound rows of the 7
    translation components [m, r, v], loose envelopes that cannot bind in a
    landing approach; the attitude and rate rows stay."""
    params = params or Rocket6DoFParams(device="cuda" if device is None else device)
    dev = params.device if device is None else device
    w = weights or CostWeights()
    x_min, x_max = state_box_6dof(params)
    extra = {}
    if not bound_translation:
        extra["x_bound_mask"] = (False,) * 7 + (True,) * 7
    if cone_facets:
        ux_min = params.T_min * math.cos(params.delta_max)
        lat = params.T_max * math.sin(params.delta_max)
        u_min = torch.tensor([ux_min + 1e-3, -lat, -lat])
        u_max = torch.tensor([params.T_max, lat, lat])
        Gu, gu_l, gu_u = gimbal_cone_rows(params, cone_facets)
        extra.update(Gu=Gu, gu_l=gu_l, gu_u=gu_u)
    else:
        u_min, u_max = control_box_6dof(params)
    if glideslope_smooth:
        if glideslope_facets:
            raise ValueError("glideslope_smooth replaces glideslope_facets — pick one")
        extra.update(stage_rows_fn=glideslope_linearized(params.gamma_gs), n_stage_rows=1)
    elif glideslope_facets:
        Gx, gx_l, gx_u = glideslope_rows(params.gamma_gs, 14, glideslope_facets)
        extra.update(Gx=Gx, gx_l=gx_l, gx_u=gx_u)
    return RTIConfig(
        N=N, dt=dt, n_x=14, n_u=3,
        Q=w.Q_6dof(), R=w.R(3), Qf=w.P_6dof(),
        x_min=x_min, x_max=x_max, u_min=u_min, u_max=u_max,
        admm=admm or ADMMConfig(max_iter=100, polish=True),
        device=dev, **extra,
    )


def project_control_6dof(params: Rocket6DoFParams, u: Tensor) -> Tensor:
    """Exact feasibility projection of u0 before the plant."""
    return clamp_thrust(params, clamp_gimbal(params, u))


def make_rti6dof_controller(step_fn: Callable[[Tensor, Tensor], Tensor],
                            params: Rocket6DoFParams, config: RTIConfig, x_target,
                            reference_fn: Optional[Callable] = None, ref_horizon: int = 120):
    """(cinit, cstep) for a fleet flown in lockstep (see
    :func:`make_rti_controller`), with the exact control projection composed
    after the QP."""
    cinit, cstep = make_rti_controller(step_fn, config, x_target, reference_fn=reference_fn,
                                       ref_horizon=ref_horizon)

    def cstep_proj(cstate, x, k: int):
        u, cstate = cstep(cstate, x, k)
        return project_control_6dof(params, u), cstate

    return cinit, cstep_proj
