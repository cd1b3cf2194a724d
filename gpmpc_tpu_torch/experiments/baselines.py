"""Baseline controllers, lanes first (counterpart of
``gpmpc_tpu/experiments/baselines.py``): LQR about the landing target (the
hover backup's DARE gains with the PD fallback), the cascaded
altitude/horizontal PID with integral clamping and gravity feed-forward,
the open-loop plan, and the proportional gravity-turn descent law. Each is
a ``(controller_init(x0s) → cstate, controller_step(cstate, x (B, 7), k) →
(u (B, 3), cstate))`` pair, as ``run_campaign`` takes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..dynamics import rocket3dof as r3
from ..safety.backup_controller import hover_backup_3dof

Tensor = torch.Tensor


def _no_state(x0s: Tensor) -> Tensor:
    return x0s.new_zeros(x0s.shape[0], 0)


def make_lqr_controller(params, x_target: Tensor, dt: float = 0.1) -> Tuple[Callable, Callable]:
    """LQR about the landing target: the hover backup's gains."""
    backup = hover_backup_3dof(params, altitude=float(x_target[1]), mass=float(x_target[0]),
                               dt=dt)

    def cstep(c, x, k):
        return backup.control(x), c

    return _no_state, cstep


def make_pid_controller(params, x_target: Tensor, kp_alt: float = 2.0, kd_alt: float = 3.0,
                        ki_alt: float = 0.1, kp_h: float = 1.0, kd_h: float = 2.0,
                        integral_limit: float = 2.0) -> Tuple[Callable, Callable]:
    """Cascaded altitude/horizontal PID with gravity feed-forward and integral
    clamping; the controller state is each lane's altitude integral (B, 1)."""
    g = abs(float(params.gravity[0]))
    xt = x_target

    def cinit(x0s):
        return x0s.new_zeros(x0s.shape[0], 1)

    def cstep(c, x, k):
        e_alt = xt[1] - x[:, 1]
        e_valt = xt[4] - x[:, 4]
        integ = (c[:, 0] + e_alt * 0.1).clamp(-integral_limit, integral_limit)
        u_x = x[:, 0] * g + kp_alt * e_alt + kd_alt * e_valt + ki_alt * integ
        u_y = kp_h * (xt[2] - x[:, 2]) + kd_h * (xt[5] - x[:, 5])
        u_z = kp_h * (xt[3] - x[:, 3]) + kd_h * (xt[6] - x[:, 6])
        u = r3.clamp_thrust(params, torch.stack([u_x, u_y, u_z], dim=1))
        return u, integ[:, None]

    return cinit, cstep


def make_open_loop_controller(U_plan: Tensor) -> Tuple[Callable, Callable]:
    """Replay a precomputed plan (T, n_u), shared by every lane, or (B, T,
    n_u), one a lane; the last control holds past the plan's end."""

    def cstep(c, x, k):
        u = U_plan[..., min(k, U_plan.shape[-2] - 1), :]
        return u.expand(x.shape[0], u.shape[-1]), c

    return _no_state, cstep


def make_gravity_turn_controller(params, v_scale: float = 0.8) -> Tuple[Callable, Callable]:
    """The proportional descent law: track v_ref = −v_scale·√alt with a
    lateral PD."""

    def cstep(c, x, k):
        v_ref = -v_scale * torch.sqrt(x[:, 1].clamp_min(0.0))
        h = r3.hover_thrust(params, x)
        u = torch.stack([h[:, 0] + 2.0 * (v_ref - x[:, 4]),
                         h[:, 1] - 1.0 * x[:, 5] - 0.5 * x[:, 2],
                         h[:, 2] - 1.0 * x[:, 6] - 0.5 * x[:, 3]], dim=1)
        return r3.clamp_thrust(params, u), c

    return _no_state, cstep


def create_baseline_controllers(params, x_target: Tensor, dt: float = 0.1,
                                include: Optional[Tuple[str, ...]] = None
                                ) -> Dict[str, Tuple[Callable, Callable]]:
    """Name → (cinit, cstep) of "lqr", "pid", "gravity_turn" and
    "open_loop_freefall" (T_min straight up for 400 steps), or of the names
    in ``include``."""
    dev = x_target.device
    all_ctrls = {
        "lqr": lambda: make_lqr_controller(params, x_target, dt),
        "pid": lambda: make_pid_controller(params, x_target),
        "gravity_turn": lambda: make_gravity_turn_controller(params),
        "open_loop_freefall": lambda: make_open_loop_controller(
            torch.tensor([params.T_min, 0.0, 0.0], device=dev).repeat(400, 1)),
    }
    names = include or tuple(all_ctrls)
    return {n: all_ctrls[n]() for n in names}
