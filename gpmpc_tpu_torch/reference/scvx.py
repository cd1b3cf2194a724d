"""Successive convexification (SCVX) trajectory optimization, lanes first
(counterpart of ``gpmpc_tpu/reference/scvx.py``).

Each SCP iteration linearizes the dynamics along the exact rollout of the
incumbent controls, builds the sparse-form QP (z = [x₀, u₀, …, x_N]) with
trust regions intersected with the box bounds, a linear true-fuel term
(−w_fuel·m_N), a soft terminal state and a proximal term toward the
linearization point, and solves every lane's QP in one batched ADMM call
(``ops.qp.solve``: the chunk kernel on the card). A lane accepts its step
when the solve is SOLVED or its primal residual is below
``accept_pri_tol``. Free final time is an outer sweep over candidate time
steps, batched with the initial states on the lane axis.

Spans (``utils.profiler.span``): ``scvx.rollout``, ``scvx.linearize``,
``scvx.qp_build``, ``scvx.solve`` (the ``admm.*`` spans inside),
``scvx.accept``, ``scvx.select``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..dynamics.linearize import trajectory_jacobians
from ..mpc.rti import _sparse_admm_cfg
from ..ops.qp import ADMMConfig, QPData, SOLVED, join_z, solve, split_z
from ..ops.qp.mpc_qp import build_constraints, build_stage_rows
from ..utils.profiler import span

Tensor = torch.Tensor


@dataclass(frozen=True)
class SCVXConfig:
    """Field names and defaults are those of the JAX ``SCVXConfig``; the
    bounds and facet rows live on ``device``."""

    N: int = 50
    n_x: int = 7
    n_u: int = 3
    iterations: int = 15
    trust_x: float = 8.0
    trust_u: float = 3.0
    trust_shrink: float = 0.9  # geometric trust-region decay per SCP iteration
    w_fuel: float = 1.0  # true fuel: minimize −w_fuel·m_N
    w_stage: float = 0.0  # tracking of the straight-line interpolation
    w_prox: float = 0.05  # proximal regularization toward the linearization point
    eps_reg: float = 1e-4
    accept_pri_tol: float = 5e-3
    w_vc: float = 1e3
    w_terminal: float = 100.0
    u_min: Optional[Tensor] = None  # default [0.3, −5, −5]
    u_max: Optional[Tensor] = None  # default [5, 5, 5]
    x_min: Optional[Tensor] = None  # default [1, 0, −100, −100, −50, −50, −50]
    x_max: Optional[Tensor] = None  # default [1e20, 500, 100, 100, 50, 50, 50]
    admm: ADMMConfig = ADMMConfig(max_iter=1000, polish=True)
    # optional per-stage facet rows: Gx on x_k for k = 1..N, Gu on u_k
    Gx: Optional[Tensor] = None
    gx_l: Optional[Tensor] = None
    gx_u: Optional[Tensor] = None
    Gu: Optional[Tensor] = None
    gu_l: Optional[Tensor] = None
    gu_u: Optional[Tensor] = None
    device: DeviceLike = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        defaults = {"u_min": (0.3, -5.0, -5.0), "u_max": (5.0, 5.0, 5.0),
                    "x_min": (1.0, 0.0, -100.0, -100.0, -50.0, -50.0, -50.0),
                    "x_max": (1e20, 500.0, 100.0, 100.0, 50.0, 50.0, 50.0)}
        for name in ("u_min", "u_max", "x_min", "x_max", "Gx", "gx_l", "gx_u", "Gu", "gu_l",
                     "gu_u"):
            v = getattr(self, name)
            if v is None:
                v = defaults.get(name)
            if v is not None:
                object.__setattr__(self, name, torch.as_tensor(v, dtype=torch.float32).to(dev))

    def replace(self, **kw) -> "SCVXConfig":
        return replace(self, **kw)


class SCVXSolution(NamedTuple):
    X: Tensor  # (B, N+1, n_x) the exact rollout of U
    U: Tensor  # (B, N, n_u)
    converged: Tensor  # (B,)
    fuel_used: Tensor  # (B,)
    defect: Tensor  # (B,) max terminal defect of the returned trajectory
    dt: Tensor  # (B,)


def _lanes(x0: Tensor, x_target: Tensor, dt, dtype=torch.float32):
    B = x0.shape[0]
    xT = torch.broadcast_to(x_target.to(x0), (B, x0.shape[1]))
    dt = torch.broadcast_to(torch.as_tensor(dt, dtype=dtype, device=x0.device), (B,))
    return xT, dt


def _rollout(step_fn_dt: Callable, x0: Tensor, U: Tensor, dt: Tensor) -> Tensor:
    xs = [x0]
    for k in range(U.shape[1]):
        xs.append(step_fn_dt(xs[-1], U[:, k], dt[:, None]))
    return torch.stack(xs, dim=1)


def _cost(config: SCVXConfig, B: int, dev):
    """The shared P (nz, nz) and the blocks q is built from."""
    n_x, n_u, N = config.n_x, config.n_u, config.N
    reg = config.w_prox + config.eps_reg
    sel = torch.ones(n_x, device=dev)
    sel[0] = 0.0
    Q_track = config.w_stage * torch.diag(sel)
    Q = Q_track + reg * torch.eye(n_x, device=dev)
    Qf_term = config.w_terminal * torch.diag(sel)
    Qf = Qf_term + reg * torch.eye(n_x, device=dev)
    R = reg * torch.eye(n_u, device=dev)
    P = torch.block_diag(*([Q, R] * N), Qf)
    return P.expand(B, *P.shape), Q_track, Qf_term


def scvx_qp(step_fn_dt: Callable, config: SCVXConfig, x0: Tensor, x_target: Tensor, dt,
            U: Tensor, tr_scale: float = 1.0):
    """One SCP subproblem of every lane: the QP linearized along the exact
    rollout of U (B, N, n_u) from x0 (B, n_x) at the lanes' time steps dt,
    with trust regions scaled by ``tr_scale``. Returns (QPData, X_lin)."""
    N, n_x, n_u = config.N, config.n_x, config.n_u
    B, dev = x0.shape[0], x0.device
    xT, dt = _lanes(x0, x_target, dt)
    nz = (N + 1) * n_x + N * n_u
    with span("scvx.rollout"):
        X_lin = _rollout(step_fn_dt, x0, U, dt)
    with span("scvx.linearize"):
        Aks, Bks, cks = trajectory_jacobians(step_fn_dt, X_lin, U, dt[:, None])
    with span("scvx.qp_build"):
        tr_x, tr_u = config.trust_x * tr_scale, config.trust_u * tr_scale
        Xlo = torch.maximum(config.x_min, X_lin - tr_x)
        Xhi = torch.minimum(config.x_max, X_lin + tr_x)
        Ulo = torch.maximum(config.u_min, U - tr_u)
        Uhi = torch.minimum(config.u_max, U + tr_u)
        A, l, u = build_constraints(Aks, Bks, cks, x0, Xlo, Xhi, Ulo, Uhi)
        if config.Gx is not None or config.Gu is not None:
            A_ext, l_ext, u_ext = build_stage_rows(N, n_x, n_u, config.Gx, config.gx_l,
                                                   config.gx_u, config.Gu, config.gu_l,
                                                   config.gu_u)
            A = torch.cat([A, A_ext.expand(B, *A_ext.shape)], dim=1)
            l = torch.cat([l, l_ext.expand(B, -1)], dim=1)
            u = torch.cat([u, u_ext.expand(B, -1)], dim=1)
        P, Q_track, Qf_term = _cost(config, B, dev)
        alphas = torch.linspace(0.0, 1.0, N + 1, device=dev)[None, :, None]
        X_ref = (1 - alphas) * x0[:, None] + alphas * xT[:, None]
        qx = -(X_ref[:, :-1] @ Q_track.T) - config.w_prox * X_lin[:, :-1]
        qu = -config.w_prox * U
        qN = -(xT @ Qf_term.T) - config.w_prox * X_lin[:, -1]
        q = torch.cat([torch.cat([qx, qu], dim=2).reshape(B, -1), qN], dim=1)
        fuel = torch.zeros(nz, device=dev)
        fuel[nz - n_x] = config.w_fuel  # the linear true-fuel term on m_N
    return QPData(P=P, q=q - fuel, A=A, l=l, u=u), X_lin


def scvx_solve(step_fn_dt: Callable, config: SCVXConfig, x0: Tensor, x_target: Tensor, dt,
               X_init: Optional[Tensor] = None, U_init: Optional[Tensor] = None
               ) -> SCVXSolution:
    """Fixed-final-time SCVX for every lane: ``step_fn_dt(x (B, n_x), u (B,
    n_u), dt (B, 1)) → x⁺`` (unbatched vectors and a (1,) dt under the
    Jacobians' vmap); x0 (B, n_x) or (n_x,), x_target (n_x,) or (B, n_x), dt
    a number or (B,). ``config.iterations`` SCP iterations, each one batched
    QP solve with ρ carried from the last. A lane is converged when its last
    subproblem was accepted and the exact rollout's terminal defect is
    below 1. ``X_init`` is accepted for signature parity: every iteration
    re-linearizes along the exact rollout of U."""
    single = x0.dim() == 1
    x0 = x0[None] if single else x0
    B, dev = x0.shape[0], x0.device
    N, n_x, n_u = config.N, config.n_x, config.n_u
    xT, dt = _lanes(x0, x_target, dt)
    if U_init is None:
        U = x0.new_zeros(B, N, n_u)
        U[:, :, 0] = x0[:, :1]
    else:
        U = torch.broadcast_to(U_init, (B, N, n_u)).clone()
    rho = torch.full((B,), config.admm.rho, device=dev)
    tr_scale = 1.0
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(config.iterations):
        data, X_lin = scvx_qp(step_fn_dt, config, x0, xT, dt, U, tr_scale)
        with span("scvx.solve"):
            sol = solve(data, join_z(X_lin, U), None, _sparse_admm_cfg(config), rho0=rho)
        with span("scvx.accept"):
            ok = (sol.status == SOLVED) | (sol.pri_res < config.accept_pri_tol)
            _, U_new = split_z(sol.x, N, n_x, n_u)
            U = torch.where(ok[:, None, None], U_new, U)
        rho = sol.rho
        tr_scale *= config.trust_shrink
    with span("scvx.rollout"):
        X = _rollout(step_fn_dt, x0, U, dt)
    defect = (X[:, -1, 1:] - xT[:, 1:]).abs().amax(dim=1)
    out = SCVXSolution(X=X, U=U, converged=ok & (defect < 1.0), fuel_used=x0[:, 0] - X[:, -1, 0],
                       defect=defect, dt=dt)
    return SCVXSolution(*(t[0] for t in out)) if single else out


def scvx_free_time(step_fn_dt: Callable, config: SCVXConfig, x0: Tensor, x_target: Tensor,
                   dt_candidates: Tensor) -> SCVXSolution:
    """Free final time by a sweep over candidate time steps (C,): every
    (initial state, candidate) pair is a lane of one :func:`scvx_solve`, and
    each initial state keeps its lowest-fuel converged candidate, or its
    lowest-defect one where none converged (``argmin`` on the device)."""
    single = x0.dim() == 1
    x0 = x0[None] if single else x0
    B, C = x0.shape[0], dt_candidates.shape[0]
    xT = torch.broadcast_to(x_target.to(x0), x0.shape)
    dts = dt_candidates.to(x0).repeat(B)
    sols = scvx_solve(step_fn_dt, config, x0.repeat_interleave(C, dim=0),
                      xT.repeat_interleave(C, dim=0), dts)
    with span("scvx.select"):
        conv = sols.converged.reshape(B, C)
        score = torch.where(conv, sols.fuel_used.reshape(B, C), torch.inf)
        score = torch.where(conv.any(dim=1, keepdim=True), score, sols.defect.reshape(B, C))
        pick = torch.arange(B, device=x0.device) * C + score.argmin(dim=1)
        out = SCVXSolution(*(t[pick] for t in sols))
    return SCVXSolution(*(t[0] for t in out)) if single else out


class SimpleSCVX:
    """PD-rollout reference generator fallback: no optimization, a
    dynamically feasible descent profile for every lane."""

    def __init__(self, step_fn_dt: Callable, config: Optional[SCVXConfig] = None,
                 device: DeviceLike = "cuda"):
        self.step_fn_dt = step_fn_dt
        self.config = config or SCVXConfig(device=device)

    def generate(self, x0: Tensor, x_target: Tensor, dt: float,
                 n_steps: Optional[int] = None) -> SCVXSolution:
        single = x0.dim() == 1
        x0 = x0[None] if single else x0
        N = n_steps or self.config.N
        kp, kd = 0.4, 1.2
        xT, dts = _lanes(x0, x_target, dt)
        lo, hi = float(self.config.u_min[0]), float(self.config.u_max[0])
        xs, us = [x0], []
        for _ in range(N):
            x = xs[-1]
            g_comp = torch.cat([x[:, :1], torch.zeros_like(x[:, 1:3])], dim=1)  # cancels −1 gravity
            u = g_comp + kp * (xT[:, 1:4] - x[:, 1:4]) + kd * (xT[:, 4:7] - x[:, 4:7])
            T = torch.linalg.vector_norm(u, dim=1, keepdim=True)
            u = u * T.clamp(lo, hi) / T.clamp_min(1e-8)
            us.append(u)
            xs.append(self.step_fn_dt(x, u, dts[:, None]))
        X, U = torch.stack(xs, dim=1), torch.stack(us, dim=1)
        out = SCVXSolution(X=X, U=U, converged=torch.ones_like(dts, dtype=torch.bool),
                           fuel_used=x0[:, 0] - X[:, -1, 0],
                           defect=(X[:, -1, 1:4] - xT[:, 1:4]).abs().amax(dim=1), dt=dts)
        return SCVXSolution(*(t[0] for t in out)) if single else out


SCVXSolver = scvx_solve  # the JAX package's alias
