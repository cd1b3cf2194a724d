"""GP-augmented MPC: the SCP loop over the batched condensed QP solver
(counterpart of ``gpmpc_tpu/mpc/gp_mpc.py``), batch-first.

One call of :func:`gp_mpc_solve` is one control cycle for B lanes: the
GP-augmented re-anchoring rollout, then ``scp_iterations`` of {AD
linearization of the nominal dynamics, GP posterior mean and variance at
every knot, linear covariance propagation and box chance tightening,
condensed QP build, warm-started ADMM solve, acceptance}.

Not in this slice (``NotImplementedError``): the sparse (non-condensed) QP
form, ``solver="ipm"``, ``warm_kkt`` and facet/linearized state rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from .._device import DeviceLike, as_f32, resolve_device
from ..dynamics.linearize import trajectory_jacobians
from ..ops.qp import SOLVED, build_condensed_qp, recover_states, solve
from .constraints import normal_quantile
from .rti import RTIConfig, _condensed_admm_cfg, _gx_rows, _n_bound_states, _n_extra_rows
from .uncertainty_prop import box_tightening, propagate_linear

Tensor = torch.Tensor


@dataclass(frozen=True)
class GPMPCConfig:
    """Field names and defaults are those of the JAX ``GPMPCConfig``."""

    base: RTIConfig = field(default_factory=RTIConfig)
    scp_iterations: int = 5
    trust_region_x: float = 10.0
    trust_region_u: float = 5.0
    convergence_tol: float = 1e-4
    tighten: bool = True
    confidence: float = 0.95
    sigma0_scale: float = 1e-6
    beta_method: str = "quantile"
    beta_fixed: float = 2.0
    beta_calibration: float = 1.0
    tighten_mask: Optional[Tensor] = None
    augment_rollout: bool = True
    warm_kkt: bool = False
    rollout_gp_tape: bool = False

    def replace(self, **kw) -> "GPMPCConfig":
        return replace(self, **kw)


class GPMPCSolution(NamedTuple):
    X_opt: Tensor  # (B, N+1, n_x)
    U_opt: Tensor  # (B, N, n_u)
    u0: Tensor  # (B, n_u)
    cost: Tensor  # (B,)
    scp_iters: int
    converged: Tensor  # (B,)
    success: Tensor  # (B,)
    Sigmas: Tensor  # (B, N+1, n_x, n_x) propagated covariances


@dataclass
class GPMPCState:
    """Warm-start carry across control steps, one row per lane."""

    X_lin: Tensor  # (B, N+1, n_x)
    U_lin: Tensor  # (B, N, n_u)
    x_ref: Tensor  # (B, N+1, n_x)
    rho: Tensor  # (B,)
    y_prev: Tensor  # (B, m) ADMM dual warm start

    def replace(self, **kw) -> "GPMPCState":
        return replace(self, **kw)


def _check_supported(config: GPMPCConfig) -> None:
    cfg = config.base
    if config.warm_kkt:
        raise NotImplementedError(
            "GP-MPC warm_kkt is not ported (the condensed path never needs it; "
            "the sparse form arrives with a later slice)")
    if not cfg.condensed:
        raise NotImplementedError(
            "the sparse (condensed=False) GP-MPC QP is not ported yet")
    if cfg.solver != "admm":
        raise NotImplementedError(f"solver={cfg.solver!r} is not ported yet")
    if cfg.stage_rows_fn is not None or cfg.Gx is not None or cfg.Gu is not None:
        raise NotImplementedError(
            "facet / linearized state rows arrive with the 6-DoF slice")


def _rollout(step_fn, x0, U, dt, residual_fn):
    """Forward simulate x⁺ = F(x,u) + dt·residual_fn(k, x, u)."""
    xs = [x0]
    x = x0
    for k in range(U.shape[1]):
        x = step_fn(x, U[:, k]) + dt * residual_fn(k, x, U[:, k])
        xs.append(x)
    return torch.stack(xs, dim=1)


def _tightened_bounds(config: GPMPCConfig, Aks, X_lin, U_lin, gp_vars):
    """Propagate the covariance along the plan and intersect the trust
    region, the absolute bounds and the chance back-offs. Returns
    (Sigmas (B,N+1,n_x,n_x), (Xlo, Xhi, Ulo, Uhi))."""
    cfg = config.base
    n_x = cfg.n_x
    dev = X_lin.device
    Sigma0 = config.sigma0_scale * torch.eye(n_x, dtype=X_lin.dtype, device=dev)
    prop = propagate_linear(Aks, X_lin, Sigma0, gp_vars, cfg.dt)
    if config.tighten:
        if config.beta_method == "fixed":
            kap = torch.tensor(config.beta_fixed, device=dev)
        elif config.beta_method == "calibrated":
            kap = config.beta_calibration * normal_quantile(
                torch.tensor(config.confidence, device=dev))
        elif config.beta_method == "quantile":
            kap = None
        else:
            raise ValueError(
                f"beta_method={config.beta_method!r}; expected "
                "'quantile', 'fixed', or 'calibrated'")
        backoff = box_tightening(prop.covariances, config.confidence, kappa=kap)
        # never let back-offs cross a narrow box: cap at 40% of the width
        backoff = torch.minimum(backoff, 0.4 * (cfg.x_max - cfg.x_min))
        if config.tighten_mask is None:
            tmask = torch.ones(n_x, dtype=X_lin.dtype, device=dev)
            tmask[:2] = 0.0  # never back off mass or the altitude floor
            if n_x == 14:
                tmask[7:11] = 0.0
        else:
            tmask = as_f32(config.tighten_mask, dev)
        backoff = backoff * tmask
    else:
        backoff = torch.zeros_like(X_lin)

    # trust region ∩ absolute bounds ∩ chance back-offs
    Xlo = torch.maximum(cfg.x_min + backoff, X_lin - config.trust_region_x)
    Xhi = torch.minimum(cfg.x_max - backoff, X_lin + config.trust_region_x)
    Ulo = torch.maximum(cfg.u_min, U_lin - config.trust_region_u)
    Uhi = torch.minimum(cfg.u_max, U_lin + config.trust_region_u)
    return prop.covariances, (Xlo, Xhi, Ulo, Uhi)


def gp_mpc_solve(
    step_fn: Callable[[Tensor, Tensor], Tensor],
    gp_mean_fn: Callable[[Tensor, Tensor], Tensor],
    gp_var_fn: Callable[[Tensor, Tensor], Tensor],
    config: GPMPCConfig,
    state: GPMPCState,
    x0: Tensor,
) -> Tuple[GPMPCSolution, GPMPCState]:
    """One receding-horizon GP-MPC solve for every lane.

    - ``step_fn(x, u) → x⁺``: nominal discrete dynamics on (…, n_x), (…, n_u);
      free of in-place ops (it is differentiated with ``torch.func``).
    - ``gp_mean_fn(X, U) → (…, n_x)`` lifted residual mean and
      ``gp_var_fn(X, U) → (…, n_gp)`` posterior variances, any leading dims.
    - ``x0`` (B, n_x): the measured states.
    """
    _check_supported(config)
    cfg = config.base
    N, n_u, dt = cfg.N, cfg.n_u, cfg.dt
    Bsz = x0.shape[0]

    # re-anchor: forward-simulate the warm-start controls from the measured
    # state so the linearization trajectory is dynamically consistent.
    # The record_function spans name the cycle's stages in a torch.profiler
    # trace (gpmpc_tpu_torch/profile_cycle.py reads them).
    with record_function("gpmpc.rollout"):
        if config.augment_rollout and config.rollout_gp_tape:
            # frozen residual tape: one batched GP eval at the incumbent knots
            tape = gp_mean_fn(state.X_lin[:, :-1], state.U_lin)
            X_sim = _rollout(step_fn, x0, state.U_lin, dt, lambda k, x, u: tape[:, k])
        elif config.augment_rollout:
            X_sim = _rollout(step_fn, x0, state.U_lin, dt, lambda k, x, u: gp_mean_fn(x, u))
        else:
            X_sim = _rollout(step_fn, x0, state.U_lin, dt, lambda k, x, u: torch.zeros_like(x))

    admm_cfg = _condensed_admm_cfg(cfg)
    X_lin, U_lin = X_sim, state.U_lin
    rho, y_prev = state.rho, state.y_prev
    done = torch.zeros(Bsz, dtype=torch.bool, device=x0.device)
    any_ok = torch.zeros_like(done)
    Sigmas = None
    for _ in range(config.scp_iterations):
        # linearize the NOMINAL dynamics; the GP mean enters only the affine
        # defect term c_k
        with record_function("gpmpc.linearize"):
            Aks, Bks, cks_nom = trajectory_jacobians(step_fn, X_lin, U_lin)
        with record_function("gpmpc.gp_posterior"):
            cks = cks_nom + dt * gp_mean_fn(X_lin[:, :-1], U_lin)
            gp_vars = gp_var_fn(X_lin[:, :-1], U_lin)

        # uncertainty propagation + tightened per-stage box bounds
        with record_function("gpmpc.propagate_tighten"):
            Sigmas, (Xlo, Xhi, Ulo, Uhi) = _tightened_bounds(
                config, Aks, X_lin, U_lin, gp_vars)

        with record_function("gpmpc.qp_build"):
            Gx_r, gx_l_r, gx_u_r = _gx_rows(cfg, X_lin)
            data, Gs, ds = build_condensed_qp(
                Aks, Bks, cks, x0, cfg.Q, cfg.R, cfg.Qf, state.x_ref,
                Xlo, Xhi, Ulo, Uhi, Gx_r, gx_l_r, gx_u_r, cfg.Gu, cfg.gu_l, cfg.gu_u,
                x_bound_mask=cfg.x_bound_mask,
            )
        with record_function("gpmpc.admm_solve"):
            sol = solve(data, U_lin.reshape(Bsz, -1), y_prev, admm_cfg, rho0=rho)
        U_new = sol.x.reshape(Bsz, N, n_u)
        X_new = recover_states(Gs, ds, sol.x, x0)

        # accept primal-feasible plans below the tolerance even when the dual
        # termination test has not fired
        ok = (sol.status == SOLVED) | (sol.pri_res <= cfg.accept_pri_tol)
        X_new = torch.where(ok[:, None, None], X_new, X_lin)
        U_new = torch.where(ok[:, None, None], U_new, U_lin)

        dX = ((X_new - X_lin).abs().amax(dim=(1, 2))
              + (U_new - U_lin).abs().amax(dim=(1, 2)))
        # a REJECTED solve leaves the iterate unchanged (dX = 0): that is a
        # failure, not convergence
        newly_done = ok & (dX < config.convergence_tol)
        X_lin = torch.where(done[:, None, None], X_lin, X_new)
        U_lin = torch.where(done[:, None, None], U_lin, U_new)
        # carry the duals even when the plan is rejected (OSQP workspace)
        y_prev = torch.where(done[:, None], y_prev, sol.y)
        rho = sol.rho
        done = done | newly_done
        any_ok = any_ok | ok

    X_opt, U_opt = X_lin, U_lin
    # re-anchor the trajectory at the measured state for the next cycle
    X_shift = torch.cat([X_opt[:, 1:], X_opt[:, -1:]], dim=1)
    U_shift = torch.cat([U_opt[:, 1:], U_opt[:, -1:]], dim=1)
    new_state = state.replace(X_lin=X_shift, U_lin=U_shift, rho=rho, y_prev=y_prev)

    e = X_opt - state.x_ref
    cost = (torch.einsum("bki,ij,bkj->b", e[:, :-1], cfg.Q, e[:, :-1])
            + torch.einsum("bki,ij,bkj->b", U_opt, cfg.R, U_opt)
            + torch.einsum("bi,ij,bj->b", e[:, -1], cfg.Qf, e[:, -1]))
    return (
        GPMPCSolution(
            X_opt=X_opt, U_opt=U_opt, u0=U_opt[:, 0], cost=cost,
            scp_iters=config.scp_iterations, converged=done,
            success=any_ok, Sigmas=Sigmas,
        ),
        new_state,
    )


def gp_mpc_init(
    config: GPMPCConfig, x0, x_target,
    X_init: Optional[Tensor] = None, U_init: Optional[Tensor] = None,
    device: DeviceLike = "cuda",
) -> GPMPCState:
    """Initial state for a batch of lanes: x0 (B, n_x), x_target (n_x,).
    The linearization trajectory interpolates x0 → x_target; the controls
    start at [m₀, 0, 0] (hover thrust in normalized units)."""
    _check_supported(config)
    dev = resolve_device(device)
    cfg = config.base
    N = cfg.N
    x0 = as_f32(x0, dev)
    xT = as_f32(x_target, dev)
    Bsz = x0.shape[0]
    if X_init is None:
        a = torch.linspace(0.0, 1.0, N + 1, device=dev)[None, :, None]
        X_lin = (1 - a) * x0[:, None] + a * xT[None, None]
    else:
        X_lin = as_f32(X_init, dev)
    if U_init is None:
        U_lin = torch.zeros(Bsz, N, cfg.n_u, device=dev)
        U_lin[:, :, 0] = x0[:, 0:1]
    else:
        U_lin = as_f32(U_init, dev)
    m = N * (_n_bound_states(cfg) + cfg.n_u) + _n_extra_rows(cfg)
    return GPMPCState(
        X_lin=X_lin, U_lin=U_lin,
        x_ref=xT.expand(Bsz, N + 1, cfg.n_x).clone(),
        rho=torch.full((Bsz,), cfg.admm.rho, device=dev),
        y_prev=torch.zeros(Bsz, m, device=dev),
    )
