"""GP-augmented MPC: the SCP loop over the batched condensed QP solver
(counterpart of ``gpmpc_tpu/mpc/gp_mpc.py``), batch-first.

One call of :func:`gp_mpc_solve` is one control cycle for B lanes: the
GP-augmented re-anchoring rollout, then ``scp_iterations`` of {AD
linearization of the nominal dynamics, GP posterior mean and variance at
every knot, linear covariance propagation and box chance tightening,
condensed QP build, warm-started ADMM solve, acceptance}.

The QP is the condensed one (``base.condensed=True``, controls only) or the
sparse one (z = [X;U] with the dynamics as equality rows, the RTI default).
Facet rows (``Gx``/``Gu``) of the base config enter either form; per-cycle
linearized state rows (``stage_rows_fn(X_lin (B,N+1,n_x)) → Gx
(B,N,n_gx,n_x), gx_l, gx_u``) enter the condensed one, as in the JAX package.

``base.solver="ipm"`` solves the condensed QP with the interior-point
solver; the ADMM carry (ρ and duals) rides through it.

``warm_kkt`` (the sparse form only, as in the JAX package) carries the KKT
inverse across SCP iterations and control steps: :func:`gp_mpc_init`
(given ``step_fn`` and the live ``gp_mean_fn``) freezes each lane's Ruiz
scaling on the QP of the augmented rollout from x0 and factors it once;
every subproblem then refreshes the inverse by Newton–Schulz, and a lane
whose SCP loop is done keeps its inverse. The condensed form with
``warm_kkt`` raises ``ValueError``: its matrix is rebuilt by every
re-linearization and the refresh loses track of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .._device import DeviceLike, as_f32, device_constant, resolve_device
from ..dynamics.linearize import residual_rollout, trajectory_jacobians
from ..ops.kernels.rollout_linearize import fused, rollout_linearize
from ..ops.qp import (SOLVED, IPMConfig, Scaling, build_condensed_qp, build_mpc_qp, extend_qp,
                      join_z, recover_states, solve, solve_ipm, split_z)
from ..utils.profiler import span
from . import cycle_replay
from .constraints import quantile_constant
from .rti import (RTIConfig, _condensed_admm_cfg, _gx_rows, _n_rows, _sparse_admm_cfg,
                  _stage_rows, init_kkt_carry)
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
    # the warm-KKT carry (None unless config.warm_kkt), as in RTIState
    kkt_inv: Optional[Tensor] = None  # (B, n, n)
    scal_D: Optional[Tensor] = None
    scal_E: Optional[Tensor] = None
    scal_c: Optional[Tensor] = None

    def replace(self, **kw) -> "GPMPCState":
        return replace(self, **kw)


def _check_supported(config: GPMPCConfig) -> None:
    cfg = config.base
    if config.warm_kkt and cfg.condensed:
        raise ValueError(
            "condensed GP-MPC does not support warm_kkt (and does not need it: the "
            "condensed factorization is cheap; use condensed alone)")
    if cfg.solver == "ipm" and not cfg.condensed:
        raise ValueError(
            "solver='ipm' requires the condensed form (the sparse z=[X;U] "
            "layout interleaves its dynamics equality rows)")
    if cfg.stage_rows_fn is not None and not cfg.condensed:
        raise ValueError("stage_rows_fn (linearized state rows) requires condensed=True")


def fused_rollout(step_fn, config: GPMPCConfig, x0: Tensor) -> bool:
    """Whether the rollout and the first linearization go to the step's
    kernel (``ops/kernels/rollout_linearize.py``, one launch on the card):
    where the residual is the frozen GP tape or zero and the kernel computes
    what the eager route computes (:func:`fused`). The GP inside the
    rollout loop keeps the eager route."""
    return (config.rollout_gp_tape or not config.augment_rollout) and fused(step_fn, x0)


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
        # device constants made once: no copy, no wait
        if config.beta_method == "fixed":
            kap = device_constant(config.beta_fixed, torch.float32, dev)
        elif config.beta_method == "calibrated":
            kap = config.beta_calibration * quantile_constant(config.confidence,
                                                              torch.float32, dev)
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

    On the card a cycle that never reads the device from the host, with a
    fused rollout and GP callables that declare a frozen posterior, is
    replayed from CUDA-graph segments from its third call on
    (``mpc/cycle_replay.py``); every other call runs eagerly. Both routes
    run the same kernels and return tensors that belong to the caller.
    """
    _check_supported(config)
    return cycle_replay.run(_cycle, step_fn, gp_mean_fn, gp_var_fn, config, state, x0,
                            fused_rollout(step_fn, config, x0))


def _cycle(step_fn, gp_mean_fn, gp_var_fn, config: GPMPCConfig, state: GPMPCState,
           x0: Tensor) -> Tuple[GPMPCSolution, GPMPCState]:
    """The eager cycle of :func:`gp_mpc_solve`."""
    cfg = config.base
    N, n_u, dt = cfg.N, cfg.n_u, cfg.dt
    Bsz = x0.shape[0]

    # re-anchor: forward-simulate the warm-start controls from the measured
    # state so the linearization trajectory is dynamically consistent.
    # The spans (utils.profiler.span) name the cycle's stages in a
    # torch.profiler trace; portbench/core/trace.py and profile_cycle.py
    # read them.
    # The fused route also linearizes the rollout for the first SCP
    # iteration (lin), inside this span.
    lin = None
    with span("gpmpc.rollout"):
        # frozen residual tape: one batched GP eval at the incumbent knots
        tape = (gp_mean_fn(state.X_lin[:, :-1], state.U_lin)
                if config.augment_rollout and config.rollout_gp_tape else None)
        if fused_rollout(step_fn, config, x0):
            X_sim, *lin = rollout_linearize(step_fn, x0.contiguous(), state.U_lin.contiguous(),
                                            None if tape is None else tape.contiguous(), dt=dt)
        elif config.augment_rollout and not config.rollout_gp_tape:
            X_sim = residual_rollout(step_fn, x0, state.U_lin, dt,
                                     lambda k, x, u: gp_mean_fn(x, u))
        else:  # the tape, or a zero residual without augmentation
            X_sim = residual_rollout(step_fn, x0, state.U_lin, dt,
                                     (lambda k, x, u: torch.zeros_like(x)) if tape is None
                                     else (lambda k, x, u: tape[:, k]))

    admm_cfg = _condensed_admm_cfg(cfg) if cfg.condensed else _sparse_admm_cfg(cfg)
    X_lin, U_lin = X_sim, state.U_lin
    rho, y_prev, kkt_inv = state.rho, state.y_prev, state.kkt_inv
    done = torch.zeros(Bsz, dtype=torch.bool, device=x0.device)
    any_ok = torch.zeros_like(done)
    Sigmas = None
    for it in range(config.scp_iterations):
        # linearize the NOMINAL dynamics; the GP mean enters only the affine
        # defect term c_k
        with span("gpmpc.linearize"):
            if it == 0 and lin is not None:
                Aks, Bks, cks_nom = lin
            else:
                Aks, Bks, cks_nom = trajectory_jacobians(step_fn, X_lin, U_lin)
        with span("gpmpc.gp_posterior"):
            cks = cks_nom + dt * gp_mean_fn(X_lin[:, :-1], U_lin)
            gp_vars = gp_var_fn(X_lin[:, :-1], U_lin)

        # uncertainty propagation + tightened per-stage box bounds
        with span("gpmpc.propagate_tighten"):
            Sigmas, (Xlo, Xhi, Ulo, Uhi) = _tightened_bounds(
                config, Aks, X_lin, U_lin, gp_vars)

        if cfg.condensed:
            with span("gpmpc.qp_build"):
                Gx_r, gx_l_r, gx_u_r = _gx_rows(cfg, X_lin)
                data, Gs, ds = build_condensed_qp(
                    Aks, Bks, cks, x0, cfg.Q, cfg.R, cfg.Qf, state.x_ref,
                    Xlo, Xhi, Ulo, Uhi, Gx_r, gx_l_r, gx_u_r, cfg.Gu, cfg.gu_l, cfg.gu_u,
                    x_bound_mask=cfg.x_bound_mask,
                )
            if cfg.solver == "ipm":
                # the box QP has no equality rows once x0 is eliminated; the
                # IPM's f32 duals do not enter the carried ADMM workspace
                with span("gpmpc.ipm"):
                    sol = replace(solve_ipm(data, IPMConfig(n_eq=0, iters=cfg.ipm_iters)),
                                  rho=rho, y=y_prev)
            else:
                with span("gpmpc.admm_solve"):
                    sol = solve(data, U_lin.reshape(Bsz, -1), y_prev, admm_cfg, rho0=rho)
            U_new = sol.x.reshape(Bsz, N, n_u)
            X_new = recover_states(Gs, ds, sol.x, x0)
        else:
            with span("gpmpc.qp_build"):
                data = build_mpc_qp(Aks, Bks, cks, x0, cfg.Q, cfg.R, cfg.Qf, state.x_ref,
                                    Xlo, Xhi, Ulo, Uhi)
                if cfg.Gx is not None or cfg.Gu is not None:
                    # facet rows ride along in every SCP subproblem, as in RTI
                    data = extend_qp(data, *_stage_rows(cfg))
            with span("gpmpc.admm_solve"):
                if config.warm_kkt:
                    sol = solve(data, join_z(X_lin, U_lin), y_prev, admm_cfg, rho0=rho,
                                fixed_scaling=Scaling(D=state.scal_D, E=state.scal_E,
                                                      c=state.scal_c),
                                kkt_inv0=kkt_inv)
                    # a lane whose SCP loop is done keeps its inverse, so that
                    # later steps resume the refresh from its last live one
                    kkt_inv = torch.where(done[:, None, None], kkt_inv, sol.kkt_inv)
                else:
                    sol = solve(data, join_z(X_lin, U_lin), y_prev, admm_cfg, rho0=rho)
            X_new, U_new = split_z(sol.x, N, cfg.n_x, n_u)

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
    new_state = state.replace(X_lin=X_shift, U_lin=U_shift, rho=rho, y_prev=y_prev,
                              **({"kkt_inv": kkt_inv} if config.warm_kkt else {}))

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
    step_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
    gp_mean_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
    device: DeviceLike = "cuda",
) -> GPMPCState:
    """Initial state for a batch of lanes: x0 (B, n_x), x_target (n_x,).
    The linearization trajectory interpolates x0 → x_target; the controls
    start at [m₀, 0, 0] (hover thrust in normalized units). With
    ``config.warm_kkt`` pass ``step_fn`` (and the live ``gp_mean_fn``, if
    any): each lane's Ruiz scaling and KKT inverse come from the QP of the
    augmented rollout from x0, the one the first SCP iteration sees."""
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
    x_ref = xT.expand(Bsz, N + 1, cfg.n_x).clone()
    warm = {}
    if config.warm_kkt:
        if step_fn is None:
            raise ValueError("warm_kkt requires gp_mpc_init(..., step_fn=...)")
        mean = gp_mean_fn or (lambda x, u: torch.zeros_like(x))
        X_fact = residual_rollout(step_fn, x0, U_lin, cfg.dt, lambda k, x, u: mean(x, u))
        Aks, Bks, cks = trajectory_jacobians(step_fn, X_fact, U_lin)
        data = build_mpc_qp(Aks, Bks, cks, x0, cfg.Q, cfg.R, cfg.Qf, x_ref,
                            cfg.x_min, cfg.x_max, cfg.u_min, cfg.u_max)
        if cfg.Gx is not None or cfg.Gu is not None:
            data = extend_qp(data, *_stage_rows(cfg))
        warm = init_kkt_carry(data, _sparse_admm_cfg(cfg))
    return GPMPCState(
        X_lin=X_lin, U_lin=U_lin, x_ref=x_ref,
        rho=torch.full((Bsz,), cfg.admm.rho, device=dev),
        y_prev=torch.zeros(Bsz, _n_rows(cfg), device=dev), **warm)


def make_gp_mpc_controller(
    step_fn, gp_mean_fn, gp_var_fn, config: GPMPCConfig, x_target,
    reference_fn: Optional[Callable[[Tensor], Tensor]] = None, ref_horizon: int = 100,
) -> Tuple[Callable, Callable]:
    """(controller_init, controller_step) for a fleet flown in lockstep, the
    Monte-Carlo protocol: ``cinit(x0s (B, n_x)) → cstate`` and
    ``cstep(cstate, x (B, n_x), k) → (u0 (B, n_u), cstate)`` with the step
    index k a Python int.

    ``reference_fn(x0s) → (B, T, n_x)`` optionally generates each lane's
    descent reference at init; the step then tracks the receding window at
    step min(k, ref_horizon − 1). The reference, padded with its last row
    to ref_horizon + N + 1 rows, rides in the controller state."""
    dev = config.base.device

    def cinit(x0):
        warm = (dict(step_fn=step_fn, gp_mean_fn=gp_mean_fn) if config.warm_kkt else {})
        state = gp_mpc_init(config, x0, x_target, device=dev, **warm)
        if reference_fn is None:
            return state
        X_ref_full = reference_fn(as_f32(x0, dev))
        need = ref_horizon + config.base.N + 1
        pad = X_ref_full[:, -1:].repeat(1, max(need - X_ref_full.shape[1], 1), 1)
        return state, torch.cat([X_ref_full, pad], dim=1)[:, :need]

    def cstep(cstate, x, k: int):
        if reference_fn is None:
            sol, new_state = gp_mpc_solve(step_fn, gp_mean_fn, gp_var_fn, config, cstate, x)
            return sol.u0, new_state
        state, X_ref_full = cstate
        kk = min(int(k), ref_horizon - 1)
        state = state.replace(x_ref=X_ref_full[:, kk : kk + config.base.N + 1])
        sol, new_state = gp_mpc_solve(step_fn, gp_mean_fn, gp_var_fn, config, state, x)
        return sol.u0, (new_state, X_ref_full)

    return cinit, cstep


class SimpleGPPredictor:
    """Augmented-dynamics rollout helper: x⁺ = F(x, u) + dt·gp_mean(x, u)."""

    def __init__(self, step_fn, gp_mean_fn, dt: float = 0.1):
        self.step_fn = step_fn
        self.gp_mean_fn = gp_mean_fn
        self.dt = dt

    def rollout(self, x0: Tensor, U: Tensor) -> Tensor:
        """x0 (B, n_x), U (B, T, n_u) → X (B, T+1, n_x)."""
        return residual_rollout(self.step_fn, x0, U, self.dt,
                                lambda k, x, u: self.gp_mean_fn(x, u))
