"""Real-Time-Iteration MPC on the batched ADMM solver, batch-first
(counterpart of ``gpmpc_tpu/mpc/rti.py``).

One linearize → QP → shift cycle per control step for B lanes at once, with
warm starting from the shifted previous solution and, per lane, fallback to
it when the QP is neither solved nor primal-feasible within
``accept_pri_tol``. The QP is the sparse form (z = [X;U], dynamics as
equality rows; the default) or the condensed one (controls only). The
solver's adapted ρ and duals ride in :class:`RTIState`.

``step_fn(x, u) → x⁺`` is the discrete dynamics on (…, n_x), (…, n_u): it is
called on the whole batch for rollouts and differentiated knot by knot with
``torch.func``, so it must use no in-place ops.

``solver="ipm"`` solves the condensed QP with the interior-point solver
(no equality rows once x0 is eliminated); the ADMM carry (ρ and duals)
rides through it unchanged.

``warm_kkt=True`` carries the KKT inverse across cycles in either form:
:func:`rti_init` (given ``step_fn``) freezes each lane's Ruiz scaling on the
QP the first cycle will see and factors it once; every cycle then solves
under that scaling with the inverse refreshed by Newton–Schulz
(``ADMMConfig.ns_iters``) and carries the refreshed inverse on. It does not
compose with ``solver="ipm"`` (``ValueError``, no inverse to carry).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .._device import DeviceLike, as_f32, resolve_device
from ..dynamics.linearize import trajectory_jacobians
from ..ops.qp import (
    SOLVED,
    ADMMConfig,
    IPMConfig,
    Scaling,
    build_condensed_qp,
    build_mpc_qp,
    build_stage_rows,
    extend_qp,
    join_z,
    recover_states,
    solve,
    solve_ipm,
    split_z,
)
from ..ops.qp.admm import _factor, _rho_vec
from ..ops.qp.ruiz import ruiz_equilibrate
from ..utils.profiler import open_solve_record, span

Tensor = torch.Tensor

_Q_DIAG = (0.0, 10.0, 10.0, 10.0, 1.0, 1.0, 1.0)


@dataclass(frozen=True)
class RTIConfig:
    """RTI settings; field names and defaults are those of the JAX
    ``RTIConfig`` (see there for the meaning of each). The matrices live on
    ``device`` (built once, so the control cycle never copies them); pass
    ``None`` to take the defaults."""

    N: int = 15
    dt: float = 0.1
    n_x: int = 7
    n_u: int = 3
    Q: Optional[torch.Tensor] = None
    R: Optional[torch.Tensor] = None
    Qf: Optional[torch.Tensor] = None
    x_min: Optional[torch.Tensor] = None
    x_max: Optional[torch.Tensor] = None
    u_min: Optional[torch.Tensor] = None
    u_max: Optional[torch.Tensor] = None
    admm: ADMMConfig = field(default_factory=lambda: ADMMConfig(max_iter=100, polish=True))
    solver: str = "admm"
    ipm_iters: int = 20
    warm_start_duals: bool = True
    accept_pri_tol: float = 0.0
    warm_kkt: bool = False
    reanchor: bool = True
    condensed: bool = False
    Gx: Optional[torch.Tensor] = None
    gx_l: Optional[torch.Tensor] = None
    gx_u: Optional[torch.Tensor] = None
    Gu: Optional[torch.Tensor] = None
    gu_l: Optional[torch.Tensor] = None
    gu_u: Optional[torch.Tensor] = None
    x_bound_mask: Optional[tuple] = None
    stage_rows_fn: Optional[Callable] = None
    n_stage_rows: int = 0
    device: DeviceLike = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        defaults = {
            "Q": torch.diag(torch.tensor(_Q_DIAG)),
            "R": torch.eye(3) * 0.01,
            "Qf": torch.diag(torch.tensor(_Q_DIAG) * 10.0),
            "x_min": torch.tensor([-1e20, -100.0, -100.0, -100.0, -50.0, -50.0, -50.0]),
            "x_max": torch.tensor([1e20, 500.0, 100.0, 100.0, 50.0, 50.0, 50.0]),
            "u_min": torch.tensor([0.3, -5.0, -5.0]),
            "u_max": torch.tensor([5.0, 5.0, 5.0]),
        }
        for name, default in defaults.items():
            v = getattr(self, name)
            v = default if v is None else v
            object.__setattr__(self, name, torch.as_tensor(
                v, dtype=torch.float32).to(dev))
        for name in ("Gx", "gx_l", "gx_u", "Gu", "gu_l", "gu_u"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, torch.as_tensor(
                    v, dtype=torch.float32).to(dev))

    def replace(self, **kw) -> "RTIConfig":
        return replace(self, **kw)


def _n_gx_rows(config) -> int:
    """Per-stage state-row count: constant facet block OR linearized rows."""
    if config.stage_rows_fn is not None:
        if config.Gx is not None:
            raise ValueError("stage_rows_fn replaces the Gx block — set Gx=None")
        if config.n_stage_rows <= 0:
            raise ValueError("stage_rows_fn requires n_stage_rows > 0")
        return config.n_stage_rows
    if config.Gx is None:
        return 0
    return config.Gx.shape[1] if config.Gx.dim() == 3 else config.Gx.shape[0]


def _n_extra_rows(config) -> int:
    n_gu = 0 if config.Gu is None else config.Gu.shape[0]
    return config.N * (_n_gx_rows(config) + n_gu)


def _gx_rows(config, X_lin):
    """(Gx, gx_l, gx_u): the configured constant block, or the per-cycle
    linearization around ``X_lin``."""
    if config.stage_rows_fn is not None:
        return config.stage_rows_fn(X_lin)
    return config.Gx, config.gx_l, config.gx_u


def _n_bound_states(config) -> int:
    """State components with condensed bound rows (see x_bound_mask)."""
    if config.x_bound_mask is None:
        return config.n_x
    return sum(bool(b) for b in config.x_bound_mask)


def _condensed_admm_cfg(config) -> ADMMConfig:
    """ADMM config with the condensed QP's row structure declared: state-bound
    rows block-lower-triangular, control-bound rows the identity, state facets
    BLT, control facets block-diagonal. User-set row_structure wins."""
    if config.admm.row_structure is not None:
        return config.admm
    N, n_u = config.N, config.n_u
    n_b = _n_bound_states(config)
    C = next((c for c in (5, 4, 3, 2) if N % c == 0), 1)
    s = N // C
    segs = []
    if n_b:
        segs.append(("blt", C, s * n_b, s * n_u))
    segs.append(("diag", N * n_u))
    n_gx = _n_gx_rows(config)
    if n_gx:
        segs.append(("blt", C, s * n_gx, s * n_u))
    if config.Gu is not None:
        segs.append(("blockdiag_shared", N, config.Gu.shape[0], n_u))
    return config.admm.replace(row_structure=tuple(segs))


def _sparse_row_structure(N: int, n_x: int, n_u: int) -> tuple:
    """The sparse form's rows as ``build_constraints`` lays them out over z =
    [x₀ u₀ x₁ … x_N]: x₀'s identity and the dynamics rows [A_k B_k −I],
    block row i nonzero in its first (i+1)·(n_x+n_u) columns (the last block
    clipped at the n columns), then the identity of the variable bounds.
    Facet rows appended after them stay dense."""
    nz = (N + 1) * n_x + N * n_u
    return (("blt", N + 1, n_x, n_x + n_u), ("diag", nz))


def _sparse_admm_cfg(config) -> ADMMConfig:
    """ADMM config with the sparse form's row structure declared
    (:func:`_sparse_row_structure`), for any config with ``N``, ``n_x``,
    ``n_u`` and ``admm``. User-set row_structure wins."""
    if config.admm.row_structure is not None:
        return config.admm
    return config.admm.replace(
        row_structure=_sparse_row_structure(config.N, config.n_x, config.n_u))


def _stage_rows(config):
    """(A_ext, l_ext, u_ext) for the configured facet rows."""
    if config.Gx is not None and config.Gx.dim() == 3:
        raise ValueError(
            "per-stage (N, n_gx, n_x) Gx requires condensed=True (the "
            "sparse form's build_stage_rows tiles one constant block)")
    return build_stage_rows(
        config.N, config.n_x, config.n_u,
        config.Gx, config.gx_l, config.gx_u, config.Gu, config.gu_l, config.gu_u)


def _build_rti_qp(config, Aks, Bks, cks, x_current, x_ref):
    """The LTV QP plus any configured per-stage facet rows."""
    if config.stage_rows_fn is not None:
        raise ValueError(
            "stage_rows_fn (linearized state rows) requires condensed=True")
    data = build_mpc_qp(
        Aks, Bks, cks, x_current, config.Q, config.R, config.Qf, x_ref,
        config.x_min, config.x_max, config.u_min, config.u_max)
    if config.Gx is not None or config.Gu is not None:
        data = extend_qp(data, *_stage_rows(config))
    return data


def _solve_qp(config, state, Aks, Bks, cks, x_current, z0_XU, y0):
    """Solve every lane's RTI subproblem in the configured formulation;
    returns (sol, X_sol, U_sol). ``z0_XU`` is the (X, U) primal warm start."""
    N = config.N
    X0, U0 = z0_XU
    Bsz = x_current.shape[0]
    # the warm-KKT carry: the frozen scaling and the previous inverse
    warm = (dict(fixed_scaling=Scaling(D=state.scal_D, E=state.scal_E, c=state.scal_c),
                 kkt_inv0=state.kkt_inv) if config.warm_kkt else {})
    if config.condensed:
        with span("rti.qp_build"):
            Gx, gx_l, gx_u = _gx_rows(config, state.X_lin)
            data, Gs, ds = build_condensed_qp(
                Aks, Bks, cks, x_current, config.Q, config.R, config.Qf, state.x_ref,
                config.x_min, config.x_max, config.u_min, config.u_max,
                Gx, gx_l, gx_u, config.Gu, config.gu_l, config.gu_u,
                x_bound_mask=config.x_bound_mask)
        if config.solver == "ipm":
            # the condensed box QP has no equality rows (x0 is eliminated);
            # the IPM has no penalty to carry and its f32 duals do not enter
            # the dual warm start: ρ and y0 ride through
            if config.warm_kkt:
                raise ValueError("solver='ipm' does not compose with warm_kkt "
                                 "(no KKT inverse to carry)")
            with span("rti.ipm"):
                sol = replace(solve_ipm(data, IPMConfig(n_eq=0, iters=config.ipm_iters)),
                              rho=state.rho, y=y0)
        else:
            with span("rti.admm_solve"):
                sol = solve(data, U0.reshape(Bsz, -1), y0, _condensed_admm_cfg(config),
                            rho0=state.rho, **warm)
        return sol, recover_states(Gs, ds, sol.x, x_current), sol.x.reshape(Bsz, N, config.n_u)
    if config.solver == "ipm":
        raise ValueError(
            "solver='ipm' requires the condensed form (the sparse z=[X;U] "
            "layout interleaves its dynamics equality rows)")
    with span("rti.qp_build"):
        data = _build_rti_qp(config, Aks, Bks, cks, x_current, state.x_ref)
    with span("rti.admm_solve"):
        sol = solve(data, join_z(X0, U0), y0, _sparse_admm_cfg(config), rho0=state.rho,
                    **warm)
    X_sol, U_sol = split_z(sol.x, N, config.n_x, config.n_u)
    return sol, X_sol, U_sol


@dataclass
class RTIState:
    """Controller state carried across control steps, one row per lane."""

    X_lin: Tensor  # (B, N+1, n_x) linearization trajectory
    U_lin: Tensor  # (B, N, n_u)
    X_prev: Tensor  # shifted warm start
    U_prev: Tensor
    y_prev: Tensor  # (B, m) dual warm start
    rho: Tensor  # (B,) adapted ADMM penalty
    x_ref: Tensor  # (B, N+1, n_x) reference
    # the warm-KKT carry (None unless config.warm_kkt): the scaled-space KKT
    # inverse (B, n, n) and the Ruiz scaling frozen at init
    kkt_inv: Optional[Tensor] = None
    scal_D: Optional[Tensor] = None  # (B, n)
    scal_E: Optional[Tensor] = None  # (B, m)
    scal_c: Optional[Tensor] = None  # (B,)

    def replace(self, **kw) -> "RTIState":
        return replace(self, **kw)


def freeze_lanes(mask: Tensor, old, new):
    """A state of ``new``'s type with each lane's tensors from ``old`` where
    ``mask`` (B,) is set and from ``new`` elsewhere; a field that is None
    (a warm-KKT carry that is off) stays None."""
    def pick(a, b):
        if a is None:
            return b
        return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)

    return type(new)(**{f.name: pick(getattr(old, f.name), getattr(new, f.name))
                        for f in fields(new)})


class RTISolution(NamedTuple):
    """Per-step output, one row per lane."""

    u0: Tensor  # (B, n_u)
    X_opt: Tensor  # (B, N+1, n_x)
    U_opt: Tensor  # (B, N, n_u)
    cost: Tensor  # (B,) QP objective; inf on a lane that fell back
    iterations: Tensor  # (B,)
    success: Tensor  # (B,)


def _n_rows(config: RTIConfig) -> int:
    N = config.N
    if config.condensed:
        # N state-bound blocks + N control-bound blocks + facets
        return N * (_n_bound_states(config) + config.n_u) + _n_extra_rows(config)
    # equality rows (N+1)·n_x + n_vars bound rows + facet rows
    n_vars = (N + 1) * config.n_x + N * config.n_u
    return (N + 1) * config.n_x + n_vars + _n_extra_rows(config)


def rti_init(
    config: RTIConfig, x0, x_target,
    X_init: Optional[Tensor] = None, U_init: Optional[Tensor] = None,
    u_hover: Optional[Tensor] = None,
    step_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
) -> RTIState:
    """Initial state for a batch of lanes, on ``config.device``: x0 (B, n_x),
    x_target (n_x,). The linearization trajectory interpolates x0 →
    x_target; the controls start at ``u_hover`` ((n_u,) or (B, n_u); default
    [m₀, 0, 0], hover thrust in normalized units). With ``config.warm_kkt``
    pass ``step_fn``: each lane's Ruiz scaling and KKT inverse are computed
    on the QP the first cycle will see (with ``reanchor``, the rollout of the
    controls from x0, not the interpolation: an inverse that starts outside
    the Newton–Schulz convergence region never recovers); only warm_kkt
    reads it."""
    dev = config.device
    N = config.N
    x0 = as_f32(x0, dev)
    xT = as_f32(x_target, dev)
    Bsz = x0.shape[0]
    if X_init is None:
        a = torch.linspace(0.0, 1.0, N + 1, device=dev)[None, :, None]
        X_lin = (1 - a) * x0[:, None] + a * xT[None, None]
    else:
        X_lin = as_f32(X_init, dev)
    if U_init is None:
        if u_hover is None:
            u_hover = torch.zeros(Bsz, config.n_u, device=dev)
            u_hover[:, 0] = x0[:, 0]
        U_lin = as_f32(u_hover, dev).expand(Bsz, config.n_u)[:, None].repeat(1, N, 1)
    else:
        U_lin = as_f32(U_init, dev)
    x_ref = xT.expand(Bsz, N + 1, config.n_x).clone()
    warm = {}
    if config.warm_kkt:
        if step_fn is None:
            raise ValueError("warm_kkt requires rti_init(..., step_fn=...)")
        X_fact = _rollout(step_fn, x0, U_lin) if config.reanchor else X_lin
        Aks, Bks, cks = trajectory_jacobians(step_fn, X_fact, U_lin)
        if config.condensed:
            Gx, gx_l, gx_u = _gx_rows(config, X_fact)
            data, _, _ = build_condensed_qp(
                Aks, Bks, cks, x0, config.Q, config.R, config.Qf, x_ref,
                config.x_min, config.x_max, config.u_min, config.u_max,
                Gx, gx_l, gx_u, config.Gu, config.gu_l, config.gu_u,
                x_bound_mask=config.x_bound_mask)
            admm = config.admm
        else:
            data = _build_rti_qp(config, Aks, Bks, cks, x0, x_ref)
            admm = _sparse_admm_cfg(config)
        warm = init_kkt_carry(data, admm)
    return RTIState(
        X_lin=X_lin, U_lin=U_lin, X_prev=X_lin, U_prev=U_lin,
        y_prev=torch.zeros(Bsz, _n_rows(config), device=dev),
        rho=torch.full((Bsz,), config.admm.rho, device=dev), x_ref=x_ref, **warm)


def init_kkt_carry(data, admm: ADMMConfig) -> dict:
    """The warm-KKT carry of a batch of QPs: the Ruiz scaling (at least 3
    passes) frozen for every later solve and the KKT inverse at ρ =
    ``admm.rho``, as the state fields ``kkt_inv``, ``scal_D``, ``scal_E``,
    ``scal_c``."""
    sdata, scal = ruiz_equilibrate(data, max(admm.scaling, 3))
    rho_v = _rho_vec(sdata.l, sdata.u, torch.full_like(scal.c, admm.rho))
    return dict(kkt_inv=_factor(sdata.P, sdata.A, rho_v, admm.sigma),
                scal_D=scal.D, scal_E=scal.E, scal_c=scal.c)


def _rollout(step_fn, x0, U) -> Tensor:
    """(B, N+1, n_x) forward simulation of the controls U from x0."""
    xs = [x0]
    for k in range(U.shape[1]):
        xs.append(step_fn(xs[-1], U[:, k]))
    return torch.stack(xs, dim=1)


def _shift(T: Tensor) -> Tensor:
    return torch.cat([T[:, 1:], T[:, -1:]], dim=1)


def rti_feedback(config: RTIConfig, state: RTIState, prepared, x_current
                 ) -> Tuple[RTISolution, RTIState]:
    """Feedback phase: pin the measured states and solve. Use with
    :func:`rti_prepare` when the two phases are pipelined around the
    measurement; :func:`rti_step` runs both."""
    Aks, Bks, cks = prepared
    y0 = state.y_prev if config.warm_start_duals else torch.zeros_like(state.y_prev)
    sol, X_sol, U_sol = _solve_qp(
        config, state, Aks, Bks, cks, x_current, (state.X_prev, state.U_prev), y0)
    ok = (sol.status == SOLVED) | (sol.pri_res <= config.accept_pri_tol)
    record = open_solve_record()
    if record is not None:
        admm = None if config.solver == "ipm" else (
            _condensed_admm_cfg if config.condensed else _sparse_admm_cfg)(config)
        record["rti"].append({"iterations": sol.iterations, "admm": admm})
    # fallback: a lane whose QP failed reuses its shifted previous solution
    X_opt = torch.where(ok[:, None, None], X_sol, state.X_prev)
    U_opt = torch.where(ok[:, None, None], U_sol, state.U_prev)
    # the refreshed KKT inverse rides on whether the plan was accepted or not
    new_state = state.replace(
        X_lin=X_opt, U_lin=U_opt, X_prev=_shift(X_opt), U_prev=_shift(U_opt),
        y_prev=torch.where(ok[:, None], sol.y, state.y_prev), rho=sol.rho,
        **({"kkt_inv": sol.kkt_inv} if config.warm_kkt else {}))
    return (
        RTISolution(
            u0=U_opt[:, 0], X_opt=X_opt, U_opt=U_opt,
            cost=torch.where(ok, sol.obj, torch.full_like(sol.obj, float("inf"))),
            iterations=sol.iterations, success=ok),
        new_state,
    )


def rti_prepare(step_fn, config: RTIConfig, state: RTIState):
    """Preparation phase: linearize along the current trajectory *before*
    the measurement arrives. Returns the (Aks, Bks, cks) to hand to
    :func:`rti_feedback`."""
    with span("rti.linearize"):
        return trajectory_jacobians(step_fn, state.X_lin, state.U_lin)


def rti_step(step_fn: Callable[[Tensor, Tensor], Tensor], config: RTIConfig,
             state: RTIState, x_current) -> Tuple[RTISolution, RTIState]:
    """One combined prepare + feedback RTI cycle for every lane; x_current
    is (B, n_x). The span ``rti.step`` encloses the whole cycle."""
    with span("rti.step"):
        if config.reanchor:
            # re-simulate the linearization trajectory from the measured state
            with span("rti.rollout"):
                state = state.replace(X_lin=_rollout(step_fn, x_current, state.U_lin))
        return rti_feedback(config, state, rti_prepare(step_fn, config, state), x_current)


def simple_rti_step(step_fn, config: RTIConfig, state: RTIState, x_current,
                    gd_steps: int = 15, lr: float = 0.05) -> Tuple[Tensor, RTIState]:
    """Gradient-descent fallback without the QP: descend the tracking cost
    of a rollout w.r.t. the control sequence, clipped to the thrust box."""

    def rollout_cost(U):
        E = _rollout(step_fn, x_current, U) - state.x_ref
        return (torch.einsum("bki,ij,bkj->", E, config.Q, E)
                + torch.einsum("bki,ij,bkj->", U, config.R, U))

    U = state.U_lin
    for _ in range(gd_steps):
        U = U.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(rollout_cost(U), U)  # lanes do not couple
        U = torch.minimum(torch.maximum(U.detach() - lr * g, config.u_min), config.u_max)
    U_shift = _shift(U)
    return U[:, 0], state.replace(U_lin=U_shift, U_prev=U_shift)


def make_rti_controller(step_fn, config: RTIConfig, x_target,
                        reference_fn: Optional[Callable[[Tensor], Tensor]] = None,
                        ref_horizon: int = 100) -> Tuple[Callable, Callable]:
    """(controller_init, controller_step) for a fleet flown in lockstep:
    ``cinit(x0s (B, n_x)) → cstate`` and ``cstep(cstate, x (B, n_x), k) →
    (u0 (B, n_u), cstate)`` with the step index k a Python int.

    ``reference_fn(x0s) → (B, T, n_x)`` optionally generates each lane's
    descent reference at init (e.g. ``cubic_descent_reference``); the step
    then tracks the receding window at step k. The reference rides in the
    controller state."""

    def cinit(x0):
        state = rti_init(config, x0, x_target, step_fn=step_fn if config.warm_kkt else None)
        if reference_fn is None:
            return state
        X_ref_full = reference_fn(as_f32(x0, config.device))
        need = ref_horizon + config.N + 1
        pad = X_ref_full[:, -1:].repeat(1, max(need - X_ref_full.shape[1], 1), 1)
        return state, torch.cat([X_ref_full, pad], dim=1)[:, :need]

    def cstep(cstate, x, k: int):
        if reference_fn is None:
            sol, new_state = rti_step(step_fn, config, cstate, x)
            return sol.u0, new_state
        state, X_ref_full = cstate
        kk = min(int(k), ref_horizon - 1)
        state = state.replace(x_ref=X_ref_full[:, kk : kk + config.N + 1])
        sol, new_state = rti_step(step_fn, config, state, x)
        return sol.u0, (new_state, X_ref_full)

    return cinit, cstep


def rti_closed_loop(step_fn, config: RTIConfig, x0, x_target, n_steps: int,
                    landing_altitude: float = 0.1,
                    sim_step_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
                    X_ref_full: Optional[Tensor] = None) -> dict:
    """Closed-loop simulation of every lane: {solve → apply u0 → step →
    check} with landed lanes frozen. ``sim_step_fn`` lets the plant differ
    from the controller model; ``X_ref_full`` (B or 1, ≥ n_steps + N + 1,
    n_x) is an optional time-indexed reference whose receding window each
    step tracks. Returns X (B, n_steps+1, n_x), U (B, n_steps, n_u),
    solver_success (B, n_steps), x_final, landed and steps (B,)."""
    plant = sim_step_fn or step_fn
    x = as_f32(x0, config.device)
    Bsz = x.shape[0]
    state = rti_init(config, x, x_target, step_fn=step_fn if config.warm_kkt else None)
    landed = torch.zeros(Bsz, dtype=torch.bool, device=x.device)
    steps = torch.zeros(Bsz, dtype=torch.int32, device=x.device)
    Xs, Us, succ = [x], [], []
    for k in range(n_steps):
        if X_ref_full is not None:
            window = X_ref_full[:, k : k + config.N + 1]
            state = state.replace(x_ref=window.expand(Bsz, *window.shape[1:]))
        sol, state_new = rti_step(step_fn, config, state, x)
        x_next = plant(x, sol.u0)
        x = torch.where(landed[:, None], x, x_next)
        state = freeze_lanes(landed, state, state_new)
        steps = steps + (~landed).to(torch.int32)
        Xs.append(x)
        Us.append(torch.where(landed[:, None], torch.zeros_like(sol.u0), sol.u0))
        succ.append(sol.success)
        landed = landed | (x_next[:, 1] < landing_altitude)
    return {
        "X": torch.stack(Xs, dim=1), "U": torch.stack(Us, dim=1), "x_final": x,
        "landed": landed, "steps": steps, "solver_success": torch.stack(succ, dim=1),
    }
