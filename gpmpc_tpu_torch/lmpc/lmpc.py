"""Learning MPC with sampled safe sets (counterpart of
``gpmpc_tpu/lmpc/lmpc.py``), lanes first.

One receding-horizon solve per lane: re-anchor the warm-start controls from
the measured state, query the safe set for the terminal vertices around the
predicted terminal state (fuel-filtered, with the endgame fallback), linearize
along the rollout, and solve the MPC QP with the convex-hull terminal
constraint x_N ∈ Conv(vertices) in λ-form with a soft slack and the terminal
cost Qᵀλ. The QP is condensed (z = [U; λ; s]) or sparse (z = [X; U; λ; s]),
solved by the interior-point solver (default, condensed only) or by ADMM
(the chunk kernel on the card). Every lane shares one safe set, frozen
within an episode.

``step_fn(x, u) → x⁺`` is the discrete dynamics on (…, n_x), (…, n_u),
called on the batch for rollouts and differentiated knot by knot with
``torch.func``, so it must use no in-place ops.

Spans (``utils.profiler.span``): ``lmpc.rollout``, ``lmpc.knn``,
``lmpc.linearize``, ``lmpc.qp_build``, ``lmpc.ipm``, ``lmpc.admm_solve``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, fields, replace
from functools import lru_cache
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .._device import DeviceLike, as_f32, resolve_device
from ..dynamics.linearize import trajectory_jacobians
from ..ops.linalg import weighted_sq_dists
from ..ops.qp import (SOLVED, ADMMConfig, IPMConfig, QPData, build_condensed_qp,
                      build_constraints, build_cost, join_z, recover_states, solve,
                      solve_ipm, split_z)
from ..terminal.convex_hull import hull_constraint_rows
from ..terminal.local_safe_set import KNNResult, default_state_weights, knn_query
from ..terminal.safe_set import SafeSet
from ..utils.profiler import span

Tensor = torch.Tensor


@dataclass(frozen=True)
class LMPCConfig:
    """Field names and defaults are those of the JAX ``LMPCConfig`` (see
    there for the meaning and the measurements behind each). The matrices
    live on ``device``; pass ``None`` to take the defaults."""

    N: int = 15
    dt: float = 0.1
    n_x: int = 7
    n_u: int = 3
    n_terminal_vertices: int = 10
    slack_weight: float = 10.0
    lambda_reg: float = 1e-2
    feasibility_tol: float = 1e-2
    Q: Optional[Tensor] = None
    R: Optional[Tensor] = None
    x_min: Optional[Tensor] = None
    x_max: Optional[Tensor] = None
    u_min: Optional[Tensor] = None
    u_max: Optional[Tensor] = None
    admm: ADMMConfig = field(default_factory=lambda: ADMMConfig(
        max_iter=800, polish=True, rho_adapt_chunks=32, scaling=20))
    m_dry: float = 1.0
    fuel_margin: float = 0.0
    fuel_filter_fallback: bool = True
    hull_same_trajectory: bool = False
    candidate_pool: int = 0
    candidate_dist_weight: float = 0.0
    vertex_memory: bool = False
    condensed: bool = True
    x_bound_mask: Optional[tuple] = None
    solver: str = "ipm"
    ipm_iters: int = 20
    touchdown_speed_weight: float = 250.0
    touchdown_gate_altitude: float = 1.5
    touchdown_gate_width: float = 0.25
    touchdown_free_speed: float = 1.0
    device: DeviceLike = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        defaults = {
            "Q": torch.diag(torch.tensor([0.0, 10.0, 10.0, 10.0, 1.0, 1.0, 1.0])),
            "R": torch.eye(3) * 0.01,
            "x_min": torch.tensor([-1e20, -100.0, -100.0, -100.0, -50.0, -50.0, -50.0]),
            "x_max": torch.tensor([1e20, 500.0, 100.0, 100.0, 50.0, 50.0, 50.0]),
            "u_min": torch.tensor([0.3, -5.0, -5.0]),
            "u_max": torch.tensor([5.0, 5.0, 5.0]),
        }
        for name, default in defaults.items():
            v = getattr(self, name)
            object.__setattr__(self, name, as_f32(default if v is None else v, dev))
        if self.x_bound_mask is not None:
            object.__setattr__(self, "x_bound_mask", tuple(bool(b) for b in self.x_bound_mask))

    def replace(self, **kw) -> "LMPCConfig":
        return replace(self, **kw)


class LMPCSolution(NamedTuple):
    """Per-solve output, one row per lane."""

    X_opt: Tensor  # (B, N+1, n_x)
    U_opt: Tensor  # (B, N, n_u)
    u0: Tensor  # (B, n_u)
    lam: Tensor  # (B, K)
    terminal_q: Tensor  # (B,)
    success: Tensor  # (B,)
    slack_norm: Tensor  # (B,)
    qp_status: Tensor  # (B,)
    qp_pri_res: Tensor  # (B,)


@dataclass
class LMPCState:
    """Warm-start carry across control steps, one row per lane."""

    X_lin: Tensor  # (B, N+1, n_x)
    U_lin: Tensor  # (B, N, n_u)
    x_ref: Tensor  # (B, N+1, n_x)
    rho: Tensor  # (B,)
    # the previous solve's terminal-vertex indices (−1 = unset); read only
    # with config.vertex_memory
    prev_vertices: Tensor  # (B, K) int32

    def replace(self, **kw) -> "LMPCState":
        return replace(self, **kw)


def lmpc_init(config: LMPCConfig, x0, x_target, prev_vertices: Optional[Tensor] = None
              ) -> LMPCState:
    """Initial state for x0 (B, n_x): the linearization trajectory
    interpolates x0 → x_target, the controls start at [m₀, 0, 0]."""
    dev = config.device
    N = config.N
    x0 = as_f32(x0, dev)
    xT = as_f32(x_target, dev)
    Bsz = x0.shape[0]
    a = torch.linspace(0.0, 1.0, N + 1, device=dev)[None, :, None]
    U = torch.zeros(Bsz, N, config.n_u, device=dev)
    U[:, :, 0] = x0[:, 0:1]
    K = config.n_terminal_vertices
    pv = (torch.full((Bsz, K), -1, dtype=torch.int32, device=dev) if prev_vertices is None
          else torch.as_tensor(prev_vertices, device=dev).to(torch.int32).expand(Bsz, K).clone())
    return LMPCState(
        X_lin=(1 - a) * x0[:, None] + a * xT[None, None], U_lin=U,
        x_ref=xT.expand(Bsz, N + 1, config.n_x).clone(),
        rho=torch.full((Bsz,), config.admm.rho, device=dev), prev_vertices=pv)


def _rollout(step_fn, x0: Tensor, U: Tensor) -> Tensor:
    xs = [x0]
    for k in range(U.shape[1]):
        xs.append(step_fn(xs[-1], U[:, k]))
    return torch.stack(xs, dim=1)


def _best_k(res: KNNResult, K: int, dist_weight: float) -> KNNResult:
    """Each lane's K lowest-score valid candidates, score q + w·d²
    (invalid rows sort last and stay invalid)."""
    score = torch.where(res.valid, res.q_values + dist_weight * res.distances ** 2,
                        torch.full_like(res.q_values, float("inf")))
    return res.take(torch.topk(-score, K, dim=-1).indices)


def _terminal_vertices(config: LMPCConfig, ss: SafeSet, state: LMPCState, x_N: Tensor,
                       fuel_avail: Tensor) -> KNNResult:
    """The K hull vertices of every lane around its predicted terminal
    state: the nearest (or the best of a nearest pool), merged with the
    previous solve's under ``vertex_memory``, restricted to the nearest
    vertex's trajectory under ``hull_same_trajectory``."""
    K = config.n_terminal_vertices
    pool = max(config.candidate_pool, K) if config.candidate_pool else K
    res = knn_query(ss, x_N, pool, fuel_available=fuel_avail,
                    fallback_unfiltered=config.fuel_filter_fallback)
    if pool > K:
        res = _best_k(res, K, config.candidate_dist_weight)
    if config.vertex_memory:
        prev = state.prev_vertices
        pidx = prev.clamp_min(0).long()
        feas = ss.mask[pidx] & (ss.fuel_required[pidx] <= fuel_avail[:, None])
        if config.fuel_filter_fallback:
            feas = torch.where(ss.any_feasible(fuel_avail)[:, None], feas, ss.mask[pidx])
        dup = (pidx[:, :, None] == res.indices[:, None, :]).any(-1)
        pvalid = (prev >= 0) & feas & ~dup
        pd2 = weighted_sq_dists(x_N[:, None], ss.states[pidx],
                                default_state_weights(config.n_x, ss.device))[:, 0]
        cand = KNNResult(
            indices=torch.cat([res.indices, pidx], dim=1),
            distances=torch.cat([res.distances, torch.sqrt(pd2.clamp_min(0.0))], dim=1),
            states=torch.cat([res.states, ss.states[pidx]], dim=1),
            q_values=torch.cat([res.q_values, ss.q_values[pidx]], dim=1),
            valid=torch.cat([res.valid, pvalid], dim=1))
        res = _best_k(cand, K, config.candidate_dist_weight)
    if config.hull_same_trajectory:
        tids = ss.traj_ids[res.indices]
        nearest = torch.where(res.valid, res.distances,
                              torch.full_like(res.distances, float("inf"))).argmin(-1, keepdim=True)
        res = res._replace(valid=res.valid & (tids == torch.take_along_dim(tids, nearest, -1)))
    return res


@lru_cache(maxsize=16)
def _ipm_row_order(m_base: int, n_x: int, K: int, device: torch.device) -> Tensor:
    """The IPM contract (equality rows last): the hull block arrives as
    [n_x hull equalities; Σλ; K λ bounds], so the bounds move ahead."""
    perm = (list(range(m_base)) + list(range(m_base + n_x + 1, m_base + n_x + 1 + K))
            + list(range(m_base, m_base + n_x + 1)))
    return torch.tensor(perm, device=device)


def _condensed_segments(config: LMPCConfig, nu: int) -> tuple:
    """The condensed base rows' declared structure (the hull rows stay a
    trailing dense segment)."""
    N, n_u = config.N, config.n_u
    C = next((c for c in (5, 4, 3, 2) if N % c == 0), 1)
    s_blk = N // C
    n_b = (config.n_x if config.x_bound_mask is None
           else sum(bool(b) for b in config.x_bound_mask))
    return ((("diag", nu),) if n_b == 0
            else (("blt", C, s_blk * n_b, s_blk * n_u), ("diag", nu)))


def _block_qp(P_base, q_base, A_base, l_base, u_base, A_hull, l_hull, u_hull,
              q_shift, q_span, config: LMPCConfig, nb: int) -> QPData:
    """The QP over z = [base; λ; s]: the base cost, the λ ridge and the slack
    penalty (both span-relative), the base rows and then the hull rows."""
    Bsz, K, n_x = q_shift.shape[0], config.n_terminal_vertices, config.n_x
    n = nb + K + n_x
    dt, dev = q_base.dtype, q_base.device
    P = torch.zeros(Bsz, n, n, dtype=dt, device=dev)
    P[:, :nb, :nb] = P_base
    eye_k = torch.eye(K, dtype=dt, device=dev)
    eye_x = torch.eye(n_x, dtype=dt, device=dev)
    P[:, nb:nb + K, nb:nb + K] = (config.lambda_reg * q_span)[:, None, None] * eye_k
    P[:, nb + K:, nb + K:] = (config.slack_weight * q_span)[:, None, None] * eye_x
    q = torch.cat([q_base, q_shift, torch.zeros(Bsz, n_x, dtype=dt, device=dev)], dim=1)
    m_base = A_base.shape[-2]
    A = torch.zeros(Bsz, m_base + A_hull.shape[1], n, dtype=dt, device=dev)
    A[:, :m_base, :nb] = A_base
    A[:, m_base:] = A_hull
    return QPData(P=P, q=q, A=A, l=torch.cat([l_base.expand(Bsz, -1), l_hull], dim=1),
                  u=torch.cat([u_base.expand(Bsz, -1), u_hull], dim=1))


class _HullQP(NamedTuple):
    """One solve's QP with what the solve reads back from its build."""

    data: QPData
    state: LMPCState  # X_lin is the re-anchored rollout
    res: KNNResult  # the terminal vertices
    lam0: Tensor  # (B, K) λ warm start at the nearest valid vertex
    q_lam: Tensor  # (B, K) the valid vertices' Q-values (0 elsewhere)
    Gs: Optional[Tensor]  # condensed form: x_k = G_k U + d_k
    ds: Optional[Tensor]


def _lmpc_qp(step_fn, config: LMPCConfig, safe_set: SafeSet, state: LMPCState,
             x0: Tensor) -> _HullQP:
    """Re-anchor, query the terminal vertices, linearize and build every
    lane's hull QP (rows: the base MPC rows, then the hull block)."""
    N, n_x, n_u, K = config.N, config.n_x, config.n_u, config.n_terminal_vertices
    nz = (N + 1) * n_x + N * n_u

    # re-anchor: forward-simulate the warm-start controls from the measured
    # state so the linearization trajectory is dynamically consistent
    with span("lmpc.rollout"):
        X_sim = _rollout(step_fn, x0, state.U_lin)

    fuel_avail = x0[:, 0] - config.m_dry - config.fuel_margin
    with span("lmpc.knn"):
        res = _terminal_vertices(config, safe_set, state, X_sim[:, -1], fuel_avail)

    with span("lmpc.linearize"):
        Aks, Bks, cks = trajectory_jacobians(step_fn, X_sim, state.U_lin)
    state = state.replace(X_lin=X_sim)

    with span("lmpc.qp_build"):
        inf = torch.full_like(res.distances, float("inf"))
        nearest = torch.where(res.valid, res.distances, inf).argmin(-1)
        lam0 = torch.nn.functional.one_hot(nearest, K).to(x0.dtype)
        # the terminal cost Qᵀλ shifted by the least valid Q (exact under
        # Σλ = 1): the solver sees only the O(span) differences
        zero = torch.zeros_like(res.q_values)
        q_lam = torch.where(res.valid, res.q_values, zero)
        q_min = torch.where(res.valid, q_lam, inf).amin(-1, keepdim=True)
        q_shift = torch.where(res.valid, q_lam - q_min, zero)
        q_span = q_shift.amax(-1).clamp_min(1.0)
        zQ = torch.zeros(n_x, n_x, dtype=x0.dtype, device=x0.device)
        Gs = ds = None
        if config.condensed:
            nu = N * n_u
            base, Gs, ds = build_condensed_qp(
                Aks, Bks, cks, x0, config.Q, config.R, zQ, state.x_ref, config.x_min,
                config.x_max, config.u_min, config.u_max, x_bound_mask=config.x_bound_mask)
            A_hull, l_hull, u_hull, _ = hull_constraint_rows(
                res.states, res.q_values, res.valid, nu, xN_offset=0, soft=True)
            # x_N = G_N·U + d_N: the identity block on x_N becomes G_N over
            # the U columns and the equality shifts by −d_N
            A_hull[:, :n_x, :nu] = Gs[:, -1]
            l_hull[:, :n_x] -= ds[:, -1]
            u_hull[:, :n_x] -= ds[:, -1]
            data = _block_qp(base.P, base.q, base.A, base.l, base.u, A_hull, l_hull, u_hull,
                             q_shift, q_span, config, nu)
        else:
            P_base, q_base = build_cost(N, config.Q, config.R, zQ, state.x_ref)
            A_base, l_base, u_base = build_constraints(
                Aks, Bks, cks, x0, config.x_min, config.x_max, config.u_min, config.u_max)
            A_hull, l_hull, u_hull, _ = hull_constraint_rows(
                res.states, res.q_values, res.valid, nz, xN_offset=nz - n_x, soft=True)
            data = _block_qp(P_base, q_base, A_base, l_base, u_base, A_hull, l_hull, u_hull,
                             q_shift, q_span, config, nz)
    return _HullQP(data=data, state=state, res=res, lam0=lam0, q_lam=q_lam, Gs=Gs, ds=ds)


def lmpc_solve(step_fn: Callable[[Tensor, Tensor], Tensor], config: LMPCConfig,
               safe_set: SafeSet, state: LMPCState, x0: Tensor
               ) -> Tuple[LMPCSolution, LMPCState]:
    """One receding-horizon LMPC solve for every lane; x0 (B, n_x)."""
    N, n_x, n_u, K = config.N, config.n_x, config.n_u, config.n_terminal_vertices
    Bsz = x0.shape[0]
    nz = (N + 1) * n_x + N * n_u
    nu = N * n_u if config.condensed else nz
    data, state, res, lam0, q_lam, Gs, ds = _lmpc_qp(step_fn, config, safe_set, state, x0)
    X_sim = state.X_lin

    if config.condensed and config.solver == "ipm":
        perm = _ipm_row_order(data.m - (n_x + 1 + K), n_x, K, x0.device)
        with span("lmpc.ipm"):
            sol = solve_ipm(QPData(P=data.P, q=data.q, A=data.A[:, perm], l=data.l[:, perm],
                                   u=data.u[:, perm]),
                            IPMConfig(n_eq=n_x + 1, iters=config.ipm_iters))
    else:
        if config.solver == "ipm":
            # the sparse layout interleaves its equality rows, which the IPM
            # contract cannot express: the sparse form solves on ADMM
            warnings.warn("LMPC sparse form solves on ADMM (solver='ipm' applies to "
                          "the condensed form only)", stacklevel=2)
        # slack warm start at its value for the λ warm start (x_N − v_nearest)
        s0 = X_sim[:, -1] - (lam0[:, None] @ res.states)[:, 0]
        if config.condensed:
            z0 = torch.cat([state.U_lin.reshape(Bsz, -1), lam0, s0], dim=1)
            admm = config.admm
            if admm.row_structure is None:
                admm = admm.replace(row_structure=_condensed_segments(config, nu))
        else:
            z0 = torch.cat([join_z(state.X_lin, state.U_lin), lam0, s0], dim=1)
            admm = config.admm
        with span("lmpc.admm_solve"):
            sol = solve(data, z0, None, admm, rho0=state.rho)

    if config.condensed:
        U_new = sol.x[:, :nu].reshape(Bsz, N, n_u)
        X_new = recover_states(Gs, ds, sol.x[:, :nu], x0)
    else:
        X_new, U_new = split_z(sol.x[:, :nz], N, n_x, n_u)
    lam = sol.x[:, nu:nu + K]
    slack = sol.x[:, nu + K:]

    # a primal-feasible plan is usable before its dual is tight; at least one
    # usable vertex is required
    ok = (((sol.status == SOLVED) | (sol.pri_res <= config.feasibility_tol))
          & res.valid.any(-1))
    ok3 = ok[:, None, None]
    X_opt = torch.where(ok3, X_new, state.X_lin)
    U_opt = torch.where(ok3, U_new, state.U_lin)
    X_shift = torch.cat([X_opt[:, 1:], X_opt[:, -1:]], dim=1)
    U_shift = torch.cat([U_opt[:, 1:], U_opt[:, -1:]], dim=1)
    new_state = state.replace(
        X_lin=X_shift, U_lin=U_shift,
        # the IPM has no penalty to warm-start: the carried ρ stays
        rho=state.rho if config.solver == "ipm" else sol.rho,
        prev_vertices=(torch.where(res.valid, res.indices, torch.full_like(res.indices, -1))
                       .to(torch.int32) if config.vertex_memory else state.prev_vertices))
    return (
        LMPCSolution(
            X_opt=X_opt, U_opt=U_opt, u0=U_opt[:, 0], lam=lam,
            terminal_q=(q_lam * lam).sum(-1), success=ok,
            slack_norm=torch.linalg.vector_norm(slack, dim=-1),
            qp_status=sol.status, qp_pri_res=sol.pri_res),
        new_state,
    )


def default_stage_cost(x: Tensor, u: Tensor, x_target: Tensor, config: LMPCConfig) -> Tensor:
    """Quadratic stage cost plus, on the 7- and 14-state layouts, the
    touchdown shaping: an altitude-gated hinge on excess speed,
    w·σ((h_gate − h)/width)·(|v|² − v_free²)₊. Any leading axes."""
    e = x - x_target
    quad = (e * (e @ config.Q.T)).sum(-1) + (u * (u @ config.R.T)).sum(-1)
    if config.n_x not in (7, 14):
        return quad
    gate = torch.sigmoid((config.touchdown_gate_altitude - x[..., 1])
                         / config.touchdown_gate_width)
    excess = ((x[..., 4:7] ** 2).sum(-1) - config.touchdown_free_speed ** 2).clamp_min(0.0)
    return quad + config.touchdown_speed_weight * gate * excess


def lmpc_plan_value(step_fn: Callable[[Tensor, Tensor], Tensor], config: LMPCConfig,
                    safe_set: SafeSet, x0: Tensor, x_target: Tensor, settle: int = 4,
                    prev_vertices: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """The controller's value estimate V(x0) = planned stage cost + terminal
    Qᵀλ per lane (x0 (B, n_x)) after ``settle`` re-solves: the best value of
    an accepted solve over the settled half, else the last. Returns (value
    (B,), ok (B,), the last solve's terminal vertices (B, K)); feed the
    vertices back as ``prev_vertices`` under ``config.vertex_memory``."""
    xT = as_f32(x_target, config.device)
    st = lmpc_init(config, x0, xT, prev_vertices=prev_vertices)
    values, succ = [], []
    for _ in range(settle):
        sol, st = lmpc_solve(step_fn, config, safe_set, st, x0)
        plan = default_stage_cost(sol.X_opt[:, :-1], sol.U_opt, xT, config).sum(-1)
        values.append(plan + sol.terminal_q)
        succ.append(sol.success)
    values, succ = torch.stack(values), torch.stack(succ)
    half = settle // 2
    idx = torch.arange(settle, device=values.device)[:, None]
    best = torch.where((idx >= half) & succ, values,
                       torch.full_like(values, float("inf"))).amin(0)
    value = torch.where(torch.isfinite(best), best, values[-1])
    ok = succ[half:].any(0) | succ[-1]
    return value, ok, st.prev_vertices


def lmpc_config_6dof(params=None, N: int = 15, dt: float = 0.1, **overrides) -> LMPCConfig:
    """LMPC on the 14-state quaternion model: the Szmuk cost weights, the
    attitude and rate state box, the inner control box of the thrust
    annulus ∩ gimbal cone, and the 6-DoF dry mass. ``device`` defaults to
    the params' device."""
    from ..dynamics.rocket6dof import Rocket6DoFParams
    from ..mpc.cost_functions import CostWeights
    from ..mpc.rti6dof import control_box_6dof, state_box_6dof

    p = params or Rocket6DoFParams(device=overrides.get("device", "cuda"))
    overrides.setdefault("device", p.device)
    w = CostWeights()
    x_min, x_max = state_box_6dof(p)
    u_min, u_max = control_box_6dof(p)
    return LMPCConfig(N=N, dt=dt, n_x=14, n_u=3, Q=w.Q_6dof(), R=w.R(3), x_min=x_min,
                      x_max=x_max, u_min=u_min, u_max=u_max, m_dry=p.m_dry, **overrides)


def _freeze(landed: Tensor, old: LMPCState, new: LMPCState) -> LMPCState:
    """``new`` on the lanes still flying, ``old`` on the landed ones."""
    def pick(a, b):
        return torch.where(landed.reshape(-1, *([1] * (a.dim() - 1))), a, b)
    return LMPCState(**{f.name: pick(getattr(old, f.name), getattr(new, f.name))
                        for f in fields(LMPCState)})


def fly_episode(step_fn: Callable[[Tensor, Tensor], Tensor], config: LMPCConfig,
                safe_set: SafeSet, x0: Tensor, x_target: Tensor, max_steps: int,
                landing_altitude: float = 0.1, stage_cost_fn: Optional[Callable] = None
                ) -> Dict[str, Tensor]:
    """Closed-loop LMPC episode of every lane (x0 (B, n_x)) against a frozen
    safe set; returns the realized trajectories and outcomes without
    inserting them. A landed lane stays frozen: its later rows repeat its
    state with zero control and zero cost. Once every lane has landed the
    loop stops and pads the remaining rows exactly so (a host read of the
    landed flags each step); ``cycles`` counts the solves run."""
    xT = as_f32(x_target, config.device)
    cost_fn = stage_cost_fn or (lambda x, u: default_stage_cost(x, u, xT, config))
    x = as_f32(x0, config.device)
    Bsz = x.shape[0]
    st = lmpc_init(config, x, xT)
    landed = torch.zeros(Bsz, dtype=torch.bool, device=x.device)
    steps = torch.zeros(Bsz, dtype=torch.int32, device=x.device)
    Xs, Us, Cs, qp_ok, live = [x], [], [], [], []
    cycles = 0
    for _ in range(max_steps):
        sol, st_new = lmpc_solve(step_fn, config, safe_set, st, x)
        cycles += 1
        x_next = step_fn(x, sol.u0)
        now_landed = x_next[:, 1] < landing_altitude
        lf = landed[:, None]
        Us.append(torch.where(lf, torch.zeros_like(sol.u0), sol.u0))
        Cs.append(torch.where(landed, torch.zeros_like(steps, dtype=x.dtype),
                              cost_fn(x, sol.u0)))
        qp_ok.append(sol.success)
        live.append(~landed)
        x = torch.where(lf, x, x_next)
        st = _freeze(landed, st, st_new)
        steps = steps + (~landed).to(torch.int32)
        landed = landed | now_landed
        Xs.append(x)
        if len(Us) < max_steps and bool(landed.all()):
            break
    pad = max_steps - len(Us)
    if pad:
        zeros_u, zeros_c = torch.zeros_like(Us[-1]), torch.zeros_like(Cs[-1])
        no = torch.zeros_like(landed)
        Xs += [x] * pad
        Us += [zeros_u] * pad
        Cs += [zeros_c] * pad
        qp_ok += [no] * pad
        live += [no] * pad
    X, U, costs = torch.stack(Xs, 1), torch.stack(Us, 1), torch.stack(Cs, 1)
    qp_ok, live = torch.stack(qp_ok, 1), torch.stack(live, 1)
    soft = torch.linalg.vector_norm(x[:, 4:7], dim=-1) < 2.0
    return {
        "X": X, "U": U, "costs": costs, "x_final": x, "landed": landed,
        "success": landed & soft, "steps": steps, "total_cost": costs.sum(-1),
        # over LIVE steps only (frozen post-landing re-solves are not flown)
        "qp_success_rate": (qp_ok & live).float().sum(-1) / live.float().sum(-1).clamp_min(1.0),
        "cycles": cycles,
    }


def run_episode(step_fn, config: LMPCConfig, safe_set: SafeSet, x0: Tensor, x_target: Tensor,
                max_steps: int, landing_altitude: float = 0.1,
                stage_cost_fn: Optional[Callable] = None) -> Tuple[Dict, SafeSet]:
    """Closed-loop episode of every lane; the successful trajectories (with
    their cost-to-go) join the safe set in lane order."""
    out = fly_episode(step_fn, config, safe_set, x0, x_target, max_steps,
                      landing_altitude, stage_cost_fn)
    return out, safe_set.add_trajectories(out["X"][:, :-1], out["U"], out["costs"],
                                          valid=out["success"])


def run_iterations(step_fn, config: LMPCConfig, safe_set: SafeSet, x0: Tensor,
                   x_target: Tensor, n_iterations: int, max_steps: int
                   ) -> Tuple[List[Dict], SafeSet]:
    """Repeat episodes from x0 (B, n_x), each adding its successes to the
    set; per-iteration ``success``, ``steps`` and ``total_cost`` (B,)."""
    summaries = []
    for _ in range(n_iterations):
        out, safe_set = run_episode(step_fn, config, safe_set, x0, x_target, max_steps)
        summaries.append({k: out[k] for k in ("success", "steps", "total_cost")})
    return summaries, safe_set


def run_fleet_iterations(step_fn, config: LMPCConfig, safe_set: SafeSet, x0s: Tensor,
                         x_target: Tensor, n_rounds: int, max_steps: int
                         ) -> Tuple[List[Dict], SafeSet]:
    """Fleet LMPC: every lane flies an episode against the same frozen set
    in lockstep; the successful trajectories then join the set in lane order
    before the next round."""
    summaries = []
    for _ in range(n_rounds):
        out, safe_set = run_episode(step_fn, config, safe_set, x0s, x_target, max_steps)
        summaries.append({
            "success_rate": float(out["success"].float().mean()),
            "total_cost_mean": float(out["total_cost"].mean()),
            "steps_mean": float(out["steps"].float().mean()),
            "qp_success_rate": float(out["qp_success_rate"].mean()),
        })
    return summaries, safe_set


class SimpleLMPC:
    """Reduced stand-in: each lane applies the stored control of its
    lowest-Q neighbour."""

    def __init__(self, config: Optional[LMPCConfig] = None):
        self.config = config or LMPCConfig()

    def control(self, safe_set: SafeSet, x: Tensor) -> Tensor:
        res = knn_query(safe_set, x, self.config.n_terminal_vertices)
        best = torch.where(res.valid, res.q_values,
                           torch.full_like(res.q_values, float("inf"))).argmin(-1, keepdim=True)
        return safe_set.controls[torch.take_along_dim(res.indices, best, -1)[:, 0]]
