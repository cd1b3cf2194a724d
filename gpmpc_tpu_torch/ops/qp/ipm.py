"""Batched primal-dual interior-point QP solver, Mehrotra predictor-corrector
(counterpart of ``gpmpc_tpu/ops/qp/ipm.py``), lane-batched: every tensor of
``QPData`` carries the leading lane axis B.

    min ½ zᵀPz + qᵀz   s.t.   l ≤ Az ≤ u

A fixed number of iterations as a Python loop, with no early exit and no
host sync: a lane whose iterate has converged (μ below ``mu_tol`` with small
stationarity) or whose Newton direction went non-finite is frozen by
``torch.where``, as the JAX package's scan freezes it. Contract, as there:
the **equality rows (l == u) are the last ``n_eq`` rows** of ``A``; they get
an explicit multiplier block. Inequality rows may be one- or two-sided.

Where the JAX package relies on ``jnp.linalg.cholesky`` returning NaN for a
matrix that lost definiteness, the port factors with
``torch.linalg.cholesky_ex`` and turns the factor of a lane whose ``info``
is non-zero into NaN; the Schur solve of the equality block goes through
``torch.linalg.solve_ex`` the same way. Such a lane freezes and its
neighbours are untouched; nothing raises and nothing syncs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from .ruiz import ruiz_equilibrate
from .types import MAX_ITER, SOLVED, QPData, QPSolution

_BIG = 1e10  # bounds beyond this are treated as infinite


@dataclass(frozen=True)
class IPMConfig:
    """Mehrotra predictor-corrector settings; field names and defaults are
    those of the JAX ``IPMConfig`` (see there for the meaning of each)."""

    n_eq: int = 0
    iters: int = 20
    ruiz_iters: int = 10
    tau: float = 0.99
    mu_tol: float = 1e-5
    dua_freeze: float = 1e-3
    w_max: float = 1e7
    jitter: float = 1e-6
    eps_abs: float = 2e-3
    eps_rel: float = 2e-3

    def replace(self, **kw) -> "IPMConfig":
        return replace(self, **kw)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _nan_where(bad: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``T`` with the lanes flagged by ``bad`` (B,) set to NaN."""
    return torch.where(bad.reshape(-1, *([1] * (T.dim() - 1))),
                       torch.full_like(T, float("nan")), T)


def solve_ipm(data: QPData, config: Optional[IPMConfig] = None) -> QPSolution:
    """Solve every lane's QP. The last ``config.n_eq`` rows of ``data.A``
    must be equality rows. Returns the shared :class:`QPSolution` (``rho`` is
    0: there is no ADMM penalty to carry). The solver is primal-focused: the
    status is primal feasibility plus scaled complementarity; the f32 duals
    are approximate and ``dua_res`` is reported only."""
    cfg = config or IPMConfig()
    sdata, sc = ruiz_equilibrate(data, iters=cfg.ruiz_iters)
    zbar, ybar, mu, it_used = _ipm_core(sdata.P, sdata.q, sdata.A, sdata.l, sdata.u, cfg)
    x = sc.D * zbar
    y = (sc.E / sc.c[:, None]) * ybar
    z = _mv(data.A, x)

    viol = torch.maximum(data.l - z, z - data.u).clamp_min(0.0)
    pri_res = viol.amax(-1)
    dua_vec = _mv(data.P, x) + data.q + _mv(data.A.transpose(-1, -2), y)
    dua_res = dua_vec.abs().amax(-1)
    eps_pri = cfg.eps_abs + cfg.eps_rel * torch.maximum(
        z.abs().amax(-1), torch.maximum(
            data.l.clamp(-_BIG, _BIG).abs().amax(-1),
            data.u.clamp(-_BIG, _BIG).abs().amax(-1)))
    ok = (pri_res <= eps_pri) & (mu <= 10.0 * cfg.mu_tol)
    status = torch.where(ok, SOLVED, MAX_ITER).to(torch.int32)
    obj = 0.5 * (x * _mv(data.P, x)).sum(-1) + (data.q * x).sum(-1)
    return QPSolution(x=x, y=y, z=z, obj=obj, pri_res=pri_res, dua_res=dua_res,
                      iterations=it_used, status=status, rho=torch.zeros_like(obj))


def _ipm_core(P, q, A, l, u, cfg: IPMConfig):
    """Scaled-space iterations; returns (z, y, μ, iterations used), each
    with the lane axis first."""
    B, n = q.shape
    m = A.shape[1]
    n_eq = cfg.n_eq
    dtype, dev = P.dtype, P.device
    mI = m - n_eq
    A_I, A_E = A[:, :mI], A[:, mI:]
    A_IT, A_ET = A_I.transpose(-1, -2), A_E.transpose(-1, -2)
    lI = l[:, :mI].clamp_min(-_BIG)
    uI = u[:, :mI].clamp_max(_BIG)
    b_E = l[:, mI:]

    eps_g = 1e-8
    I_n = torch.eye(n, dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    # start: z = 0, s = Az clipped strictly inside the box, unit multipliers
    # on finite sides
    z = torch.zeros(B, n, dtype=dtype, device=dev)
    margin = (0.25 * (uI - lI)).clamp_max(1.0)
    s = torch.minimum(torch.maximum(_mv(A_I, z), lI + margin), uI - margin)
    fin_l = l[:, :mI] > -_BIG
    fin_u = u[:, :mI] < _BIG
    one, tiny = torch.ones_like(lI), torch.full_like(lI, 1e-8)
    zl = torch.where(fin_l, one, tiny)
    zu = torch.where(fin_u, one, tiny)
    yE = torch.zeros(B, n_eq, dtype=dtype, device=dev)
    n_fin = (fin_l.sum(-1) + fin_u.sum(-1)).clamp_min(1).to(dtype)
    it_used = torch.zeros(B, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(lI)

    def complementarity(zl_, gl_, zu_, gu_):
        return (torch.where(fin_l, zl_ * gl_, zero).sum(-1)
                + torch.where(fin_u, zu_ * gu_, zero).sum(-1)) / n_fin

    def directions(solveM, gl, gu, zl, zu, W, r_d, r_pI, r_pE, X, S_lu, sigma_mu):
        """Newton direction for a centering target (B, 1), reusing the
        factorization and the Schur block X = M⁻¹A_Eᵀ."""
        rcl = sigma_mu - zl * gl
        rcu = sigma_mu - zu * gu
        c = rcu / gu - rcl / gl
        r1 = -(r_d + _mv(A_IT, c + W * r_pI))
        dz0 = solveM(r1[..., None])[..., 0]
        if n_eq > 0:
            LU, piv, bad = S_lu
            dyE = torch.linalg.lu_solve(LU, piv, (_mv(A_E, dz0) + r_pE)[..., None])[..., 0]
            dyE = _nan_where(bad, dyE)
            dz = dz0 - _mv(X, dyE)
        else:
            dyE = yE.new_zeros(B, 0)
            dz = dz0
        ds = _mv(A_I, dz) + r_pI
        dzl = (rcl - zl * ds) / gl
        dzu = (rcu + zu * ds) / gu
        return dz, ds, dzl, dzu, dyE

    def step_len(gl, gu, zl, zu, ds, dzl, dzu):
        """Separate primal and dual fraction-to-boundary, per lane."""
        a1 = torch.where(ds < 0, -gl / ds, inf)
        a2 = torch.where(ds > 0, gu / ds, inf)
        a3 = torch.where(dzl < 0, -zl / dzl, inf)
        a4 = torch.where(dzu < 0, -zu / dzu, inf)
        ap = (cfg.tau * torch.minimum(a1, a2).amin(-1)).clamp_max(1.0)
        ad = (cfg.tau * torch.minimum(a3, a4).amin(-1)).clamp_max(1.0)
        return ap, ad

    for _ in range(cfg.iters):
        gl = (s - lI).clamp_min(eps_g)
        gu = (uI - s).clamp_min(eps_g)
        mu = complementarity(zl, gl, zu, gu)

        W = (zl / gl + zu / gu).clamp(0.0, cfg.w_max)
        r_d = _mv(P, z) + q + _mv(A_IT, zu - zl) + _mv(A_ET, yE)
        r_pI = _mv(A_I, z) - s
        r_pE = _mv(A_E, z) - b_E
        # freeze only once complementarity AND (scaled) stationarity settled
        frozen = (mu < cfg.mu_tol) & (r_d.abs().amax(-1) < cfg.dua_freeze)
        M = P + (A_IT * W[:, None, :]) @ A_I
        Lc, info = torch.linalg.cholesky_ex(M + cfg.jitter * I_n)
        Lc = _nan_where(info != 0, Lc)  # a lost factorization freezes the lane
        solveM = lambda Bm: torch.cholesky_solve(Bm, Lc)
        X = S_lu = None
        if n_eq > 0:
            X = solveM(A_ET)
            # relative jitter: near convergence S = A_E M⁻¹ A_Eᵀ shrinks like
            # 1/W and an absolute one would freeze the equality duals
            S = A_E @ X
            tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
            S = S + (1e-6 * tr / n_eq + 1e-30)[:, None, None] * torch.eye(
                n_eq, dtype=dtype, device=dev)
            LU, piv, s_info = torch.linalg.lu_factor_ex(S)
            S_lu = (LU, piv, s_info != 0)

        # predictor (affine scaling)
        dz, ds, dzl, dzu, dyE = directions(solveM, gl, gu, zl, zu, W, r_d, r_pI, r_pE,
                                           X, S_lu, 0.0)
        ap, ad = step_len(gl, gu, zl, zu, ds, dzl, dzu)
        gl_a = (s + ap[:, None] * ds - lI).clamp_min(eps_g)
        gu_a = (uI - s - ap[:, None] * ds).clamp_min(eps_g)
        mu_aff = complementarity(zl + ad[:, None] * dzl, gl_a, zu + ad[:, None] * dzu, gu_a)
        sigma = ((mu_aff / mu.clamp_min(1e-14)) ** 3).clamp(0.0, 1.0)

        # corrector (same factorization)
        dz, ds, dzl, dzu, dyE = directions(solveM, gl, gu, zl, zu, W, r_d, r_pI, r_pE,
                                           X, S_lu, (sigma * mu)[:, None])
        ap, ad = step_len(gl, gu, zl, zu, ds, dzl, dzu)

        good = (torch.isfinite(dz).all(-1) & torch.isfinite(ds).all(-1)
                & torch.isfinite(dzl).all(-1) & torch.isfinite(dzu).all(-1)
                & torch.isfinite(dyE).all(-1) & torch.isfinite(ap) & torch.isfinite(ad))
        live = (good & ~frozen)[:, None]
        # select, don't multiply: 0·inf = NaN would poison a frozen iterate
        ap, ad = ap[:, None], ad[:, None]
        z = torch.where(live, z + ap * dz, z)
        s = torch.where(live, torch.minimum(torch.maximum(s + ap * ds, lI + eps_g),
                                            uI - eps_g), s)
        zl = torch.where(live, (zl + ad * dzl).clamp_min(1e-14), zl)
        zu = torch.where(live, (zu + ad * dzu).clamp_min(1e-14), zu)
        yE = torch.where(live, yE + ad * dyE, yE)
        it_used = it_used + live[:, 0].to(torch.int32)

    # dual vector in row order: inequality rows carry zu − zl, equality rows
    # their free multiplier
    y = torch.cat([zu - zl, yE], dim=-1)
    gl = (s - lI).clamp_min(eps_g)
    gu = (uI - s).clamp_min(eps_g)
    return z, y, complementarity(zl, gl, zu, gu), it_used
