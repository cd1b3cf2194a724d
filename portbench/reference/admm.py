"""Operator-splitting QP solver with OSQP's rules, dense and lanes first,
written plainly: min ½xᵀPx + qᵀx subject to l ≤ Ax ≤ u, every lane its own
QP.

    (P + σI + AᵀRA) x̃ = σx − q + Aᵀ(Rz − y),   z̃ = A x̃
    x ← αx̃ + (1−α)x,   z ← Π[l,u](αz̃ + (1−α)z + R⁻¹y),   y ← y + R(αz̃ + (1−α)z_old − z)

with modified Ruiz equilibration, per-row ρ (equality rows ×1e3, free rows at
ρ_min), the termination test every ``check_interval`` iterations (a lane that
passes is frozen), OSQP's infeasibility certificates, ρ adapted in the first
``rho_adapt_chunks`` checks, and the active-set polish kept where it lowers
the KKT error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .prec import Prec

SOLVED, MAX_ITER, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE = 0, 1, 2, 3
RHO_MIN, RHO_MAX, INF = 1e-6, 1e6, 1e20


@dataclass(frozen=True)
class Settings:
    max_iter: int
    check_interval: int
    early_exit: bool = True
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_infeas: float = 1e-6
    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    adaptive_rho: bool = True
    rho_adapt_chunks: int = 4
    scaling: int = 10
    polish: bool = False
    polish_delta: float = 1e-4
    polish_refine_iters: int = 6
    infeas_certs: bool = True


def _amax(v):
    return v.abs().amax(dim=-1)


def _inv_spd(S: torch.Tensor) -> torch.Tensor:
    """S⁻¹ per lane through its Cholesky factor; NaN where S is not positive
    definite."""
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device).expand_as(S)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    return Li.transpose(1, 2) @ Li


def ruiz(P, q, A, l, u, iters: int):
    B, n = q.shape
    m = l.shape[1]
    D = torch.ones(B, n, dtype=q.dtype, device=q.device)
    E = torch.ones(B, m, dtype=q.dtype, device=q.device)
    c = torch.ones(B, dtype=q.dtype, device=q.device)
    lim = lambda s: s.clamp(1e-4, 1e4)
    for _ in range(iters):
        col = torch.maximum(P.abs().amax(dim=-2), A.abs().amax(dim=-2))
        row = A.abs().amax(dim=-1)
        d = lim(1.0 / torch.sqrt(col.clamp_min(1e-4)))
        e = lim(1.0 / torch.sqrt(row.clamp_min(1e-4)))
        P = d[:, :, None] * P * d[:, None, :]
        q = d * q
        A = e[:, :, None] * A * d[:, None, :]
        l, u = e * l, e * u
        gam = lim(1.0 / torch.maximum(P.abs().amax(dim=-2).mean(-1),
                                      q.abs().amax(dim=-1)).clamp_min(1e-4))
        P, q = gam[:, None, None] * P, gam[:, None] * q
        D, E, c = D * d, E * e, c * gam
    return P, q, A, l, u, D, E, c


def rho_vec(l, u, rho):
    r = rho[:, None].expand_as(l)
    r = torch.where((u - l) <= 1e-9, r * 1e3, r)
    r = torch.where((l <= -INF) & (u >= INF), torch.full_like(r, RHO_MIN), r)
    return r.clamp(RHO_MIN, RHO_MAX)


def _kkt_inverse(Pr: Prec, P, A, rho_v, sigma):
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    return _inv_spd(P + sigma * eye + Pr.mm(A.transpose(1, 2) * rho_v[:, None, :], A))


def _polish(Pr: Prec, P, q, A, l, u, x, y, z, s: Settings):
    n = q.shape[1]
    eq = (u - l) <= 1e-9
    low = ((z - l) < -y) | eq
    high = ((u - z) < y) | eq
    act = low | high
    b = torch.where(high & ~low, u, l)
    b = torch.where(act, b, torch.zeros_like(b))
    af = act.to(q.dtype)
    Aa = af[:, :, None] * A
    AaT = Aa.transpose(1, 2)
    Dinv = 1.0 / (1.0 - af + s.polish_delta * af)
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    Sinv = _inv_spd(P + s.polish_delta * eye + Pr.mm(AaT * Dinv[:, None, :], Aa))

    def kkt(r1, r2):
        xs = Pr.mv(Sinv, r1 + Pr.mv(AaT, Dinv * r2))
        return xs, Dinv * (Pr.mv(Aa, xs) - r2)

    xp, nu = kkt(-q, b)
    for _ in range(s.polish_refine_iters):
        r1 = -q - (Pr.mv(P, xp) + Pr.mv(AaT, nu))
        r2 = b - (Pr.mv(Aa, xp) - (1.0 - af) * nu)
        dx, dnu = kkt(r1, r2)
        xp, nu = xp + dx, nu + dnu
    yp = torch.where(act, nu, torch.zeros_like(nu))
    zp = torch.minimum(torch.maximum(Pr.mv(A, xp), l), u)
    ok = (torch.isfinite(xp).all(1) & torch.isfinite(nu).all(1))[:, None]
    return torch.where(ok, xp, x), torch.where(ok, yp, y), torch.where(ok, zp, z)


def _accept_polish(Pr: Prec, P, q, A, l, u, x, y, z, rp, rd, status, s: Settings):
    AT = A.transpose(1, 2)
    xp, yp, zp = _polish(Pr, P, q, A, l, u, x, y, z, s)

    def err(xx, yy, zz):
        Ax = Pr.mv(A, xx)
        viol = torch.maximum((Ax - u).clamp_min(0).amax(-1), (l - Ax).clamp_min(0).amax(-1))
        return torch.maximum(torch.maximum(_amax(Ax - zz), _amax(Pr.mv(P, xx) + q + Pr.mv(AT, yy))),
                             viol)

    better = err(xp, yp, zp) < err(x, y, z)
    x = torch.where(better[:, None], xp, x)
    y = torch.where(better[:, None], yp, y)
    z = torch.where(better[:, None], zp, z)
    Ax, Px, ATy = Pr.mv(A, x), Pr.mv(P, x), Pr.mv(AT, y)
    rp = torch.where(better, _amax(Ax - z), rp)
    rd = torch.where(better, _amax(Px + q + ATy), rd)
    pn = torch.maximum(_amax(Ax), _amax(z))
    dn = torch.maximum(torch.maximum(_amax(Px), _amax(ATy)), _amax(q))
    ok = (rp <= s.eps_abs + s.eps_rel * pn) & (rd <= s.eps_abs + s.eps_rel * dn)
    status = torch.where((status == MAX_ITER) & ok, torch.full_like(status, SOLVED), status)
    return x, y, z, rp, rd, status


def solve(Pr: Prec, P, q, A, l, u, x0: Optional[torch.Tensor], y0: Optional[torch.Tensor],
          rho0, s: Settings) -> dict:
    """Every lane's QP (P (B,n,n), q (B,n), A (B,m,n), l, u (B,m)) from the
    unscaled warm start (x0, y0) and ρ₀ ((B,) or a number). Returns the
    unscaled x, y, z, the status, the residuals and ρ of every lane."""
    B, n = q.shape
    dt, dev = q.dtype, q.device
    Ps, qs, As, ls, us, D, E, c = ruiz(P, q, A, l, u, s.scaling)
    Dinv, Einv = 1.0 / D, 1.0 / E
    x = torch.zeros(B, n, dtype=dt, device=dev) if x0 is None else Dinv * x0
    y = torch.zeros_like(ls) if y0 is None else (c[:, None] / E) * y0
    z = Pr.mv(As, x)
    rho = torch.as_tensor(s.rho if rho0 is None else rho0, dtype=dt, device=dev)
    rho = rho.expand(B).clone() if rho.dim() == 0 else rho.clone()
    rv = rho_vec(ls, us, rho)
    Minv = _kkt_inverse(Pr, Ps, As, rv, s.sigma)
    AsT = As.transpose(1, 2)
    q_norm = _amax(Dinv * qs) / c

    def residuals(x, z, y):
        Ax, Px, ATy = Pr.mv(As, x), Pr.mv(Ps, x), Pr.mv(AsT, y)
        rp = _amax(Einv * (Ax - z))
        rd = _amax(Dinv * (Px + qs + ATy)) / c
        pn = torch.maximum(_amax(Einv * Ax), _amax(Einv * z))
        dn = torch.maximum(torch.maximum(_amax(Dinv * Px), _amax(Dinv * ATy)) / c, q_norm)
        return rp, rd, pn, dn

    def certificates(dx, dy_s):
        eps = s.eps_infeas
        dy = (E / c[:, None]) * dy_s
        dyn = _amax(dy)
        dxn = _amax(D * dx)
        zero = torch.zeros_like(us)
        uu = torch.where(us >= INF, zero, Einv * us)
        ll = torch.where(ls <= -INF, zero, Einv * ls)
        prim = ((dyn > 1e-12) & (_amax(Dinv * Pr.mv(AsT, dy_s)) / c <= eps * dyn)
                & ((uu * dy.clamp_min(0)).sum(-1) + (ll * dy.clamp_max(0)).sum(-1) <= eps * dyn))
        Adx = Einv * Pr.mv(As, dx)
        tol = (eps * dxn)[:, None]
        dual = ((dxn > 1e-12) & (_amax(Dinv * Pr.mv(Ps, dx)) / c <= eps * dxn)
                & ((qs * dx).sum(-1) / c <= eps * dxn)
                & ((us >= INF) | (Adx <= tol)).all(-1) & ((ls <= -INF) | (Adx >= -tol)).all(-1))
        return prim, dual

    if s.max_iter % s.check_interval:
        raise ValueError("max_iter must be a multiple of check_interval")
    n_checks = max(s.max_iter // s.check_interval, 1)
    n_adapt = min(s.rho_adapt_chunks, n_checks) if s.adaptive_rho else 0
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    status = torch.full((B,), MAX_ITER, dtype=torch.int64, device=dev)
    rp_out = torch.zeros(B, dtype=dt, device=dev)
    rd_out = torch.zeros_like(rp_out)
    for k in range(n_checks):
        adapt = k < n_adapt
        if s.early_exit and not adapt and k > 0 and bool(done.all()):
            break
        xp, yp = x, y
        xn, zn, yn = x, z, y
        for _ in range(s.check_interval):
            xt = Pr.mv(Minv, s.sigma * xn - qs + Pr.mv(AsT, rv * zn - yn))
            zt = Pr.mv(As, xt)
            x_new = s.alpha * xt + (1.0 - s.alpha) * xn
            zr = s.alpha * zt + (1.0 - s.alpha) * zn
            z_new = torch.minimum(torch.maximum(zr + yn / rv, ls), us)
            yn = yn + rv * (zr - z_new)
            xn, zn = x_new, z_new
        keep = ~done
        x = torch.where(keep[:, None], xn, x)
        z = torch.where(keep[:, None], zn, z)
        y = torch.where(keep[:, None], yn, y)
        rp, rd, pn, dn = residuals(x, z, y)
        conv = (rp <= s.eps_abs + s.eps_rel * pn) & (rd <= s.eps_abs + s.eps_rel * dn)
        code = torch.where(conv, SOLVED, MAX_ITER)
        if s.infeas_certs:
            prim, dual = certificates(x - xp, y - yp)
            code = torch.where(conv, code, torch.where(prim, PRIMAL_INFEASIBLE,
                                                       torch.where(dual, DUAL_INFEASIBLE, code)))
            conv = conv | prim | dual
        rp_out = torch.where(keep, rp, rp_out)
        rd_out = torch.where(keep, rd, rd_out)
        status = torch.where(done, status, code)
        done = done | conv
        if adapt:
            ratio = torch.sqrt((rp / pn.clamp_min(1e-10)) / (rd / dn.clamp_min(1e-10)).clamp_min(1e-10))
            upd = (~done) & ((ratio > 5.0) | (ratio < 0.2))
            rho = torch.where(upd, (rho * ratio.clamp(0.1, 10.0)).clamp(RHO_MIN, RHO_MAX), rho)
            rv_new = rho_vec(ls, us, rho)
            rv = torch.where(upd[:, None], rv_new, rv)
            Minv = torch.where(upd[:, None, None], _kkt_inverse(Pr, Ps, As, rv_new, s.sigma), Minv)
    xu, yu, zu = D * x, (E * y) / c[:, None], Einv * z
    if s.polish:
        xu, yu, zu, rp_out, rd_out, status = _accept_polish(
            Pr, P, q, A, l, u, xu, yu, zu, rp_out, rd_out, status, s)
    return {"x": xu, "y": yu, "z": zu, "status": status, "pri_res": rp_out, "dua_res": rd_out,
            "rho": rho, "done": done}
