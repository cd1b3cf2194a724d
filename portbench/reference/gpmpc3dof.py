"""One control cycle of the 3-DoF GP-MPC fleet, written plainly from its
definition, and the plant step.

For every lane, from the carried plan (X_lin, U_lin), duals y and penalty ρ
and the measured state x₀:

1. roll the carried controls out from x₀ through the nominal model plus the
   GP mean frozen at the carried knots (the residual tape);
2. linearize the nominal step along that rollout (exact Jacobians);
3. add dt · the GP's gated mean at the knots to the affine term, and take its
   variances;
4. propagate Σ_{k+1} = A Σ Aᵀ + diag(0, 0, 0, 0, dt² σ²) from 1e-6·I;
5. condense the QP onto the controls, with the control box intersected with
   the trust region (every state-bound row elided);
6. run the fixed ADMM iterations from the carried (U_lin, y, ρ);
7. accept the plan where the solve is SOLVED or its primal residual is at
   most ``accept_pri_tol``, else keep the rollout; shift it one step.
"""

from __future__ import annotations

import torch

from . import admm
from . import dynamics3dof as dyn
from .prec import Prec


def settings(c: dict) -> admm.Settings:
    a = c["admm"]
    return admm.Settings(max_iter=a["iterations"], check_interval=a["iterations"],
                         scaling=a["scaling"], adaptive_rho=False, polish=False,
                         infeas_certs=False, rho=a["rho"], sigma=a["sigma"], alpha=a["alpha"],
                         eps_abs=a["eps"], eps_rel=a["eps"])


def weights(P: Prec, c: dict, dev):
    Q = torch.diag(P.t(c["Q_diag"], dev))
    return Q, P.t(c["R"], dev) * torch.eye(3, dtype=P.dtype, device=dev), c["Qf_scale"] * Q


def target(P: Prec, c: dict, dev) -> torch.Tensor:
    return P.t(c["x_target"], dev)


def init_state(P: Prec, c: dict, x0: torch.Tensor) -> dict:
    """The carry a lane starts an episode with: the plan interpolating x₀ to
    the target, hover controls [m₀, 0, 0], no duals, ρ from the settings."""
    dev, N = x0.device, c["N"]
    B = x0.shape[0]
    xT = target(P, c, dev)
    a = torch.linspace(0.0, 1.0, N + 1, dtype=P.dtype, device=dev)[None, :, None]
    U = torch.zeros(B, N, 3, dtype=P.dtype, device=dev)
    U[:, :, 0] = x0[:, 0:1]
    return {"X_lin": (1 - a) * x0[:, None] + a * xT, "U_lin": U,
            "x_ref": xT.expand(B, N + 1, 7).clone(),
            "rho": torch.full((B,), float(c["admm"]["rho"]), dtype=P.dtype, device=dev),
            "y": torch.zeros(B, N * 3, dtype=P.dtype, device=dev)}


def condense(P: Prec, A, Bm, cks, x0):
    """Γ (B, N, 7, 3N) and the free response d (B, N, 7) of x_{k+1}."""
    Bsz, N = Bm.shape[:2]
    G = torch.zeros(Bsz, 7, 3 * N, dtype=A.dtype, device=A.device)
    d = x0
    Gs, ds = [], []
    for k in range(N):
        G = P.mm(A[:, k], G)
        G[:, :, 3 * k:3 * k + 3] = Bm[:, k]
        d = P.mv(A[:, k], d) + cks[:, k]
        Gs.append(G)
        ds.append(d)
    return torch.stack(Gs, 1), torch.stack(ds, 1)


def cycle(P: Prec, c: dict, gp, state: dict, x0: torch.Tensor) -> dict:
    """One cycle of every lane; returns u0, the plan X_opt/U_opt, the carry
    it leaves (X_shift, U_shift, y, ρ), Σ, whether the solve was accepted,
    its primal residual, and the other branch's u0 and carry."""
    dev = x0.device
    N, dt = c["N"], c["dt"]
    nom = dyn.Rocket()
    s = settings(c)
    X_lin, U_lin, x_ref = state["X_lin"], state["U_lin"], state["x_ref"]
    B = x0.shape[0]

    tape = gp.gated_mean(X_lin[:, :-1], U_lin)
    xs = [x0]
    for k in range(N):
        xs.append(dyn.step(nom, xs[-1], U_lin[:, k], dt) + dt * tape[:, k])
    X_sim = torch.stack(xs, 1)

    A, Bm, cn = dyn.jacobians(P, nom, X_sim, U_lin, dt)
    cks = cn + dt * gp.gated_mean(X_sim[:, :-1], U_lin)
    var = gp.variance(X_sim[:, :-1], U_lin)

    S = c["sigma0"] * torch.eye(7, dtype=P.dtype, device=dev).expand(B, 7, 7)
    Qgp = torch.diag_embed(torch.cat([torch.zeros_like(var[..., :1]).expand(B, N, 4),
                                      var * dt * dt], -1))
    Sig = [S]
    for k in range(N):
        S = P.mm(P.mm(A[:, k], S), A[:, k].transpose(1, 2)) + Qgp[:, k]
        Sig.append(S)
    Sigmas = torch.stack(Sig, 1)

    Q, R, Qf = weights(P, c, dev)
    Gs, ds = condense(P, A, Bm, cks, x0)
    W = torch.cat([Q.expand(N - 1, 7, 7), Qf[None]], 0)
    WG = P.einsum("kij,bkjl->bkil", W, Gs)
    H = P.einsum("bkij,bkil->bjl", Gs, WG) + torch.block_diag(*([R] * N))
    H = 0.5 * (H + H.transpose(1, 2))
    q = P.einsum("bkil,bki->bl", WG, ds - x_ref[:, 1:])
    u_min, u_max = P.t(c["u_min"], dev), P.t(c["u_max"], dev)
    lo = torch.maximum(u_min, U_lin - c["trust_u"]).reshape(B, -1)
    hi = torch.minimum(u_max, U_lin + c["trust_u"]).reshape(B, -1)
    I = torch.eye(3 * N, dtype=P.dtype, device=dev).expand(B, 3 * N, 3 * N)
    sol = admm.solve(P, H, q, I, lo, hi, U_lin.reshape(B, -1), state["y"], state["rho"], s)

    rp = sol["pri_res"]
    solved = sol["status"] == admm.SOLVED
    ok = solved | (rp <= c["accept_pri_tol"])
    U_new = sol["x"].reshape(B, N, 3)
    X_new = torch.cat([x0[:, None], P.einsum("bkij,bj->bki", Gs, sol["x"]) + ds], 1)
    out = {}
    for tag, take in (("", ok), ("alt_", ~ok)):
        Uo = torch.where(take[:, None, None], U_new, U_lin)
        Xo = torch.where(take[:, None, None], X_new, X_sim)
        out[tag + "u0"] = Uo[:, 0]
        out[tag + "X_opt"], out[tag + "U_opt"] = Xo, Uo
        out[tag + "X_shift"] = torch.cat([Xo[:, 1:], Xo[:, -1:]], 1)
        out[tag + "U_shift"] = torch.cat([Uo[:, 1:], Uo[:, -1:]], 1)
    out.update(y=sol["y"], rho=sol["rho"], Sigmas=Sigmas, ok=ok, pri_res=rp)
    return out


def plant_step(c: dict, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The drag-dispersed plant the fleet flies."""
    return dyn.step(dyn.Rocket(**c["plant"]), x, u, c["dt"])
