"""One control cycle of the 6-DoF GP-MPC fleet, written plainly from its
definition, and the plant step.

For every lane, from the episode's first state x_s and the cycle's step k
in the episode, the carried plan (X_lin, U_lin), duals y and penalty ρ and
the measured state x₀:

1. the reference window: rows min(k, ref_horizon − 1) … + N of the cubic
   descent from x_s to the target over ``steps`` steps, held at its last
   row past its end;
2. roll the carried controls out from x₀ through the nominal model plus
   dt · the GP's gated mean frozen at the carried knots (the residual tape);
3. linearize the nominal step along that rollout (autodiff Jacobians);
4. add dt · the GP's gated mean at the knots to the affine term, and take
   its variances;
5. propagate Σ_{k+1} = A Σ Aᵀ + dt² diag(0₄, σ²_v, 0₄, σ²_ω) from σ₀·I;
6. back off the bounds of the states in ``tighten_states`` by κσ (κ the
   normal quantile of the confidence, at most 0.4 of the box's width) and
   intersect them with the trust region about the rollout;
7. condense the QP onto the controls: the bound rows of the states in
   ``x_bound_mask`` (q and ω, 7 × N rows, stage by stage), then the control
   box intersected with the trust region;
8. run ADMM from the carried (U_lin, y, ρ): 30 iterations, the test, and
   30 more for a lane that has not passed it (``v30``, ``v60``: the answers
   after 30 and after 60 iterations without a stop between, from which the
   check takes the program's schedule);
9. accept the plan where the solve is SOLVED or its primal residual is at
   most ``accept_pri_tol``, else keep the rollout; shift it one step.

Departures: none beyond the dynamics' (``dynamics6dof.py``); the condensed
QP's objective is ½ Σ (x_k − r_k)ᵀ W_k (x_k − r_k) + ½ Σ u_kᵀ R u_k, W_k = Q
for k < N and Q_f at N, the reference project's.
"""

from __future__ import annotations

import dataclasses

import torch

from . import admm
from . import dynamics6dof as dyn
from .prec import Prec


def nominal(c: dict) -> dyn.Rocket:
    v = c["vehicle"]
    return dyn.Rocket(I_sp=v["I_sp"], g0=v["g0"], J_B=tuple(v["J_B"]), r_T_B=tuple(v["r_T_B"]),
                      r_cp_B=tuple(v["r_cp_B"]), g_I=tuple(v["g_I"]), S_ref=v["S_ref"])


def plant(c: dict) -> dyn.Rocket:
    p = c["plant"]
    return dataclasses.replace(nominal(c), rho=p["rho"], C_A=tuple(p["C_A"]))


def settings(c: dict, iterations: int) -> admm.Settings:
    """``iterations`` ADMM iterations with one termination test at their end."""
    a = c["admm"]
    return admm.Settings(max_iter=iterations, check_interval=iterations, scaling=a["scaling"],
                         adaptive_rho=False, polish=False, infeas_certs=False, rho=a["rho"],
                         sigma=a["sigma"], alpha=a["alpha"], eps_abs=a["eps"], eps_rel=a["eps"])


def target(P: Prec, c: dict, dev) -> torch.Tensor:
    return P.t(c["x_target"], dev)


def window(P: Prec, c: dict, x_start: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each lane's reference rows min(k, ref_horizon − 1) … + N: the cubic
    Hermite position profile from (r, v) of x_s to the target's over T =
    steps · dt, mass and attitude columns interpolated linearly."""
    r = c["descent_reference"]
    dev, N, dt, S = x_start.device, c["N"], c["dt"], r["steps"]
    x0, xT = x_start[:, None], target(P, c, dev)[None, None]
    T = S * dt
    tau = torch.linspace(0.0, 1.0, S + 1, dtype=P.dtype, device=dev)[None, :, None]
    h00, h10 = 2 * tau**3 - 3 * tau**2 + 1, tau**3 - 2 * tau**2 + tau
    h01, h11 = -2 * tau**3 + 3 * tau**2, tau**3 - tau**2
    d00, d10 = (6 * tau**2 - 6 * tau) / T, 3 * tau**2 - 4 * tau + 1
    d01, d11 = (-6 * tau**2 + 6 * tau) / T, 3 * tau**2 - 2 * tau
    r0, v0, rT, vT = x0[..., 1:4], x0[..., 4:7], xT[..., 1:4], xT[..., 4:7]
    pos = h00 * r0 + h10 * T * v0 + h01 * rT + h11 * T * vT
    vel = d00 * r0 + d10 * v0 + d01 * rT + d11 * vT
    lin = (1 - tau) * x0 + tau * xT
    full = torch.cat([lin[..., :1], pos, vel, lin[..., 7:]], -1)  # (B, S+1, 14)
    rows = k.long().clamp(max=r["ref_horizon"] - 1)[:, None] + torch.arange(N + 1, device=dev)
    return full[torch.arange(full.shape[0], device=dev)[:, None], rows.clamp(max=S)]


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
            "rho": torch.full((B,), float(c["admm"]["rho"]), dtype=P.dtype, device=dev),
            "y": torch.zeros(B, c["qp_m"], dtype=P.dtype, device=dev)}


def condense(P: Prec, A, Bm, cks, x0):
    """Γ (B, N, 14, 3N) and the free response d (B, N, 14) of x_{k+1}."""
    Bsz, N = Bm.shape[:2]
    G = torch.zeros(Bsz, 14, 3 * N, dtype=A.dtype, device=A.device)
    d = x0
    Gs, ds = [], []
    for k in range(N):
        G = P.mm(A[:, k], G)
        G[:, :, 3 * k:3 * k + 3] = Bm[:, k]
        d = P.mv(A[:, k], d) + cks[:, k]
        Gs.append(G)
        ds.append(d)
    return torch.stack(Gs, 1), torch.stack(ds, 1)


def _margin(Pr: Prec, H, q, A, x, y, z, eps: float) -> torch.Tensor:
    """max(r_p / (ε + ε‖·‖_p), r_d / (ε + ε‖·‖_d)) of the unscaled iterate:
    at most 1 exactly where ADMM's termination test passes."""
    amax = lambda t: t.abs().amax(-1)
    Ax, Hx, ATy = Pr.mv(A, x), Pr.mv(H, x), Pr.mv(A.transpose(1, 2), y)
    rp, rd = amax(Ax - z), amax(Hx + q + ATy)
    pn = torch.maximum(amax(Ax), amax(z))
    dn = torch.maximum(torch.maximum(amax(Hx), amax(ATy)), amax(q))
    return torch.maximum(rp / (eps + eps * pn), rd / (eps + eps * dn))


def cycle(P: Prec, c: dict, gp, state: dict, x0: torch.Tensor, x_start: torch.Tensor,
          k: torch.Tensor) -> dict:
    """One cycle of every lane. Returns Σ, the reference window, the QP's
    constraint rows A, and for each ADMM schedule (``v30``: 30 iterations, ``v60``: 60) u0, the carry it
    leaves (X_shift, U_shift, y, ρ), whether the solve was accepted, its
    primal residual, and the other branch's u0 and plan; ``conv30``,
    whether the test after 30 iterations passes, and ``margin30``, its
    margin (≤ 1 passes)."""
    dev = x0.device
    N, dt = c["N"], c["dt"]
    nom = nominal(c)
    X_lin, U_lin = state["X_lin"], state["U_lin"]
    x_ref = window(P, c, x_start, k)
    B = x0.shape[0]

    tape = gp.gated_mean(X_lin[:, :-1], U_lin)
    xs = [x0]
    for j in range(N):
        xs.append(dyn.step(nom, xs[-1], U_lin[:, j], dt) + dt * tape[:, j])
    X_sim = torch.stack(xs, 1)

    A, Bm, cn = dyn.jacobians(P, nom, X_sim, U_lin, dt)
    cks = cn + dt * gp.gated_mean(X_sim[:, :-1], U_lin)
    var = gp.variance(X_sim[:, :-1], U_lin)  # (B, N, 6)

    zero4 = torch.zeros_like(var[..., :4])
    Qgp = torch.diag_embed(torch.cat([zero4, var[..., :3], zero4, var[..., 3:]], -1) * dt * dt)
    S = c["sigma0"] * torch.eye(14, dtype=P.dtype, device=dev).expand(B, 14, 14)
    Sig = [S]
    for j in range(N):
        S = P.mm(P.mm(A[:, j], S), A[:, j].transpose(1, 2)) + Qgp[:, j]
        Sig.append(S)
    Sigmas = torch.stack(Sig, 1)

    x_min, x_max = P.t(c["x_min"], dev), P.t(c["x_max"], dev)
    kappa = torch.special.ndtri(torch.tensor(c["confidence"], dtype=P.dtype, device=dev))
    backoff = kappa * torch.sqrt(torch.diagonal(Sigmas, dim1=-2, dim2=-1).clamp_min(0.0))
    backoff = torch.minimum(backoff, c["backoff_cap"] * (x_max - x_min))
    mask = torch.zeros(14, dtype=P.dtype, device=dev)
    mask[c["tighten_states"]] = 1.0
    backoff = backoff * mask
    Xlo = torch.maximum(x_min + backoff, X_sim - c["trust_x"])[:, 1:]
    Xhi = torch.minimum(x_max - backoff, X_sim + c["trust_x"])[:, 1:]

    Q = torch.diag(P.t(c["Q_diag"], dev))
    R = c["R"] * torch.eye(3, dtype=P.dtype, device=dev)
    Gs, ds = condense(P, A, Bm, cks, x0)
    W = torch.cat([Q.expand(N - 1, 14, 14), c["Qf_scale"] * Q[None]], 0)
    WG = P.einsum("kij,bkjl->bkil", W, Gs)
    H = P.einsum("bkij,bkil->bjl", Gs, WG) + torch.block_diag(*([R] * N))
    H = 0.5 * (H + H.transpose(1, 2))
    q = P.einsum("bkil,bki->bl", WG, ds - x_ref[:, 1:])
    sel = [i for i, keep in enumerate(c["x_bound_mask"]) if keep]
    u_min, u_max = P.t(c["u_min"], dev), P.t(c["u_max"], dev)
    Amat = torch.cat([Gs[:, :, sel].reshape(B, N * len(sel), 3 * N),
                      torch.eye(3 * N, dtype=P.dtype, device=dev).expand(B, 3 * N, 3 * N)], 1)
    lo = torch.cat([(Xlo[..., sel] - ds[..., sel]).reshape(B, -1),
                    torch.maximum(u_min, U_lin - c["trust_u"]).reshape(B, -1)], 1)
    hi = torch.cat([(Xhi[..., sel] - ds[..., sel]).reshape(B, -1),
                    torch.minimum(u_max, U_lin + c["trust_u"]).reshape(B, -1)], 1)

    X_new_of = lambda x: torch.cat([x0[:, None], P.einsum("bkij,bj->bki", Gs, x) + ds], 1)
    out = {"Sigmas": Sigmas, "x_ref": x_ref, "A": Amat}
    for tag, iters in (("v30", c["admm"]["chunk"]), ("v60", c["admm"]["iterations"])):
        sol = admm.solve(P, H, q, Amat, lo, hi, U_lin.reshape(B, -1), state["y"], state["rho"],
                         settings(c, iters))
        rp = sol["pri_res"]
        ok = (sol["status"] == admm.SOLVED) | (rp <= c["accept_pri_tol"])
        U_new, X_new = sol["x"].reshape(B, N, 3), X_new_of(sol["x"])
        v = {"y": sol["y"], "rho": sol["rho"], "ok": ok, "pri_res": rp}
        for br, take in (("", ok), ("alt_", ~ok)):
            Uo = torch.where(take[:, None, None], U_new, U_lin)
            Xo = torch.where(take[:, None, None], X_new, X_sim)
            v[br + "u0"] = Uo[:, 0]
            v[br + "X_shift"] = torch.cat([Xo[:, 1:], Xo[:, -1:]], 1)
            v[br + "U_shift"] = torch.cat([Uo[:, 1:], Uo[:, -1:]], 1)
        out[tag] = v
        if tag == "v30":
            out["conv30"] = sol["status"] == admm.SOLVED
            out["margin30"] = _margin(P, H, q, Amat, sol["x"], sol["y"], sol["z"],
                                      c["admm"]["eps"])
    return out


def plant_step(c: dict, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The dispersed plant the fleet flies: aero on, and dt · a steady wind
    added to the velocity after the step."""
    wind = torch.as_tensor(c["plant"]["wind"], dtype=x.dtype, device=x.device)
    return dyn.step(plant(c), x, u, c["dt"]) + c["dt"] * wind
