"""One control cycle of the safety-filtered rescue campaign, written plainly
from its definition: the condensed RTI step with its state-bound rows, the
predictive safety filter behind it, and the plant step.

The RTI step of every lane, from the episode's first state x_s and the
cycle's step k, the carried plan (X_lin, U_lin), shifted plan (X_prev,
U_prev), duals y and penalty ρ, and the measured state x₀:

1. the reference window: rows min(k, ref_horizon − 1) … + N of the cubic
   descent from x_s to the target over ``steps`` steps, held at its last
   row past its end;
2. roll the carried controls U_lin out from x₀ through the nominal model
   (the re-anchored linearization trajectory);
3. linearize the nominal step along it (autodiff Jacobians);
4. condense the QP onto the controls: the bound rows of every state
   component at x_1 … x_N (7 × N rows, stage by stage; a row whose bounds
   are both infinite is free), then the control box;
5. run ADMM from the shifted plan U_prev, the duals y and ρ: 25 iterations,
   the termination test, and 25 more for a lane that has not passed it
   (``v25``, ``v50``: the answers after 25 and after 50 iterations with no
   stop between, from which the check takes the program's schedule);
6. accept the solve where it is SOLVED or its primal residual is at most
   ``accept_pri_tol``, else keep the shifted plan and the duals.

The filter of every lane, given x and the RTI's control u_nom:

1. the backup rollout: one step of the candidate control, then N − 1 steps
   of emergency braking, on the nominal model padded with the downdraft
   gust · σ(centre − altitude) on the vertical velocity (where the
   configuration puts the gust on the filter's model, as it puts it on the
   plant); V(x_N) the funnel's value |v|² − slope · max(altitude, 0);
2. safe where V(x_N(u_nom)) ≤ α = v_free²;
3. ``scp_iterations`` times: V and ∂V/∂u at the linearization point u_lin
   (u_nom first) by autograd, the minimal-intervention QP in z = [u, s]

       min ½‖u‖² − u_nomᵀu + ½ w s²   s.t.  gᵀu − s ≤ α·margin − V + gᵀu_lin,
                                           s ≥ 0,  u_min ≤ u ≤ u_max,  s ≥ 0

   solved from [u_lin, 0] with 100 ADMM iterations in four chunks that all
   adapt ρ, and the polish; u_lin moves to the solution where it is SOLVED;
4. the control: u_nom where safe, else u_lin where the last QP is SOLVED,
   else the backup's; a hit where the lane is unsafe and in flight.

Departures: the infeasibility certificates of the 50-iteration answer are
taken over its whole run rather than over its second chunk (this QP is
feasible and strictly convex: neither certificate can fire on it).
"""

from __future__ import annotations

import torch

from . import admm
from . import dynamics3dof as dyn
from .prec import Prec


def nominal(c: dict) -> dyn.Rocket:
    v = c["vehicle"]
    return dyn.Rocket(I_sp=v["I_sp"], g0=v["g0"], T_max=v["T_max"], m_dry=v["m_dry"])


def target(P: Prec, c: dict, dev) -> torch.Tensor:
    return P.t(c["rti"]["x_target"], dev)


# -- the downdraft plant and the filter's model --------------------------------

def gust(c: dict, x: torch.Tensor) -> torch.Tensor:
    """The downdraft's vertical acceleration (B,)."""
    g = c["gust"]
    return g["scale"] * torch.sigmoid(g["centre"] - x[:, 1])


def padded_step(c: dict, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The nominal step, plus dt · the gust on the vertical velocity."""
    e = torch.zeros_like(x)
    e[:, 4] = 1.0
    return dyn.step(nominal(c), x, u, c["dt"]) + c["dt"] * gust(c, x)[:, None] * e


def plant_step(c: dict, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The plant the fleet flies: the nominal model padded with the downdraft."""
    return padded_step(c, x, u)


def filter_step(c: dict, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The filter's model: the padded step where the configuration puts the
    gust on it, else the nominal one."""
    if "filter_model" in c["gust"]["on"]:
        return padded_step(c, x, u)
    return dyn.step(nominal(c), x, u, c["dt"])


def funnel(c: dict, x: torch.Tensor) -> torch.Tensor:
    """The soft-landing funnel's value |v|² − slope · max(altitude, 0)."""
    f = c["funnel"]
    return (x[:, 4:7] ** 2).sum(-1) - f["slope"] * x[:, 1].clamp_min(0.0)


def alpha(c: dict) -> float:
    return c["funnel"]["v_free"] ** 2


def braking(c: dict, x: torch.Tensor) -> torch.Tensor:
    """Emergency braking: T_max against the velocity (straight up at rest)
    plus the weight m·(−g), scaled back into ‖u‖ ≤ T_max."""
    T = c["backup"]["T_max"]
    v = x[:, 4:7]
    vsq = (v * v).sum(-1, keepdim=True)
    moving = vsq > 1e-12
    vmag = torch.sqrt(torch.where(moving, vsq, torch.ones_like(vsq)))
    up = torch.zeros_like(v)
    up[:, 0] = 1.0
    d = torch.where(moving, -v / vmag, up)
    g = torch.as_tensor(c["backup"]["g_I"], dtype=x.dtype, device=x.device)
    u = d * T - x[:, 0:1] * g
    umag = torch.sqrt((u * u).sum(-1, keepdim=True).clamp_min(1e-12))
    return u * torch.clamp(T / umag, max=1.0)


def terminal(c: dict, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x_N after [u, braking, braking, …] on the filter's model."""
    x = filter_step(c, x, u)
    for _ in range(c["filter"]["N"] - 1):
        x = filter_step(c, x, braking(c, x))
    return x


def value_and_grad(c: dict, x: torch.Tensor, u: torch.Tensor):
    """(V(x_N(u)) (B,), ∂V/∂u (B, 3)) by autograd in the inputs' dtype."""
    with torch.enable_grad():
        u = u.detach().clone().requires_grad_(True)
        V = funnel(c, terminal(c, x.detach(), u))
        (g,) = torch.autograd.grad(V.sum(), u)
    return V.detach(), g


# -- the filter -----------------------------------------------------------------

def filter_settings(c: dict) -> admm.Settings:
    a = c["filter_admm"]
    return admm.Settings(max_iter=a["iterations"], check_interval=a["chunk"],
                         scaling=a["scaling"], adaptive_rho=a["adaptive_rho"],
                         rho_adapt_chunks=a["rho_adapt_chunks"], polish=a["polish"],
                         polish_delta=a["polish_delta"],
                         polish_refine_iters=a["polish_refine_iters"],
                         infeas_certs=a["infeas_certs"], rho=a["rho"], sigma=a["sigma"],
                         alpha=a["alpha"], eps_abs=a["eps"], eps_rel=a["eps"],
                         eps_infeas=a["eps_infeas"])


def intervention_qp(P: Prec, c: dict, u_nom, u_lin, V, g):
    """(H, q, A, l, u) of every lane's minimal-intervention QP in z = [u, s]."""
    f = c["filter"]
    B, dev = u_nom.shape[0], u_nom.device
    big = admm.INF
    H = torch.diag(P.t([1.0, 1.0, 1.0, f["slack_weight"]], dev)).expand(B, 4, 4)
    q = torch.cat([-u_nom, torch.zeros_like(u_nom[:, :1])], 1)
    I4 = torch.eye(4, dtype=P.dtype, device=dev).expand(B, 4, 4)
    row0 = torch.cat([g, -torch.ones_like(g[:, :1])], 1)[:, None]
    row1 = I4[:, 3:4]
    A = torch.cat([row0, row1, I4], 1)
    slack_hi = big if f["soft"] else 0.0
    col = lambda v: torch.full((B, 1), v, dtype=P.dtype, device=dev)
    hi0 = f["alpha_margin"] * alpha(c) - V + (g * u_lin).sum(-1)
    lo = torch.cat([col(-big), col(0.0), P.t(f["u_min"], dev).expand(B, 3), col(0.0)], 1)
    hi = torch.cat([hi0[:, None], col(slack_hi), P.t(f["u_max"], dev).expand(B, 3),
                    col(slack_hi)], 1)
    return H, q, A, lo, hi


def margin(Pr: Prec, H, q, A, x, y, z, eps: float) -> torch.Tensor:
    """max(r_p / (ε + ε‖·‖_p), r_d / (ε + ε‖·‖_d)) of the unscaled point: at
    most 1 exactly where ADMM's termination test passes on it."""
    amax = lambda t: t.abs().amax(-1)
    Ax, Hx, ATy = Pr.mv(A, x), Pr.mv(H, x), Pr.mv(A.transpose(1, 2), y)
    rp, rd = amax(Ax - z), amax(Hx + q + ATy)
    pn = torch.maximum(amax(Ax), amax(z))
    dn = torch.maximum(torch.maximum(amax(Hx), amax(ATy)), amax(q))
    return torch.maximum(rp / (eps + eps * pn), rd / (eps + eps * dn))


def scp_iteration(P: Prec, c: dict, x, u_nom, u_lin) -> dict:
    """One SCP iteration of the filter at u_lin: V, ∂V/∂u, the QP's
    solution, whether it is SOLVED, the margin of its final point, and the
    linearization point it hands on."""
    V, g = value_and_grad(c, x, u_lin)
    H, q, A, lo, hi = intervention_qp(P, c, u_nom, u_lin, V, g)
    z0 = torch.cat([u_lin, torch.zeros_like(u_lin[:, :1])], 1)
    sol = admm.solve(P, H, q, A, lo, hi, z0, None, None, filter_settings(c))
    ok = sol["status"] == admm.SOLVED
    return {"V": V, "g": g, "x": sol["x"], "ok": ok,
            "margin": margin(P, H, q, A, sol["x"], sol["y"], sol["z"], c["filter_admm"]["eps"]),
            "u_next": torch.where(ok[:, None], sol["x"][:, :3], u_lin)}


def filter_cycle(P: Prec, c: dict, x, u_nom, follow=None) -> dict:
    """The filter of every lane. ``follow[i]`` (B, 3), where given, is the
    linearization point of SCP iteration i in place of the one the
    reference's own iteration i − 1 hands on (the program's carry).
    Returns each iteration's values (``its``), whether the lane is safe,
    V(x_N(u_nom)), the backup's control, and the filtered control on each
    branch of the last QP's decision: ``u_qp`` (its solution), ``u_backup``."""
    x, u_nom = x.to(P.dtype), u_nom.to(P.dtype)
    its, u_lin = [], u_nom
    for i in range(c["filter"]["scp_iterations"]):
        if follow is not None and i > 0 and i < len(follow) and follow[i] is not None:
            u_lin = follow[i].to(P.dtype)
        it = scp_iteration(P, c, x, u_nom, u_lin)
        its.append(dict(it, u_lin=u_lin))
        u_lin = it["u_next"]
    V_nom = its[0]["V"]
    last = its[-1]
    return {"its": its, "safe": V_nom <= alpha(c), "V_nom": V_nom, "u_nom": u_nom,
            "u_qp": last["x"][:, :3], "u_keep": last["u_lin"], "qp_ok": last["ok"],
            "u_backup": braking(c, x)}


def filtered_control(f: dict, safe=None, qp_ok=None) -> torch.Tensor:
    """u_nom where safe, else the last QP's solution where SOLVED, else the
    backup's control; ``safe``/``qp_ok`` default to the reference's own."""
    safe = f["safe"] if safe is None else safe
    qp_ok = f["qp_ok"] if qp_ok is None else qp_ok
    return torch.where(safe[:, None], f["u_nom"],
                       torch.where(qp_ok[:, None], f["u_qp"], f["u_backup"]))


# -- the RTI step -----------------------------------------------------------------

def rti_settings(c: dict, iterations: int) -> admm.Settings:
    """``iterations`` ADMM iterations with one termination test at their end."""
    a = c["rti_admm"]
    return admm.Settings(max_iter=iterations, check_interval=iterations, scaling=a["scaling"],
                         adaptive_rho=a["adaptive_rho"], polish=a["polish"],
                         infeas_certs=a["infeas_certs"], rho=a["rho"], sigma=a["sigma"],
                         alpha=a["alpha"], eps_abs=a["eps"], eps_rel=a["eps"],
                         eps_infeas=a["eps_infeas"])


def window(P: Prec, c: dict, x_start: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each lane's reference rows min(k, ref_horizon − 1) … + N: the cubic
    Hermite position profile from (r, v) of x_s to the target's over T =
    steps · dt, the mass interpolated linearly."""
    r = c["descent_reference"]
    dev, N, S = x_start.device, c["N"], r["steps"]
    x0, xT = x_start[:, None], target(P, c, dev)[None, None]
    T = S * c["dt"]
    tau = torch.linspace(0.0, 1.0, S + 1, dtype=P.dtype, device=dev)[None, :, None]
    h00, h10 = 2 * tau**3 - 3 * tau**2 + 1, tau**3 - 2 * tau**2 + tau
    h01, h11 = -2 * tau**3 + 3 * tau**2, tau**3 - tau**2
    d00, d10 = (6 * tau**2 - 6 * tau) / T, 3 * tau**2 - 4 * tau + 1
    d01, d11 = (-6 * tau**2 + 6 * tau) / T, 3 * tau**2 - 2 * tau
    r0, v0, rT, vT = x0[..., 1:4], x0[..., 4:7], xT[..., 1:4], xT[..., 4:7]
    pos = h00 * r0 + h10 * T * v0 + h01 * rT + h11 * T * vT
    vel = d00 * r0 + d10 * v0 + d01 * rT + d11 * vT
    mass = (1 - tau) * x0[..., :1] + tau * xT[..., :1]
    full = torch.cat([mass, pos, vel], -1)  # (B, S+1, 7)
    rows = k.long().clamp(max=r["ref_horizon"] - 1)[:, None] + torch.arange(N + 1, device=dev)
    return full[torch.arange(full.shape[0], device=dev)[:, None], rows.clamp(max=S)]


def rti_init(P: Prec, c: dict, x0: torch.Tensor) -> dict:
    """The carry a lane starts an episode with: the plan interpolating x₀ to
    the target, hover controls [m₀, 0, 0], no duals, ρ from the settings."""
    dev, N = x0.device, c["N"]
    B = x0.shape[0]
    xT = target(P, c, dev)
    a = torch.linspace(0.0, 1.0, N + 1, dtype=P.dtype, device=dev)[None, :, None]
    X = (1 - a) * x0[:, None] + a * xT
    U = torch.zeros(B, N, 3, dtype=P.dtype, device=dev)
    U[:, :, 0] = x0[:, 0:1]
    return {"X_lin": X, "U_lin": U, "X_prev": X, "U_prev": U,
            "rho": torch.full((B,), float(c["rti_admm"]["rho"]), dtype=P.dtype, device=dev),
            "y": torch.zeros(B, c["rti"]["qp_m"], dtype=P.dtype, device=dev)}


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


def rti_cycle(P: Prec, c: dict, state: dict, x0: torch.Tensor, x_start: torch.Tensor,
              k: torch.Tensor) -> dict:
    """One RTI step of every lane. Returns the window, the QP's constraint
    rows A, and for each ADMM schedule (``v25``: 25 iterations, ``v50``: 50)
    the plan (X_opt, U_opt) and the duals and ρ it carries on each branch of
    the acceptance (``alt_``: the other branch), whether the solve was
    accepted and its primal residual; ``conv25``, whether the test after 25
    iterations passes, and ``margin25``, its margin (≤ 1 passes)."""
    r, a = c["rti"], c["rti_admm"]
    dev = x0.device
    N, dt = c["N"], c["dt"]
    nom = nominal(c)
    B = x0.shape[0]
    x_ref = window(P, c, x_start, k)
    U_lin = state["U_lin"]
    X_sim = dyn.rollout(nom, x0, U_lin, dt)
    Aj, Bj, cj = dyn.jacobians(P, nom, X_sim, U_lin, dt)
    Gs, ds = condense(P, Aj, Bj, cj, x0)

    Q = torch.diag(P.t(r["Q_diag"], dev))
    R = r["R"] * torch.eye(3, dtype=P.dtype, device=dev)
    W = torch.cat([Q.expand(N - 1, 7, 7), r["Qf_scale"] * Q[None]], 0)
    WG = P.einsum("kij,bkjl->bkil", W, Gs)
    H = P.einsum("bkij,bkil->bjl", Gs, WG) + torch.block_diag(*([R] * N))
    H = 0.5 * (H + H.transpose(1, 2))
    q = P.einsum("bkil,bki->bl", WG, ds - x_ref[:, 1:])

    big = 1e19
    x_min, x_max = P.t(r["x_min"], dev), P.t(r["x_max"], dev)
    lo_x = torch.where(x_min <= -big, x_min.expand_as(ds), x_min - ds)
    hi_x = torch.where(x_max >= big, x_max.expand_as(ds), x_max - ds)
    Amat = torch.cat([Gs.reshape(B, N * 7, 3 * N),
                      torch.eye(3 * N, dtype=P.dtype, device=dev).expand(B, 3 * N, 3 * N)], 1)
    lo = torch.cat([lo_x.reshape(B, -1), P.t(r["u_min"], dev).repeat(N).expand(B, 3 * N)], 1)
    hi = torch.cat([hi_x.reshape(B, -1), P.t(r["u_max"], dev).repeat(N).expand(B, 3 * N)], 1)

    X_prev, U_prev, y_prev = state["X_prev"], state["U_prev"], state["y"]
    out = {"x_ref": x_ref, "A": Amat}
    for tag, iters in (("v25", a["chunk"]), ("v50", a["iterations"])):
        sol = admm.solve(P, H, q, Amat, lo, hi, U_prev.reshape(B, -1), y_prev, state["rho"],
                         rti_settings(c, iters))
        rp = sol["pri_res"]
        ok = (sol["status"] == admm.SOLVED) | (rp <= r["accept_pri_tol"])
        U_sol = sol["x"].reshape(B, N, 3)
        X_sol = torch.cat([x0[:, None], P.einsum("bkij,bj->bki", Gs, sol["x"]) + ds], 1)
        v = {"ok": ok, "pri_res": rp, "rho": sol["rho"]}
        for br, take in (("", ok), ("alt_", ~ok)):
            v[br + "X_opt"] = torch.where(take[:, None, None], X_sol, X_prev)
            v[br + "U_opt"] = torch.where(take[:, None, None], U_sol, U_prev)
            v[br + "y"] = torch.where(take[:, None], sol["y"], y_prev)
        out[tag] = v
        if tag == "v25":
            out["conv25"] = sol["status"] != admm.MAX_ITER  # solved or certified: frozen
            out["margin25"] = margin(P, H, q, Amat, sol["x"], sol["y"], sol["z"], a["eps"])
    return out

