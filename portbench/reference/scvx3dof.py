"""Free-final-time SCVX of the 3-DoF model, written plainly from its
definition: every (initial state, candidate time step) pair is a lane; each
SCP iteration linearizes the step along the exact rollout of the incumbent
controls, builds the sparse-form QP over z = [x₀, u₀, x₁, …, x_N] (x₀ pinned,
the linearized dynamics as equality rows, box rows on every variable cut to
the shrinking trust region), whose cost is the proximal term toward the
linearization point, a soft terminal state and −m_N, and solves it; a lane
takes the step when the solve is SOLVED or its primal residual is below the
acceptance tolerance. Each state keeps its lowest-fuel converged candidate
(converged: last step accepted and terminal defect below 1), or its
lowest-defect one where none converged.
"""

from __future__ import annotations

import torch

from . import admm
from . import dynamics3dof as dyn
from .prec import Prec


def settings(c: dict) -> admm.Settings:
    a = c["admm"]
    return admm.Settings(max_iter=a["max_iter"], check_interval=a["check_interval"],
                         scaling=a["scaling"], adaptive_rho=True,
                         rho_adapt_chunks=a["rho_adapt_chunks"], polish=True,
                         infeas_certs=True, rho=a["rho"], sigma=a["sigma"], alpha=a["alpha"],
                         eps_abs=a["eps"], eps_rel=a["eps"])


def join_z(X, U):
    B, N = U.shape[:2]
    return torch.cat([torch.cat([X[:, :-1], U], 2).reshape(B, -1), X[:, -1]], 1)


def split_z(z, N):
    B = z.shape[0]
    body = z[:, :N * 10].reshape(B, N, 10)
    return torch.cat([body[:, :, :7], z[:, None, N * 10:]], 1), body[:, :, 7:]


def qp(P: Prec, c: dict, x0, xT, dt, U, tr_scale: float):
    """The SCP subproblem of every lane: (H, q, A, l, u) and the rollout."""
    N, B, dev = c["N"], x0.shape[0], x0.device
    nom = dyn.Rocket()
    nz = 10 * N + 7
    n_eq = 7 * (N + 1)
    X_lin = dyn.rollout(nom, x0, U, dt[:, None])
    Ak, Bk, ck = dyn.jacobians(P, nom, X_lin, U, dt)
    x_min, x_max = P.t(c["x_min"], dev), P.t(c["x_max"], dev)
    u_min, u_max = P.t(c["u_min"], dev), P.t(c["u_max"], dev)
    tx, tu = c["trust_x"] * tr_scale, c["trust_u"] * tr_scale
    Xlo, Xhi = torch.maximum(x_min, X_lin - tx), torch.minimum(x_max, X_lin + tx)
    Ulo, Uhi = torch.maximum(u_min, U - tu), torch.minimum(u_max, U + tu)

    A = torch.zeros(B, n_eq + nz, nz, dtype=P.dtype, device=dev)
    i7 = torch.arange(7, device=dev)
    A[:, i7, i7] = 1.0
    for k in range(N):
        r = 7 + 7 * k
        A[:, r:r + 7, 10 * k:10 * k + 7] = Ak[:, k]
        A[:, r:r + 7, 10 * k + 7:10 * k + 10] = Bk[:, k]
        A[:, r + i7, 10 * k + 10 + i7] = -1.0
    iz = torch.arange(nz, device=dev)
    A[:, n_eq + iz, iz] = 1.0
    eq = torch.cat([x0, -ck.reshape(B, -1)], 1)
    lo = torch.cat([eq, join_z(Xlo, Ulo)], 1)
    hi = torch.cat([eq, join_z(Xhi, Uhi)], 1)

    reg = c["w_prox"] + c["eps_reg"]
    sel = torch.ones(7, dtype=P.dtype, device=dev)
    sel[0] = 0.0
    eye7 = torch.eye(7, dtype=P.dtype, device=dev)
    Q = c["w_stage"] * torch.diag(sel) + reg * eye7
    Qf_term = c["w_terminal"] * torch.diag(sel)
    R = reg * torch.eye(3, dtype=P.dtype, device=dev)
    H = torch.block_diag(*([Q, R] * N), Qf_term + reg * eye7).expand(B, nz, nz)
    a = torch.linspace(0.0, 1.0, N + 1, dtype=P.dtype, device=dev)[None, :, None]
    X_ref = (1 - a) * x0[:, None] + a * xT[:, None]
    qx = -c["w_stage"] * (X_ref[:, :-1] * sel) - c["w_prox"] * X_lin[:, :-1]
    qu = -c["w_prox"] * U
    qN = -c["w_terminal"] * (xT * sel) - c["w_prox"] * X_lin[:, -1]
    q = torch.cat([torch.cat([qx, qu], 2).reshape(B, -1), qN], 1)
    q[:, nz - 7] -= c["w_fuel"]
    return (H, q, A, lo, hi), X_lin


def solve_lanes(P: Prec, c: dict, x0, dt):
    """Fixed-final-time SCVX of every lane: x0 (B, 7), dt (B,)."""
    N, B, dev = c["N"], x0.shape[0], x0.device
    xT = P.t(c["x_target"], dev).expand(B, 7)
    U = torch.zeros(B, N, 3, dtype=P.dtype, device=dev)
    U[:, :, 0] = x0[:, 0:1]
    s = settings(c)
    rho = torch.full((B,), s.rho, dtype=P.dtype, device=dev)
    tr = 1.0
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(c["iterations"]):
        data, X_lin = qp(P, c, x0, xT, dt, U, tr)
        sol = admm.solve(P, *data, join_z(X_lin, U), None, rho, s)
        pri_res = sol["pri_res"]
        ok = (sol["status"] == admm.SOLVED) | (pri_res < c["accept_pri_tol"])
        U = torch.where(ok[:, None, None], split_z(sol["x"], N)[1], U)
        rho = sol["rho"]
        tr *= c["trust_shrink"]
    X = dyn.rollout(dyn.Rocket(), x0, U, dt[:, None])
    defect = (X[:, -1, 1:] - xT[:, 1:]).abs().amax(1)
    # converged with room: the last step accepted by a residual under half the
    # tolerance, the defect under 0.9 — a lane no rounding can tip either way
    firm = (pri_res < 0.5 * c["accept_pri_tol"]) & (defect < 0.9)
    return {"X": X, "U": U, "converged": ok & (defect < 1.0), "fuel": x0[:, 0] - X[:, -1, 0],
            "defect": defect, "dt": dt, "firm": firm}


def free_time(P: Prec, c: dict, x0s: torch.Tensor, dts: torch.Tensor) -> dict:
    """Every state of x0s (S, 7) over the candidates dts (C,); returns each
    state's chosen lane and, under ``lanes``, every lane."""
    S, C = x0s.shape[0], dts.shape[0]
    lanes = solve_lanes(P, c, x0s.repeat_interleave(C, 0), dts.repeat(S))
    conv = lanes["converged"].reshape(S, C)
    score = torch.where(conv, lanes["fuel"].reshape(S, C), torch.inf)
    score = torch.where(conv.any(1, keepdim=True), score, lanes["defect"].reshape(S, C))
    pick = torch.arange(S, device=x0s.device) * C + score.argmin(1)
    out = {k: v[pick] for k, v in lanes.items()}
    out["lanes"] = {k: v.reshape(S, C, *v.shape[1:]) for k, v in lanes.items()}
    return out


def rollout(x0, U, dt):
    """The exact rollout of U from x0 at each lane's dt (B,)."""
    return dyn.rollout(dyn.Rocket(), x0, U, dt[:, None])
