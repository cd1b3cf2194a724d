"""The structured residual GP of the 6-DoF configuration, written plainly:
a three-output FITC sparse GP for the translational acceleration residual
d_v on 13 features, another for the rotational one d_ω on 12, each output
with its own SE-ARD kernel, and the variance-gated posterior mean lifted
into the 14-state.

The GP is made here (``make_weights``) from the states and controls the
fleet flew while collecting data, as the configuration fits it:

1. the targets: (x⁺ − f_nom(x, u)) / dt at the velocity and rate rows, x⁺
   the dispersed plant's step (held at x where the altitude is at most
   0.1, the flight's touchdown freeze);
2. each sub-GP's features, and Lloyd's k-means (``kmeans_iters``
   iterations, an empty cluster keeps its centroid) from the given start
   rows for its inducing inputs;
3. the initial hyperparameters: ARD lengthscales √d · the features'
   standard deviations (at least 0.1), signal variance 1, noise standard
   deviation 1e-4, alike for the three outputs;
4. ``tune_steps`` Adam steps (``tune_step_size``, β 0.9 / 0.999, ε 1e-8)
   on each output's negative FITC log marginal likelihood, the
   log-hyperparameters clipped to ``log_bounds``; an output whose loss or gradient is not finite skips
   the step; an output whose tuned loss is worse than its initial one keeps
   the initial hyperparameters.

The weights (features X, targets Y, inducing inputs Z, the
hyperparameters) are then factored output by output. A Cholesky factor is
taken plainly where that succeeds in the GP's own precision, else of the
matrix plus 1e-3 of its mean diagonal.

Departure from the published description: the data are the states and
controls the program's controller flew (a plain reference cannot replay a
closed loop, which moves far on one ulp), and the reference is handed them
as it is handed any input.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import dynamics6dof as dyn
from . import gpmpc6dof
from .gp3dof import ATMOSPHERE, kmeans
from .prec import Prec

JITTER = 1e-6  # on the diagonal of K_uu, absolute
RETRY_JITTER = 1e-3  # relative to the mean diagonal, where a plain factor fails
FREEZE_ALTITUDE = 0.1
SIGNAL_VARIANCE = 1.0
ADAM = (0.9, 0.999, 1e-8)  # β₁, β₂, ε


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _density(h: torch.Tensor) -> torch.Tensor:
    return ATMOSPHERE[0] * torch.exp(-h.clamp_min(0.0) / ATMOSPHERE[1])


def translational_features(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[v_I (3), ‖v‖, q̄ = ½ρ‖v‖², angle of attack, sideslip, T_B (3), ‖T‖, h,
    ρ(h)]: the angle of attack is atan2(v_B,z, v_B,x) with v_B,x kept off 0
    (1e-8) on its own sign, the sideslip asin(v_B,y / ‖v‖), ‖v‖ floored at 1e-8."""
    h, v = x[..., 1:2], x[..., 4:7]
    speed = _norm(v)
    rho = _density(h)
    vB = dyn.body_velocity(x)
    vx = vB[..., 0:1]
    aoa = torch.atan2(vB[..., 2:3], vx.abs().clamp_min(1e-8) * torch.sign(vx + 1e-12))
    slip = torch.arcsin((vB[..., 1:2] / speed.clamp_min(1e-8)).clamp(-1.0, 1.0))
    return torch.cat([v, speed, 0.5 * rho * speed**2, aoa, slip, u, _norm(u), h, rho], -1)


def rotational_features(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[ω_B (3), ‖ω‖, T_B (3), v_B (3), ‖v‖, q̄]."""
    w, v = x[..., 11:14], x[..., 4:7]
    speed = _norm(v)
    qbar = 0.5 * _density(x[..., 1:2]) * speed**2
    return torch.cat([w, _norm(w), u, dyn.body_velocity(x), speed, qbar], -1)


def se_ard(X: torch.Tensor, Z: torch.Tensor, ls: torch.Tensor, var: torch.Tensor):
    """k(x, z) = σ² exp(−½ Σ_d (x_d − z_d)²/ℓ_d²) of every output: X (n, d),
    Z (M, d), ls (3, d), var (3,) → (3, n, M)."""
    d = (X[None, :, None, :] - Z[None, None, :, :]) / ls[:, None, None, :]
    return var[:, None, None] * torch.exp(-0.5 * (d * d).sum(-1))


def factor(M: torch.Tensor):
    """Cholesky factors of M (…, n, n) in its own precision; a matrix whose
    plain factorization fails (or is not finite) takes RETRY_JITTER times
    its mean diagonal. Returns (L, which matrices took the jitter)."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0) | ~torch.isfinite(L).flatten(-2).all(-1)
    if bool(bad.any()):
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        lift = torch.where(bad, RETRY_JITTER * torch.diagonal(M, dim1=-2, dim2=-1).mean(-1), 0.0)
        L, _ = torch.linalg.cholesky_ex(M + lift[..., None, None] * eye)
    return L, bad


@dataclass
class SubGP:
    P: Prec
    Z: torch.Tensor  # (M, d)
    ls: torch.Tensor  # (3, d)
    var: torch.Tensor  # (3,) signal variances
    Luu_inv: torch.Tensor  # (3, M, M)
    LB_inv: torch.Tensor  # (3, M, M)
    c: torch.Tensor  # (3, M)
    retried: tuple  # per output: the jitter added to K_uu, to B

    def predict(self, F: torch.Tensor):
        """Posterior mean and variance (s, 3) at features F (s, d), computed
        in the GP's own precision."""
        P = self.P
        F = F.to(P.dtype)
        K = se_ard(F, self.Z, self.ls, self.var)  # (3, s, M)
        v = P.mm(self.Luu_inv, K.transpose(1, 2))  # (3, M, s)
        w = P.mm(self.LB_inv, v)
        mean = (P.mm(self.c[:, None, :], w))[:, 0]  # (3, s)
        var = (self.var[:, None] - (v * v).sum(1) + (w * w).sum(1)).clamp_min(0.0)
        return mean.T, var.T


def fit(P: Prec, weights: dict, device) -> SubGP:
    """FITC from the weights, all three outputs at once: Λ = max(σ² − q_ff,
    1e-8) + σ_n², B = I + V Λ⁻¹ Vᵀ with V = L_uu⁻¹ K_uf, c = L_B⁻¹ V Λ⁻¹ y."""
    t = lambda k: torch.as_tensor(weights[k], device=device).to(P.dtype)
    X, Y, Z = t("X"), t("Y"), t("Z")
    ls, var = torch.exp(t("log_lengthscales")), torch.exp(t("log_variance"))
    noise = torch.exp(2.0 * t("log_noise"))
    eye = torch.eye(Z.shape[0], dtype=P.dtype, device=device)
    Luu, r_uu = factor(se_ard(Z, Z, ls, var) + JITTER * eye)
    Luu_inv = torch.linalg.solve_triangular(Luu, eye.expand_as(Luu), upper=False)
    V = P.mm(Luu_inv, se_ard(Z, X, ls, var))  # (3, M, n)
    lam = (var[:, None] - (V * V).sum(1)).clamp_min(1e-8) + noise[:, None]
    A = V / torch.sqrt(lam)[:, None, :]
    LB, r_B = factor(eye + P.mm(A, A.transpose(1, 2)))
    LB_inv = torch.linalg.solve_triangular(LB, eye.expand_as(LB), upper=False)
    c = P.mm(LB_inv, P.mm(A, (Y / torch.sqrt(lam))[..., None]))[..., 0]
    retried = tuple((bool(a), bool(b)) for a, b in zip(r_uu.tolist(), r_B.tolist()))
    return SubGP(P=P, Z=Z, ls=ls, var=var, Luu_inv=Luu_inv, LB_inv=LB_inv, c=c, retried=retried)


def neg_lml(F, Y, Z, log_ls, log_var, log_noise) -> torch.Tensor:
    """The negative FITC log marginal likelihood of each output (3,): ½ (yᵀ
    (Q_ff + Λ)⁻¹ y + log|Q_ff + Λ| + n log 2π), by the matrix inversion and
    determinant lemmas through B. F (n, d), Y (3, n), log_ls (3, d),
    log_var and log_noise (3, 1)."""
    ls, var, noise = torch.exp(log_ls), torch.exp(log_var[:, 0]), torch.exp(2.0 * log_noise[:, 0])
    n = F.shape[0]
    eye = torch.eye(Z.shape[0], dtype=F.dtype, device=F.device)
    Luu, _ = factor(se_ard(Z, Z, ls, var) + JITTER * eye)
    V = torch.linalg.solve_triangular(Luu, se_ard(Z, F, ls, var), upper=False)  # (3, M, n)
    lam = (var[:, None] - (V * V).sum(1)).clamp_min(1e-8) + noise[:, None]
    A = V / torch.sqrt(lam)[:, None, :]
    LB, _ = factor(eye + A @ A.transpose(1, 2))
    b = Y / torch.sqrt(lam)
    c = torch.linalg.solve_triangular(LB, A @ b[..., None], upper=False)[..., 0]
    quad = (b * b).sum(-1) - (c * c).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)).sum(-1) + torch.log(lam).sum(-1)
    return 0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


def tune(F, Y, Z, params: list, steps: int, lr: float, bounds) -> list:
    """Adam on ``neg_lml`` of every output, as the module's docstring says.
    ``params``: [log_ls (3, d), log_var (3, 1), log_noise (3, 1)]."""
    b1, b2, eps = ADAM
    ps = [p.detach().clone() for p in params]
    m1, m2 = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]
    t = torch.zeros(3, 1, dtype=F.dtype, device=F.device)
    for _ in range(steps):
        req = [p.detach().requires_grad_(True) for p in ps]
        loss = neg_lml(F, Y, Z, *req)
        grads = torch.autograd.grad(loss.sum(), req)
        ok = torch.isfinite(loss.detach())
        for g in grads:
            ok = ok & torch.isfinite(g).all(-1)
        ok = ok[:, None]
        t = t + ok.to(t.dtype)
        with torch.no_grad():
            for i, g in enumerate(grads):
                g = torch.where(ok, g, 0.0)
                m1[i] = torch.where(ok, b1 * m1[i] + (1 - b1) * g, m1[i])
                m2[i] = torch.where(ok, b2 * m2[i] + (1 - b2) * g * g, m2[i])
                step = lr * (m1[i] / (1 - b1**t)) / (torch.sqrt(m2[i] / (1 - b2**t)) + eps)
                ps[i] = torch.where(ok, (ps[i] - step).clamp(*bounds), ps[i])
    with torch.no_grad():
        tuned, start = neg_lml(F, Y, Z, *ps), neg_lml(F, Y, Z, *params)
        better = (torch.isfinite(tuned) & (tuned <= start))[:, None]
    return [torch.where(better, p, q) for p, q in zip(ps, params)]


def targets(P: Prec, c: dict, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """(n, 6) residual targets [d_v, d_ω] of the flown transitions."""
    x, u, dt = X.to(P.dtype), U.to(P.dtype), c["dt"]
    landed = (x[:, 1] <= FREEZE_ALTITUDE)[:, None]
    x_next = torch.where(landed, x, gpmpc6dof.plant_step(c, x, u))
    err = (x_next - dyn.step(gpmpc6dof.nominal(c), x, u, dt)) / dt
    return torch.cat([err[:, 4:7], err[:, 11:14]], 1)


def make_weights(P: Prec, c: dict, X: torch.Tensor, U: torch.Tensor, init_idx) -> dict:
    """The GP's weights made from the flown states X (n, 14) and controls U
    (n, 3), each sub-GP's k-means starting from its rows ``init_idx``
    (translational, rotational)."""
    g = c["gp"]
    x, u = X.to(P.dtype), U.to(P.dtype)
    res = targets(P, c, x, u)
    out = {}
    for key, feats, cols, start in (("trans", translational_features, slice(0, 3), init_idx[0]),
                                    ("rot", rotational_features, slice(3, 6), init_idx[1])):
        F = feats(x, u)
        n, d = F.shape
        Y = res[:, cols].T.contiguous()
        Z = kmeans(F, start, g["kmeans_iters"])
        sd = torch.sqrt(((F - F.mean(0)) ** 2).mean(0))
        ls0 = (sd * math.sqrt(float(d))).clamp_min(0.1).log().expand(3, d)
        ones = torch.ones(3, 1, dtype=P.dtype, device=F.device)
        p0 = [ls0.contiguous(), math.log(SIGNAL_VARIANCE) * ones, math.log(g["noise_std"]) * ones]
        log_ls, log_var, log_noise = tune(F, Y, Z, p0, g["tune_steps"], g["tune_step_size"],
                                          g["log_bounds"])
        out[key] = {"X": F, "Y": Y, "Z": Z, "log_lengthscales": log_ls,
                    "log_variance": log_var[:, 0], "log_noise": log_noise[:, 0]}
    return out


@dataclass
class GP:
    trans: SubGP
    rot: SubGP

    def posterior(self, x: torch.Tensor, u: torch.Tensor):
        """Mean and variance (…, 6) = [d_v, d_ω]: the features in the states'
        precision, the posterior in the GP's."""
        lead = x.shape[:-1]
        ft = translational_features(x, u).reshape(-1, 13)
        fr = rotational_features(x, u).reshape(-1, 12)
        (mt, vt), (mr, vr) = self.trans.predict(ft), self.rot.predict(fr)
        return (torch.cat([mt, mr], -1).reshape(*lead, 6),
                torch.cat([vt, vr], -1).reshape(*lead, 6))

    def predict(self, x: torch.Tensor, u: torch.Tensor):
        """``posterior`` in the states' precision."""
        mean, var = self.posterior(x, u)
        return mean.to(x.dtype), var.to(x.dtype)

    def gated_mean(self, x, u):
        """The mean scaled by clip(1 − σ²/σ²_prior, 0, 1) output by output,
        in the GP's precision, lifted into the 14-state in the states': d_v
        to the velocity rows, d_ω to the rates."""
        mean, var = self.posterior(x, u)
        prior = torch.cat([self.trans.var, self.rot.var])
        m = (mean * (1.0 - var / prior).clamp(0.0, 1.0)).to(x.dtype)
        z = torch.zeros_like(m[..., :4])
        return torch.cat([z, m[..., :3], z, m[..., 3:]], -1)

    def variance(self, x, u):
        return self.predict(x, u)[1]

    @property
    def retried(self) -> list:
        return [list(r) for r in self.trans.retried + self.rot.retried]


def from_weights(P: Prec, weights: dict, device) -> GP:
    """The GP of the weights ``{"trans": {...}, "rot": {...}}``."""
    return GP(trans=fit(P, weights["trans"], device), rot=fit(P, weights["rot"], device))
