"""The exploration GP of the 3-DoF configuration, written plainly: data by
hover excitation of the drag plant, the velocity residual against the
nominal model, 11 features, Lloyd's k-means for the inducing inputs, a FITC
sparse GP per residual component (SE-ARD kernel, shared lengthscales), and
its variance-gated posterior mean.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import dynamics3dof as dyn
from .prec import Prec

X_START = (2.0, 30.0, 1.0, -1.0, -3.0, 0.5, 0.2)
X_RESET = (2.0, 25.0, -1.0, 2.0, -4.0, -0.5, 0.1)
NOISE_STD = 1e-4  # the configured noise is a standard deviation: variance 1e-8
JITTER = 1e-6
RETRY_JITTER = 1e-3  # relative to the mean diagonal, where a plain factor fails
# the configuration computes in float32: whether a plain factor fails is
# decided there, whatever the reference's own precision
DECIDE_DTYPE = torch.float32
ATMOSPHERE = (1.0, 10.0)  # ρ(h) = ρ₀ exp(−max(h, 0)/H)


def explore(P: Prec, excitation: torch.Tensor, nominal: dyn.Rocket, plant: dyn.Rocket,
            dt: float):
    """128 hover-excited steps of the plant from X_START, reset to X_RESET
    when the altitude falls to 0.5. Returns (X, U, residuals (n, 3))."""
    dev = excitation.device
    noise = excitation.to(P.dtype)
    x = P.t(X_START, dev)
    x_reset = P.t(X_RESET, dev)
    Xs, Us, Xn = [], [], []
    for k in range(noise.shape[0]):
        hover = torch.cat([x[:1], torch.zeros_like(x[1:3])])  # −m·g with g = (−1, 0, 0)
        u = dyn.clamp_thrust(nominal, hover + 0.3 * noise[k])
        xn = dyn.step(plant, x, u, dt)
        Xs.append(x)
        Us.append(u)
        Xn.append(xn)
        x = xn if float(xn[1]) > 0.5 else x_reset
    X, U, Xn = torch.stack(Xs), torch.stack(Us), torch.stack(Xn)
    res = (Xn - dyn.step(nominal, X, U, dt)) / dt
    return X, U, res[:, 4:7]


def features(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[v (3), ‖v‖, T (3), ‖T‖, h, ρ(h), m]."""
    v, h = x[..., 4:7], x[..., 1:2]
    rho = ATMOSPHERE[0] * torch.exp(-h.clamp_min(0.0) / ATMOSPHERE[1])
    return torch.cat([v, torch.linalg.vector_norm(v, dim=-1, keepdim=True), u,
                      torch.linalg.vector_norm(u, dim=-1, keepdim=True), h, rho, x[..., 0:1]],
                     dim=-1)


def kmeans(Fx: torch.Tensor, init_idx: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Lloyd's algorithm from the rows ``init_idx``; an empty cluster keeps
    its centroid."""
    C = Fx[init_idx.long()]
    k = C.shape[0]
    for _ in range(iters):
        d2 = ((Fx[:, None, :] - C[None]) ** 2).sum(-1)
        a = torch.nn.functional.one_hot(d2.argmin(dim=1), k).to(Fx.dtype)
        cnt = a.sum(0)[:, None]
        C = torch.where(cnt > 0, (a.T @ Fx) / cnt.clamp_min(1.0), C)
    return C


def se_ard(X: torch.Tensor, Z: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    d = (X[..., :, None, :] - Z[..., None, :, :]) / ls
    return torch.exp(-0.5 * (d * d).sum(-1))


def factor(M: torch.Tensor):
    """Cholesky factor of M where a plain factorization in DECIDE_DTYPE
    succeeds; else of M plus RETRY_JITTER times its mean diagonal. Returns
    (L, whether the jitter was added)."""
    L32, info = torch.linalg.cholesky_ex(M.to(DECIDE_DTYPE))
    retry = int(info) != 0 or not bool(torch.isfinite(L32).all())
    if retry:
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        M = M + RETRY_JITTER * torch.diagonal(M).mean() * eye
    L, _ = torch.linalg.cholesky_ex(M)
    return L, retry


@dataclass
class GP:
    P: Prec
    Z: torch.Tensor  # (M, 11)
    ls: torch.Tensor  # (11,)
    Luu_inv: torch.Tensor  # (M, M)
    LB_inv: torch.Tensor  # (M, M)
    c: torch.Tensor  # (3, M)
    retried: tuple = (False, False)  # the jitter added to Kuu, to B

    def predict(self, x: torch.Tensor, u: torch.Tensor):
        """Posterior mean and variance (..., 3) of the velocity residual."""
        P = self.P
        Fs = features(x, u)
        lead = Fs.shape[:-1]
        K = se_ard(Fs.reshape(-1, Fs.shape[-1]), self.Z, self.ls)  # (s, M)
        v = P.mm(self.Luu_inv, K.T)  # (M, s)
        w = P.mm(self.LB_inv, v)
        mean = P.mm(self.c, w).T  # (s, 3)
        var = (1.0 - (v * v).sum(0) + (w * w).sum(0)).clamp_min(0.0)
        return mean.reshape(*lead, 3), var[:, None].expand(-1, 3).reshape(*lead, 3)

    def gated_mean(self, x, u):
        """The mean scaled by clip(1 − σ²/σ²_prior, 0, 1), lifted into the
        7-state (velocity rows)."""
        mean, var = self.predict(x, u)
        w = (1.0 - var).clamp(0.0, 1.0)
        m = mean * w
        return torch.cat([torch.zeros_like(m[..., :1]).expand(*m.shape[:-1], 4), m], dim=-1)

    def variance(self, x, u):
        return self.predict(x, u)[1]


def fit(P: Prec, X, U, res, init_idx: torch.Tensor) -> GP:
    """FITC on every point: ARD lengthscales √11 · the features' standard
    deviations (at least 0.1), signal variance 1, noise variance 1e-8."""
    Fx = features(X, U)
    n, d = Fx.shape
    mu = Fx.mean(0)
    ls = (torch.sqrt(((Fx - mu) ** 2).mean(0)) * math.sqrt(float(d))).clamp_min(0.1)
    Z = kmeans(Fx, init_idx)
    M = Z.shape[0]
    eye = torch.eye(M, dtype=P.dtype, device=X.device)
    Kuu = se_ard(Z, Z, ls) + JITTER * eye
    Luu, retry_uu = factor(Kuu)
    Luu_inv = torch.linalg.solve_triangular(Luu, eye, upper=False)
    V = P.mm(Luu_inv, se_ard(Z, Fx, ls))  # (M, n)
    lam = (1.0 - (V * V).sum(0)).clamp_min(1e-8) + NOISE_STD**2
    A = V / torch.sqrt(lam)
    LB, retry_B = factor(eye + P.mm(A, A.T))
    LB_inv = torch.linalg.solve_triangular(LB, eye, upper=False)
    c = P.mm(LB_inv, P.mm(A, (res / torch.sqrt(lam)[:, None]))).T  # (3, M)
    return GP(P=P, Z=Z, ls=ls, Luu_inv=Luu_inv, LB_inv=LB_inv, c=c, retried=(retry_uu, retry_B))
