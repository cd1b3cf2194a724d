"""Uncertainty propagation and constraint tightening, lanes first
(counterpart of ``gpmpc_tpu/mpc/uncertainty_prop.py``): linear covariance
propagation, the unscented transform, Monte-Carlo particles, linear, box and
sampled chance tightening, and the interval tube e⁺ = |A|e + w. The random
draws come from an explicit ``torch.Generator``."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .constraints import normal_quantile, quantile_constant

Tensor = torch.Tensor


class PropagatedUncertainty(NamedTuple):
    means: torch.Tensor  # (B, N+1, n_x)
    covariances: torch.Tensor  # (B, N+1, n_x, n_x)

    def std(self) -> Tensor:
        return torch.sqrt(torch.diagonal(self.covariances, dim1=-2, dim2=-1).clamp_min(0.0))

    def confidence_bounds(self, confidence: float = 0.95) -> Tuple[Tensor, Tensor]:
        kappa = normal_quantile(torch.tensor(confidence, dtype=self.means.dtype,
                                             device=self.means.device))
        s = self.std()
        return self.means - kappa * s, self.means + kappa * s


def gp_process_noise(gp_var: torch.Tensor, n_x: int, dt: float) -> torch.Tensor:
    """Q_GP = diag with GP variances ×dt² in the velocity slice [4:7] (and
    the rate slice [11:14] for 14 states); gp_var (..., n_gp) → (..., n_x, n_x)."""
    lead = gp_var.shape[:-1]
    parts = [gp_var.new_zeros(*lead, 4), gp_var[..., :3] * dt * dt]
    if n_x >= 14:
        parts += [gp_var.new_zeros(*lead, 4), gp_var[..., 3:6] * dt * dt]
    d = torch.cat(parts, dim=-1)
    if d.shape[-1] < n_x:
        d = torch.cat([d, gp_var.new_zeros(*lead, n_x - d.shape[-1])], dim=-1)
    return torch.diag_embed(d)


def propagate_linear(Aks, means, Sigma0, gp_vars: Optional[torch.Tensor] = None,
                     dt: float = 0.1) -> PropagatedUncertainty:
    """Σ_{k+1} = A_k Σ_k A_kᵀ + Q_GP,k per lane. Aks (B,N,n_x,n_x), means
    (B,N+1,n_x), Sigma0 (n_x,n_x) or (B,n_x,n_x), gp_vars (B,N,n_gp)."""
    Bsz, N, n_x, _ = Aks.shape
    if gp_vars is None:
        gp_vars = means.new_zeros(Bsz, N, 3 if n_x < 14 else 6)
    Qs = gp_process_noise(gp_vars, n_x, dt)
    S = torch.broadcast_to(Sigma0, (Bsz, n_x, n_x))
    Sigmas = [S]
    for k in range(N):
        A = Aks[:, k]
        S = A @ S @ A.transpose(1, 2) + Qs[:, k]
        Sigmas.append(S)
    return PropagatedUncertainty(means=means, covariances=torch.stack(Sigmas, dim=1))


def box_tightening(Sigmas: torch.Tensor, confidence: float = 0.95,
                   kappa: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-coordinate back-offs κ·σ_i for box bounds, (..., n_x).
    ``kappa`` overrides the Gaussian quantile, which is made once per
    (confidence, dtype, device) and kept on the device."""
    if kappa is None:
        kappa = quantile_constant(confidence, Sigmas.dtype, Sigmas.device)
    return kappa * torch.sqrt(torch.diagonal(Sigmas, dim1=-2, dim2=-1).clamp_min(0.0))


def _randn(generator: torch.Generator, shape, like: Tensor) -> Tensor:
    """Standard normal draws from ``generator`` on its device, moved to
    ``like``'s."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=like.dtype).to(like.device)


def _step_points(step_fn, pts: Tensor, u: Tensor) -> Tensor:
    """step_fn on points (B, P, n) under each lane's control u (B, n_u), as
    one batch of B·P rows."""
    Bsz, P, n = pts.shape
    return step_fn(pts.reshape(Bsz * P, n), u.repeat_interleave(P, dim=0)).reshape(Bsz, P, n)


def propagate_unscented(step_fn: Callable[[Tensor, Tensor], Tensor], x0: Tensor, Sigma0: Tensor,
                        U: Tensor, gp_vars: Optional[Tensor] = None, dt: float = 0.1,
                        alpha: float = 1e-1, beta: float = 2.0, kappa: float = 0.0
                        ) -> PropagatedUncertainty:
    """Unscented transform, per lane: 2n+1 sigma points stepped through the
    nonlinear dynamics each stage. x0 (B, n), Sigma0 (n, n) or (B, n, n),
    U (B, N, n_u), gp_vars (B, N, n_gp)."""
    Bsz, n = x0.shape
    N = U.shape[1]
    lam = alpha**2 * (n + kappa) - n
    wm = torch.cat([torch.tensor([lam / (n + lam)]), torch.full((2 * n,), 0.5 / (n + lam))])
    wc = wm.clone()
    wc[0] += 1 - alpha**2 + beta
    wm, wc = wm.to(x0), wc.to(x0)
    if gp_vars is None:
        gp_vars = x0.new_zeros(Bsz, N, 3 if n < 14 else 6)
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    mu, Sigma = x0, torch.broadcast_to(Sigma0, (Bsz, n, n))
    mus, Sigmas = [mu], [Sigma]
    for k in range(N):
        S = torch.linalg.cholesky_ex(Sigma + 1e-9 * eye)[0]
        scaled = (n + lam) ** 0.5 * S.transpose(1, 2)
        pts = torch.cat([mu[:, None], mu[:, None] + scaled, mu[:, None] - scaled], dim=1)
        prop = _step_points(step_fn, pts, U[:, k])
        mu = torch.einsum("p,bpi->bi", wm, prop)
        diff = prop - mu[:, None]
        Sigma = (torch.einsum("p,bpi,bpj->bij", wc, diff, diff)
                 + gp_process_noise(gp_vars[:, k], n, dt))
        mus.append(mu)
        Sigmas.append(Sigma)
    return PropagatedUncertainty(means=torch.stack(mus, dim=1),
                                 covariances=torch.stack(Sigmas, dim=1))


def propagate_monte_carlo(generator: torch.Generator, step_fn: Callable[[Tensor, Tensor], Tensor],
                          x0: Tensor, Sigma0: Tensor, U: Tensor, n_particles: int = 256,
                          gp_std_fn: Optional[Callable] = None) -> PropagatedUncertainty:
    """Particles, per lane: draw initial states from N(x0, Σ0), roll each
    through the dynamics (plus ``gp_std_fn(parts, u)``·N(0, 1) noise a step
    when given; parts (B, P, n), u (B, 1, n_u)), estimate the moments.
    Draws come from ``generator``."""
    Bsz, n = x0.shape
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    L = torch.linalg.cholesky_ex(torch.broadcast_to(Sigma0, (Bsz, n, n)) + 1e-9 * eye)[0]
    parts = x0[:, None] + _randn(generator, (Bsz, n_particles, n), x0) @ L.transpose(1, 2)
    traj = [parts]
    for k in range(U.shape[1]):
        parts = _step_points(step_fn, parts, U[:, k])
        if gp_std_fn is not None:
            parts = parts + gp_std_fn(parts, U[:, k, None]) * _randn(generator, parts.shape, parts)
        traj.append(parts)
    traj = torch.stack(traj, dim=1)  # (B, N+1, P, n)
    mus = traj.mean(dim=2)
    diffs = traj - mus[:, :, None]
    Sigmas = torch.einsum("bkpi,bkpj->bkij", diffs, diffs) / (n_particles - 1)
    return PropagatedUncertainty(means=mus, covariances=Sigmas)


class UncertaintyPropagator:
    """Facade selecting the method: "linear", "unscented" or "monte_carlo"."""

    def __init__(self, method: str = "linear", dt: float = 0.1):
        self.method = method
        self.dt = dt

    def propagate(self, **kw) -> PropagatedUncertainty:
        if self.method == "linear":
            return propagate_linear(dt=self.dt, **kw)
        if self.method == "unscented":
            return propagate_unscented(dt=self.dt, **kw)
        if self.method == "monte_carlo":
            return propagate_monte_carlo(**kw)
        raise ValueError(f"unknown method {self.method!r}")


def linear_tightening(a: Tensor, Sigmas: Tensor, confidence: float = 0.95) -> Tensor:
    """Back-off κ·√(aᵀΣa) of a linear constraint aᵀx ≤ b for every Σ of
    Sigmas (..., n, n)."""
    kappa = normal_quantile(torch.tensor(confidence, dtype=Sigmas.dtype, device=Sigmas.device))
    quad = torch.einsum("i,...ij,j->...", a, Sigmas, a)
    return kappa * torch.sqrt(quad.clamp_min(0.0))


def sampled_tightening(generator: torch.Generator, mean: Tensor, Sigma: Tensor, a: Tensor,
                       quantile: float = 0.95, n_samples: int = 512) -> Tensor:
    """Empirical-quantile back-off of aᵀx from ``n_samples`` draws of
    N(mean, Σ): mean (..., n), Σ (..., n, n) → (...)."""
    n = mean.shape[-1]
    eye = torch.eye(n, dtype=mean.dtype, device=mean.device)
    L = torch.linalg.cholesky_ex(Sigma + 1e-9 * eye)[0]
    z = _randn(generator, (*mean.shape[:-1], n_samples, n), mean)
    vals = (mean[..., None, :] + z @ L.transpose(-1, -2)) @ a
    return torch.quantile(vals, quantile, dim=-1) - mean @ a


def propagate_tube(Aks: Tensor, w: Tensor, e0: Optional[Tensor] = None) -> Tensor:
    """Elementwise interval tube e_{k+1} = |A_k| e_k + w: Aks (..., N, n, n),
    w broadcast to (..., n), e0 (..., n) (default 0) → (..., N+1, n)."""
    n = Aks.shape[-1]
    e = Aks.new_zeros(n) if e0 is None else e0
    e = torch.broadcast_to(e, (*Aks.shape[:-3], n))
    es = [e]
    for k in range(Aks.shape[-3]):
        e = (Aks[..., k, :, :].abs() @ e[..., None])[..., 0] + w
        es.append(e)
    return torch.stack(es, dim=-2)


class TubeBasedRobustness:
    """Facade over :func:`propagate_tube` with a fixed disturbance bound w."""

    def __init__(self, w: Tensor):
        self.w = w

    def propagate(self, Aks: Tensor, e0: Optional[Tensor] = None) -> Tensor:
        return propagate_tube(Aks, self.w, e0)
