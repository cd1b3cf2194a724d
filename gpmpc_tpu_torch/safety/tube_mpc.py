"""Tube propagation and tube-based constraint tightening, lanes first
(counterpart of ``gpmpc_tpu/safety/tube_mpc.py``): the interval tube
e⁺ = |A_cl| e + w, the GP-driven tube (w from n_σ·σ_GP·dt in the velocity
and rate slices), the Monte-Carlo particle tube with quantile widths (draws
from an explicit ``torch.Generator``), the tighteners and the
``RobustTubeMPC`` facade. Propagators take leading axes (lanes) ahead of
the horizon axis."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class TubeMPCConfig:
    n_sigma: float = 2.0
    dt: float = 0.1
    quantile: float = 0.95


class TubePropagator:
    """e_{k+1} = |A_cl,k| e_k + w_k, and its GP-driven and Monte-Carlo
    variants."""

    def __init__(self, config: Optional[TubeMPCConfig] = None):
        self.config = config or TubeMPCConfig()

    def propagate(self, A_cls: Tensor, w: Tensor, e0: Optional[Tensor] = None) -> Tensor:
        """A_cls (..., N, n, n), w broadcast to (..., N, n), e0 (..., n)
        (default 0) → (..., N+1, n)."""
        N, n = A_cls.shape[-3], A_cls.shape[-1]
        lead = A_cls.shape[:-3]
        e = torch.broadcast_to(A_cls.new_zeros(n) if e0 is None else e0, (*lead, n))
        w = torch.broadcast_to(w, (*lead, N, n))
        es = [e]
        for k in range(N):
            e = (A_cls[..., k, :, :].abs() @ e[..., None])[..., 0] + w[..., k, :]
            es.append(e)
        return torch.stack(es, dim=-2)

    def propagate_gp(self, A_cls: Tensor, gp_vars: Tensor, e0: Optional[Tensor] = None) -> Tensor:
        """w_k = n_σ·σ_GP,k·dt in the velocity slice [4:7] (and the rate
        slice [11:14] for 14 states); gp_vars (..., N, n_gp)."""
        n = A_cls.shape[-1]
        c = self.config
        sig = torch.sqrt(gp_vars.clamp_min(0.0))
        z = lambda k: sig.new_zeros(*sig.shape[:-1], k)
        parts = [z(4), c.n_sigma * sig[..., :3] * c.dt]
        if n >= 14:
            parts += [z(4), c.n_sigma * sig[..., 3:6] * c.dt]
        w = torch.cat(parts, dim=-1)
        if w.shape[-1] < n:
            w = torch.cat([w, z(n - w.shape[-1])], dim=-1)
        return self.propagate(A_cls, w, e0)

    def propagate_monte_carlo(self, generator: torch.Generator, step_fn: Callable,
                              x_nom: Tensor, U: Tensor, noise_std: Tensor,
                              n_particles: int = 256) -> Tensor:
        """Quantile tube widths from the spread of ``n_particles`` particles
        about the nominal trajectory, per lane: x_nom (B, N+1, n) or
        (N+1, n), U (B, N, n_u) or (N, n_u); each step adds noise_std·N(0, 1)
        drawn from ``generator``. Returns (B, N+1, n) (or (N+1, n))."""
        single = x_nom.dim() == 2
        if single:
            x_nom, U = x_nom[None], U[None]
        Bsz, _, n = x_nom.shape
        P = n_particles
        parts = x_nom[:, :1].expand(Bsz, P, n)
        widths = [x_nom.new_zeros(Bsz, n)]
        for k in range(U.shape[1]):
            parts = step_fn(parts.reshape(Bsz * P, n),
                            U[:, k].repeat_interleave(P, dim=0)).reshape(Bsz, P, n)
            noise = torch.randn(parts.shape, generator=generator, device=generator.device,
                                dtype=parts.dtype).to(parts.device)
            parts = parts + noise_std * noise
            dev = (parts - x_nom[:, k + 1, None]).abs()
            widths.append(torch.quantile(dev, self.config.quantile, dim=1))
        out = torch.stack(widths, dim=1)
        return out[0] if single else out


class TubeConstraintTightener:
    """Shrink the constraint limits by the tube width; ``K`` (the ancillary
    gain) maps a state tube to the control back-off."""

    def __init__(self, K: Optional[Tensor] = None):
        self.K = K

    def tighten_box(self, lo: Tensor, hi: Tensor, e: Tensor):
        mid = 0.5 * (lo + hi)
        return torch.minimum(lo + e, mid), torch.maximum(hi - e, mid)

    def tighten_thrust(self, T_min, T_max, e: Tensor):
        """The control back-off ‖K e‖ on the thrust magnitude bounds."""
        du = torch.linalg.vector_norm(e @ self.K.T, dim=-1) if self.K is not None else 0.0
        return T_min + du, T_max - du

    def tighten_glideslope(self, gamma, e_pos: Tensor) -> Tensor:
        """The altitude back-off: require h·tanγ ≥ ‖r_h‖ + ‖e_pos‖."""
        return torch.linalg.vector_norm(e_pos, dim=-1)

    def tighten_tilt(self, theta_max, e_att: Tensor) -> Tensor:
        return theta_max - 2.0 * torch.linalg.vector_norm(e_att, dim=-1)


class RobustTubeMPC:
    """Nominal MPC plus the ancillary feedback u = u_nom − K(x − x_nom), with
    tube-tightened constraints."""

    def __init__(self, K: Tensor, propagator: Optional[TubePropagator] = None):
        self.K = K
        self.propagator = propagator or TubePropagator()
        self.tightener = TubeConstraintTightener(K)

    def ancillary_control(self, x: Tensor, x_nom: Tensor, u_nom: Tensor, u_min: Tensor,
                          u_max: Tensor) -> Tensor:
        u = u_nom - (x - x_nom) @ self.K.T
        return torch.minimum(torch.maximum(u, u_min), u_max)

    def tightened_bounds(self, A_cls: Tensor, w: Tensor, x_lo: Tensor, x_hi: Tensor):
        """Box bounds shrunk by the interval tube of A_cls (..., N, n, n):
        (lo, hi), each (..., N+1, n)."""
        e = self.propagator.propagate(A_cls, w)
        return self.tightener.tighten_box(x_lo, x_hi, e)
