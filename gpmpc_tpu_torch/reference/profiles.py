"""Analytic descent reference profiles (counterpart of
``gpmpc_tpu/reference/profiles.py``): a cubic polynomial in time from the
initial state to the landing target, with matched end velocities."""

from __future__ import annotations

import torch


def cubic_descent_reference(x0: torch.Tensor, x_target: torch.Tensor, n_steps: int,
                            dt: float) -> torch.Tensor:
    """Cubic position profile r(τ) with ṙ(0)=v₀, ṙ(T)=v_target and matched
    endpoints; mass interpolated linearly. Works for 7- and 14-state vectors
    (attitude/rate columns are interpolated linearly too). ``x0`` and
    ``x_target`` are (…, n_x) with broadcastable leading dims (one reference
    per lane); returns (…, n_steps+1, n_x)."""
    x0, x_target = torch.broadcast_tensors(x0, x_target)
    x0, xT = x0[..., None, :], x_target[..., None, :]
    T = n_steps * dt
    tau = torch.linspace(0.0, 1.0, n_steps + 1, dtype=x0.dtype, device=x0.device)[:, None]

    r0, rT = x0[..., 1:4], xT[..., 1:4]
    v0, vT = x0[..., 4:7], xT[..., 4:7]

    # Hermite cubic in normalized time with velocity scaling by T
    h00 = 2 * tau**3 - 3 * tau**2 + 1
    h10 = tau**3 - 2 * tau**2 + tau
    h01 = -2 * tau**3 + 3 * tau**2
    h11 = tau**3 - tau**2
    r = h00 * r0 + h10 * T * v0 + h01 * rT + h11 * T * vT
    # analytic derivative
    d00 = (6 * tau**2 - 6 * tau) / T
    d10 = 3 * tau**2 - 4 * tau + 1
    d01 = (-6 * tau**2 + 6 * tau) / T
    d11 = 3 * tau**2 - 2 * tau
    v = d00 * r0 + d10 * v0 + d01 * rT + d11 * vT

    m = (1 - tau) * x0[..., 0:1] + tau * xT[..., 0:1]
    parts = [m, r, v]
    if x0.shape[-1] > 7:
        parts.append((1 - tau) * x0[..., 7:] + tau * xT[..., 7:])
    return torch.cat(parts, dim=-1)


def pad_reference(X_ref: torch.Tensor, horizon: int) -> torch.Tensor:
    """Extend a reference (…, T, n_x) past its end by holding the final
    state: the receding-horizon window padding."""
    tail = X_ref[..., -1:, :].expand(*X_ref.shape[:-2], horizon, X_ref.shape[-1])
    return torch.cat([X_ref, tail], dim=-2)
