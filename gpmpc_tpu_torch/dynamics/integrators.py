"""Fixed-step ODE integrators (counterpart of
``gpmpc_tpu/dynamics/integrators.py``): Euler / RK4 / midpoint / Heun
steps, trajectory rollout, quaternion-exact steps, Hermite-Simpson and
trapezoidal collocation defects, and sensitivity propagation.

A step is a pure function of ``(f, x, u, dt)`` with no in-place updates, so
it composes with ``torch.func.jacfwd``/``vmap``; ``x``/``u`` may carry any
leading batch dimensions.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

VectorField = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def euler_step(f: VectorField, x, u, dt):
    """Forward Euler: x + dt * f(x, u)."""
    return x + dt * f(x, u)


def midpoint_step(f: VectorField, x, u, dt):
    """Explicit midpoint (RK2)."""
    k1 = f(x, u)
    return x + dt * f(x + 0.5 * dt * k1, u)


def heun_step(f: VectorField, x, u, dt):
    """Heun's method (trapezoidal predictor-corrector)."""
    k1 = f(x, u)
    k2 = f(x + dt * k1, u)
    return x + 0.5 * dt * (k1 + k2)


def rk4_step(f: VectorField, x, u, dt):
    """Classic fourth-order Runge-Kutta with zero-order-hold control."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


STEP_FNS = {
    "euler": euler_step,
    "midpoint": midpoint_step,
    "heun": heun_step,
    "rk4": rk4_step,
}


def get_step_fn(method: str):
    """Look up a step function by name ('euler'|'midpoint'|'heun'|'rk4')."""
    try:
        return STEP_FNS[method]
    except KeyError:
        raise ValueError(
            f"unknown integrator {method!r}; choose from {sorted(STEP_FNS)}")


def integrate_trajectory(f: VectorField, x0, U, dt, method: str = "rk4"):
    """Roll out N steps under a control sequence: x0 (…, n_x), U (…, N, n_u)
    → the state trajectory (…, N+1, n_x)."""
    step = get_step_fn(method)
    xs = [x0]
    for k in range(U.shape[-2]):
        xs.append(step(f, xs[-1], U[..., k, :], dt))
    return torch.stack(xs, dim=-2)


# Quaternion steps (scalar-first convention q = [w, x, y, z]); every function
# takes any leading batch dimensions.


def quaternion_multiply(q1, q2):
    """Hamilton product q1 ⊗ q2, scalar-first."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - (v1 * v2).sum(-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([w, v], dim=-1)


def quaternion_derivative(q, omega):
    """Kinematics q̇ = ½ [−ω·q_v ; q_w ω + ω × q_v] (q̇ = ½ [0, ω] ⊗ q with
    body rate ω)."""
    qw, qv = q[..., :1], q[..., 1:]
    dw = -0.5 * (omega * qv).sum(-1, keepdim=True)
    dv = 0.5 * (qw * omega + torch.linalg.cross(omega, qv, dim=-1))
    return torch.cat([dw, dv], dim=-1)


def quaternion_euler_step(q, omega, dt):
    """Euler step of quaternion kinematics followed by renormalization."""
    q_next = q + dt * quaternion_derivative(q, omega)
    return q_next / torch.linalg.vector_norm(q_next, dim=-1, keepdim=True)


def quaternion_exponential_step(q, omega, dt):
    """Exact exponential-map step q⁺ = exp(½ dt [0,ω]) ⊗ q: norm-preserving,
    and exact at ω = 0 through the normalized sinc."""
    theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True) * dt
    half = 0.5 * theta
    w = torch.cos(half)
    v = 0.5 * dt * torch.sinc(half / math.pi) * omega
    return quaternion_multiply(torch.cat([w, v], dim=-1), q)


# Collocation defects (for trajectory-optimization verification)


def trapezoidal_defect(f: VectorField, x0, x1, u0, u1, dt):
    """Trapezoidal collocation defect: x1 − x0 − dt/2 (f(x0,u0)+f(x1,u1))."""
    return x1 - x0 - 0.5 * dt * (f(x0, u0) + f(x1, u1))


def hermite_simpson_defect(f: VectorField, x0, x1, u0, u1, dt):
    """Hermite-Simpson collocation defect: the midpoint state from the cubic
    Hermite interpolant, x1 − x0 − dt/6 (f0 + 4 f_mid + f1)."""
    f0 = f(x0, u0)
    f1 = f(x1, u1)
    x_mid = 0.5 * (x0 + x1) + (dt / 8.0) * (f0 - f1)
    f_mid = f(x_mid, 0.5 * (u0 + u1))
    return x1 - x0 - (dt / 6.0) * (f0 + 4.0 * f_mid + f1)


def integrate_sensitivity(f: VectorField, x0, U, dt, method: str = "rk4"):
    """State-transition sensitivities along a rollout: x0 (…, n_x), U (…, N,
    n_u) → (X (…, N+1, n_x), Phis (…, N, n_x, n_x), Psis (…, N, n_x, n_u))
    with Phis[k] = ∂x_{k+1}/∂x_k and Psis[k] = ∂x_{k+1}/∂u_k, the exact
    forward-mode Jacobians of the discrete step (``torch.func.jacfwd``)."""
    from torch.func import jacfwd, vmap

    step = get_step_fn(method)
    one = lambda x, u: step(f, x, u, dt)
    jac = jacfwd(one, argnums=(0, 1))
    lead, n_x, n_u = x0.shape[:-1], x0.shape[-1], U.shape[-1]
    x = x0.reshape(-1, n_x)
    Uf = torch.broadcast_to(U, (*lead, *U.shape[-2:])).reshape(-1, U.shape[-2], n_u)
    xs, phis, psis = [x], [], []
    for k in range(Uf.shape[1]):
        Phi, Psi = vmap(jac)(x, Uf[:, k])
        x = one(x, Uf[:, k])
        xs.append(x)
        phis.append(Phi)
        psis.append(Psi)
    N = Uf.shape[1]
    return (torch.stack(xs, dim=1).reshape(*lead, N + 1, n_x),
            torch.stack(phis, dim=1).reshape(*lead, N, n_x, n_x),
            torch.stack(psis, dim=1).reshape(*lead, N, n_x, n_u))
