"""Fixed-step ODE integrators (counterpart of
``gpmpc_tpu/dynamics/integrators.py``, the steps the 3-DoF slice uses).

A step is a pure function of ``(f, x, u, dt)`` with no in-place updates, so
it composes with ``torch.func.jacfwd``/``vmap``; ``x``/``u`` may carry any
leading batch dimensions.
"""

from __future__ import annotations

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
