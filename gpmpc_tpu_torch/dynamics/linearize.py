"""Linearization utilities (counterpart of ``gpmpc_tpu/dynamics/linearize.py``):
forward-mode and finite-difference Jacobians, their verification, affine
models, the discretization of continuous Jacobians, and the batched affine
models along trajectories that the RTI/SCP solvers use.

Every function takes points with any leading batch dimensions: ``x`` (…,
n_x), ``u`` (…, n_u). ``f`` takes unbatched vectors and uses no in-place ops
(``torch.func`` vmaps it over the points).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap


def _points(x: torch.Tensor, u: torch.Tensor):
    lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    x = torch.broadcast_to(x, (*lead, x.shape[-1])).reshape(-1, x.shape[-1])
    u = torch.broadcast_to(u, (*lead, u.shape[-1])).reshape(-1, u.shape[-1])
    return lead, x, u


def ad_jacobians(f: Callable, x: torch.Tensor, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Jacobians (∂f/∂x (…, n, n_x), ∂f/∂u (…, n, n_u)) by forward-mode
    AD."""
    lead, xf, uf = _points(x, u)
    A, B = vmap(jacfwd(f, argnums=(0, 1)))(xf, uf)
    return A.reshape(*lead, *A.shape[1:]), B.reshape(*lead, *B.shape[1:])


def numerical_jacobians(f: Callable, x: torch.Tensor, u: torch.Tensor, eps: float = 1e-3,
                        method: str = "central") -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite-difference Jacobians ("forward" or "central"), every
    perturbation of every point evaluated in one batched call."""
    if method not in ("forward", "central"):
        raise ValueError(f"unknown method {method!r}")
    lead, xf, uf = _points(x, u)
    n_x, n_u = xf.shape[1], uf.shape[1]
    F = vmap(f)
    Ex = torch.eye(n_x, dtype=xf.dtype, device=xf.device) * eps
    Eu = torch.eye(n_u, dtype=uf.dtype, device=uf.device) * eps

    def diff(dx, du):
        # (P, k, n): f at every point shifted along each of k directions
        P, k = xf.shape[0], dx.shape[0]
        xs = (xf[:, None] + dx[None]).reshape(P * k, n_x)
        us = (uf[:, None] + du[None]).reshape(P * k, n_u)
        return F(xs, us).reshape(P, k, -1)

    zx, zu = Ex.new_zeros(n_x, n_u), Eu.new_zeros(n_u, n_x)
    if method == "forward":
        f0 = F(xf, uf)[:, None]
        A = (diff(Ex, zx) - f0) / eps
        B = (diff(zu, Eu) - f0) / eps
    else:
        A = (diff(Ex, zx) - diff(-Ex, zx)) / (2 * eps)
        B = (diff(zu, Eu) - diff(zu, -Eu)) / (2 * eps)
    A, B = A.transpose(1, 2), B.transpose(1, 2)
    return A.reshape(*lead, *A.shape[1:]), B.reshape(*lead, *B.shape[1:])


def verify_jacobians(f: Callable, jac_fn: Callable, x: torch.Tensor, u: torch.Tensor,
                     rtol: float = 1e-3, atol: float = 1e-4, eps: float = 1e-3) -> dict:
    """Compare ``jac_fn(x, u) → (A, B)`` against central differences; a
    report dict."""
    A_ana, B_ana = jac_fn(x, u)
    A_num, B_num = numerical_jacobians(f, x, u, eps=eps, method="central")
    a_ok = bool(torch.allclose(A_ana, A_num, rtol=rtol, atol=atol))
    b_ok = bool(torch.allclose(B_ana, B_num, rtol=rtol, atol=atol))
    return {
        "A_ok": a_ok,
        "B_ok": b_ok,
        "ok": a_ok and b_ok,
        "A_max_err": float((A_ana - A_num).abs().max()),
        "B_max_err": float((B_ana - B_num).abs().max()),
    }


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


class AffineModel(NamedTuple):
    """Discrete affine model x⁺ = A x + B u + c (any leading batch
    dimensions)."""

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor

    def predict(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return _mv(self.A, x) + _mv(self.B, u) + self.c

    @classmethod
    def from_linearization(cls, F: Callable, x: torch.Tensor, u: torch.Tensor
                           ) -> "AffineModel":
        """Exact affine model of a discrete step function F at (x, u)."""
        A, B = ad_jacobians(F, x, u)
        return cls(A, B, F(x, u) - _mv(A, x) - _mv(B, u))


def discretize_jacobians(A_c: torch.Tensor, B_c: torch.Tensor, dt: float,
                         method: str = "euler") -> Tuple[torch.Tensor, torch.Tensor]:
    """Discretize continuous Jacobians: "euler" (I + A dt), "taylor2" (I +
    A dt + A² dt²/2) or "zoh" (exact zero-order hold through the matrix
    exponential of [[A, B], [0, 0]] dt)."""
    n = A_c.shape[-1]
    eye = torch.eye(n, dtype=A_c.dtype, device=A_c.device)
    if method == "euler":
        return eye + A_c * dt, B_c * dt
    if method == "taylor2":
        A_d = eye + A_c * dt + 0.5 * (A_c @ A_c) * dt * dt
        return A_d, (eye * dt + 0.5 * A_c * dt * dt) @ B_c
    if method == "zoh":
        n_u = B_c.shape[-1]
        lead = torch.broadcast_shapes(A_c.shape[:-2], B_c.shape[:-2])
        M = A_c.new_zeros(*lead, n + n_u, n + n_u)
        M[..., :n, :n] = A_c
        M[..., :n, n:] = B_c
        E = torch.linalg.matrix_exp(M * dt)
        return E[..., :n, :n], E[..., :n, n:]
    raise ValueError(f"unknown method {method!r}")


def trajectory_jacobians(F: Callable, X: torch.Tensor, U: torch.Tensor, *lane_args
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact forward-mode Jacobians of the discrete step ``F(x, u,
    *lane_args)`` at every knot of a batch of trajectories. X is (B, N+1,
    n_x) or (B, N, n_x), U is (B, N, n_u); each of ``lane_args`` is a (B, …)
    tensor handed to F with the knot's lane (e.g. a per-lane time step).
    Returns A (B,N,n_x,n_x), B (B,N,n_x,n_u) and c (B,N,n_x) with
    F(x,u) ≈ A x + B u + c."""
    if X.shape[1] == U.shape[1] + 1:
        X = X[:, :-1]
    Bsz, N, n_x = X.shape
    n_u = U.shape[-1]
    x = X.reshape(Bsz * N, n_x)
    u = U.reshape(Bsz * N, n_u)
    args = [a.repeat_interleave(N, dim=0) for a in lane_args]

    def one(xk, uk, *ak):
        Ak, Bk = jacfwd(F, argnums=(0, 1))(xk, uk, *ak)
        return Ak, Bk, F(xk, uk, *ak) - Ak @ xk - Bk @ uk

    A, Bm, c = vmap(one)(x, u, *args)
    return (A.reshape(Bsz, N, n_x, n_x), Bm.reshape(Bsz, N, n_x, n_u),
            c.reshape(Bsz, N, n_x))
