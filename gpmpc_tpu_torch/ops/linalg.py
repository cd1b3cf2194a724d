"""Dense linear-algebra building blocks (counterpart of
``gpmpc_tpu/ops/linalg.py``): the Riccati solvers, robust Cholesky and
weighted distances.

The algebraic Riccati equations are solved as the JAX package solves them,
by a fixed count of matrix products and solves (structure-preserving
doubling for the discrete one, the matrix sign function for the continuous
one), so they run with no host sync and take an optional leading batch
axis. The solves use the ``_ex`` forms: a singular system gives non-finite
values, as in JAX, instead of raising."""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _T(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def _solve(A: Tensor, B: Tensor) -> Tensor:
    """A⁻¹B for matrices B, leading axes broadcast (expanded first, so an
    unbatched B is never read as a batch of vectors)."""
    lead = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    return torch.linalg.solve_ex(A.expand(*lead, *A.shape[-2:]), B.expand(*lead, *B.shape[-2:]),
                                 check_errors=False)[0]


def solve_dare(A: Tensor, B: Tensor, Q: Tensor, R: Tensor, iters: int = 25) -> Tensor:
    """Discrete algebraic Riccati equation P = AᵀPA − AᵀPB(R+BᵀPB)⁻¹BᵀPA + Q
    by structure-preserving doubling (``iters`` = 25 reaches f32 precision
    for any reasonably conditioned system). A (..., n, n), B (..., n, m),
    Q (..., n, n), R (..., m, m), leading axes broadcast."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Ak, Gk, Hk = A, B @ _solve(R, _T(B)), Q
    for _ in range(iters):
        W = eye + Gk @ Hk
        WinvA, WinvG = _solve(W, Ak), _solve(W, Gk)
        Ak, Gk, Hk = Ak @ WinvA, Gk + Ak @ WinvG @ _T(Ak), Hk + _T(Ak) @ Hk @ WinvA
    return 0.5 * (Hk + _T(Hk))


def dlqr(A: Tensor, B: Tensor, Q: Tensor, R: Tensor, iters: int = 25) -> Tuple[Tensor, Tensor]:
    """Discrete LQR gain K and cost-to-go P, with u = −K x."""
    P = solve_dare(A, B, Q, R, iters)
    K = _solve(R + _T(B) @ P @ B, _T(B) @ P @ A)
    return K, P


def solve_care(A: Tensor, B: Tensor, Q: Tensor, R: Tensor, iters: int = 30) -> Tensor:
    """Continuous ARE AᵀP + PA − PBR⁻¹BᵀP + Q = 0 through the matrix sign
    function of the Hamiltonian (Newton iteration Z ← ½(dZ + Z⁻¹/d) with
    the determinant scaling d = |det Z|^(−1/2n)); P from the stable
    subspace span[I; P] by least squares. Shapes as :func:`solve_dare`."""
    n = A.shape[-1]
    G = B @ _solve(R, _T(B))
    lead = torch.broadcast_shapes(A.shape[:-2], G.shape[:-2], Q.shape[:-2])
    A, G, Q = (M.expand(*lead, n, n) for M in (A, G, Q))
    Z = torch.cat([torch.cat([A, -G], -1), torch.cat([-Q, -_T(A)], -1)], -2)
    for _ in range(iters):
        Zinv = torch.linalg.inv_ex(Z, check_errors=False)[0]
        d = torch.linalg.det(Z).abs() ** (-1.0 / (2 * n))
        Z = 0.5 * (d[..., None, None] * Z + Zinv / d[..., None, None])
    # sign(H) = Z; the stable subspace span[I; X] satisfies Z[I; X] = −[I; X]:
    # Z12 X = −(Z11 + I), (Z22 + I) X = −Z21
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    M = torch.cat([Z[..., :n, n:], Z[..., n:, n:] + eye], dim=-2)
    rhs = -torch.cat([Z[..., :n, :n] + eye, Z[..., n:, :n]], dim=-2)
    P = torch.linalg.lstsq(M, rhs).solution
    return 0.5 * (P + _T(P))


def clqr(A: Tensor, B: Tensor, Q: Tensor, R: Tensor, iters: int = 30) -> Tuple[Tensor, Tensor]:
    """Continuous LQR gain K = R⁻¹BᵀP and P."""
    P = solve_care(A, B, Q, R, iters)
    return _solve(R, _T(B) @ P), P


def robust_cholesky(M: torch.Tensor, jitters=(0.0, 1e-8, 1e-6, 1e-4, 1e-2)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky with the JAX package's jitter ladder, for a batch of
    matrices (..., n, n). Each matrix takes the first level whose
    factorization succeeds (``cholesky_ex`` info 0 and a finite factor),
    relative to the mean of its diagonal; if none does, the last (largest)
    level. Levels past the first are only computed while some matrix still
    needs one. Returns (L, jitter_used)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    scale = torch.diagonal(M, dim1=-2, dim2=-1).mean(-1).clamp_min(1e-30)
    L = torch.full_like(M, float("nan"))
    used = torch.zeros_like(scale)
    pending = torch.ones_like(scale, dtype=torch.bool)
    for k, j in enumerate(jitters):
        js = j * scale
        Lk, info = torch.linalg.cholesky_ex(M + js[..., None, None] * eye)
        ok = (info == 0) & torch.isfinite(Lk).all(-1).all(-1)
        if k == len(jitters) - 1:
            ok = torch.ones_like(ok)
        take = pending & ok
        L = torch.where(take[..., None, None], Lk, L)
        used = torch.where(take, js, used)
        pending = pending & ~take
        if not bool(pending.any()):
            break
    return L, used


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b given lower-triangular L (b: (..., n, k))."""
    return torch.cholesky_solve(b, L, upper=False)


def weighted_sq_dists(X: torch.Tensor, Z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ‖(x−z)·√w‖² as one matmul: X (..., n, d),
    Z (..., S, d) → (..., n, S), with leading axes broadcast (the JAX
    function is the unbatched case). Kept in the ‖a‖²+‖b‖²−2a·b form with
    a = X√w, b = Z√w, so its f32 cancellation is the JAX package's; clipped
    at 0."""
    sw = torch.sqrt(w)
    Xs = X * sw
    Zs = Z * sw
    d = ((Xs * Xs).sum(-1)[..., :, None] + (Zs * Zs).sum(-1)[..., None, :]
         - 2.0 * Xs @ Zs.transpose(-1, -2))
    return d.clamp_min(0.0)
