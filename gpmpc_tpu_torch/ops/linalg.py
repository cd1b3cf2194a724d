"""Dense linear-algebra building blocks (counterpart of the parts of
``gpmpc_tpu/ops/linalg.py`` the GP fit and the safe-set queries use)."""

from __future__ import annotations

from typing import Tuple

import torch


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
