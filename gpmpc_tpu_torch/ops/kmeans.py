"""k-means (Lloyd) for inducing-point initialization (counterpart of
``gpmpc_tpu/ops/kmeans.py::kmeans``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pairwise_sq(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    return (X * X).sum(-1)[:, None] + (C * C).sum(-1)[None, :] - 2.0 * X @ C.T


def kmeans(
    X: torch.Tensor,
    k: int,
    iters: int = 20,
    mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    init_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm. Returns (centroids (k,d), assignments (n,)).

    The initial centroids are ``k`` distinct active points drawn with
    ``generator`` (or the rows ``init_idx``, so a test can start from the
    same points as the JAX package). Masked points never count; empty
    clusters keep their previous centroid."""
    n, d = X.shape
    m = torch.ones(n, dtype=torch.bool, device=X.device) if mask is None else mask
    if init_idx is None:
        p = m.to(torch.float32)
        if generator is not None and generator.device != p.device:
            p = p.to(generator.device)
        init_idx = torch.multinomial(p, k, replacement=False, generator=generator)
    C = X[init_idx.to(X.device)]
    big = torch.tensor(1e30, dtype=X.dtype, device=X.device)
    mf = m.to(X.dtype)
    for _ in range(iters):
        d2 = torch.where(m[:, None], _pairwise_sq(X, C), big)
        assign = d2.argmin(dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype) * mf[:, None]
        counts = onehot.sum(0)
        sums = onehot.T @ X
        C = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], C)
    d2 = torch.where(m[:, None], _pairwise_sq(X, C), big)
    return C, d2.argmin(dim=1)
