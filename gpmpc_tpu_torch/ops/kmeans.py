"""k-means (Lloyd) and farthest-point sampling (counterpart of
``gpmpc_tpu/ops/kmeans.py``), with an optional leading lane axis: one
batched Lloyd serves B independent data sets, as the JAX package's ``vmap``
over lanes does."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pairwise_sq(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    return ((X * X).sum(-1)[..., :, None] + (C * C).sum(-1)[..., None, :]
            - 2.0 * X @ C.transpose(-1, -2))


def draw_active(mask: torch.Tensor, k: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``k`` distinct indices per data set ([B,] k), drawn uniformly among the
    active rows of ``mask`` ([B,] n) with ``generator`` (on its own device).
    A set with fewer than ``k`` active rows takes all of them, then its
    inactive rows in index order, so a nearly empty store still yields k
    starting rows (``jax.random.choice`` puts zero-probability rows last)."""
    gdev = mask.device if generator is None else generator.device
    u = torch.rand(mask.shape, generator=generator, device=gdev).to(mask.device)
    score = torch.where(mask, u, torch.full_like(u, -1.0))
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def kmeans(
    X: torch.Tensor,
    k: int,
    iters: int = 20,
    mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    init_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm on X ([B,] n, d). Returns (centroids ([B,] k, d),
    assignments ([B,] n)).

    The initial centroids are the rows ``init_idx`` ([B,] k; a test passes the
    JAX package's draw), else ``k`` distinct active rows drawn with
    ``generator`` (:func:`draw_active`). Masked points never count; empty
    clusters keep their previous centroid."""
    m = torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device) if mask is None else mask
    if init_idx is None:
        init_idx = draw_active(m, k, generator)
    idx = torch.as_tensor(init_idx, device=X.device).long()
    C = torch.take_along_dim(X, idx[..., None], dim=-2)
    big = torch.tensor(1e30, dtype=X.dtype, device=X.device)
    mf = m.to(X.dtype)[..., None]
    for _ in range(iters):
        d2 = torch.where(m[..., None], _pairwise_sq(X, C), big)
        onehot = torch.nn.functional.one_hot(d2.argmin(dim=-1), k).to(X.dtype) * mf
        counts = onehot.sum(-2)[..., None]
        sums = onehot.transpose(-1, -2) @ X
        C = torch.where(counts > 0, sums / counts.clamp_min(1.0), C)
    d2 = torch.where(m[..., None], _pairwise_sq(X, C), big)
    return C, d2.argmin(dim=-1)


def farthest_point_sampling(X: torch.Tensor, k: int, mask: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            first: Optional[int] = None) -> torch.Tensor:
    """Greedy max-min selection of k indices (k,) of X (n, d): the first is
    ``first``, or an active row drawn with ``generator``; each next one is
    the active row farthest from every row chosen so far."""
    n = X.shape[0]
    m = torch.ones(n, dtype=torch.bool, device=X.device) if mask is None else mask
    if first is None:
        first = int(draw_active(m, 1, generator)[0])
    big = torch.tensor(1e30, dtype=X.dtype, device=X.device)
    mind = torch.where(m, big, -big)
    picks = [torch.tensor(first, device=X.device)]
    for _ in range(k - 1):
        d2 = ((X - X[picks[-1]]) ** 2).sum(-1)
        mind = torch.minimum(mind, d2)
        picks.append(torch.where(m, mind, -big).argmax())
    return torch.stack(picks)
