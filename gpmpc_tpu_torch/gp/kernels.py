"""GP covariance kernels (counterpart of ``gpmpc_tpu/gp/kernels.py``; the
SE-ARD kernel the 3-DoF slice uses).

Parameters may carry a leading stack axis (one kernel per GP output); a call
then returns one Gram matrix per output: (..., n_out, n_X, n_Z). Ahead of the
output axis the parameters may carry further batch dims (one GP per lane),
matched by the leading dims of the inputs: parameters (B, n_out, d) with
inputs (B, n, d).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .._device import DeviceLike, resolve_device


def _sq_dists(X: torch.Tensor, Z: torch.Tensor, inv_ls: torch.Tensor) -> torch.Tensor:
    """Scaled pairwise squared distances via the matmul identity; ``inv_ls``
    is (d,) or (..., n_out, d), and then X (..., n, d) and Z (..., M, d) get
    the output axis put in."""
    if inv_ls.dim() > 1:
        X, Z = X[..., None, :, :], Z[..., None, :, :]
    Xs = X * inv_ls[..., None, :]
    Zs = Z * inv_ls[..., None, :]
    d2 = ((Xs * Xs).sum(-1)[..., :, None] + (Zs * Zs).sum(-1)[..., None, :]
          - 2.0 * Xs @ Zs.transpose(-1, -2))
    return d2.clamp_min(0.0)


@dataclass
class SquaredExponentialARD:
    """k(x,z) = σ² exp(−½ Σ (x_d−z_d)²/ℓ_d²)."""

    log_variance: torch.Tensor  # (...)
    log_lengthscales: torch.Tensor  # (..., d)

    @classmethod
    def create(cls, n_dims: int, variance: float = 1.0, lengthscale: float = 1.0,
               device: DeviceLike = "cuda") -> "SquaredExponentialARD":
        dev = resolve_device(device)
        return cls(
            log_variance=torch.tensor(math.log(variance), dtype=torch.float32, device=dev),
            log_lengthscales=torch.full((n_dims,), math.log(lengthscale),
                                        dtype=torch.float32, device=dev),
        )

    def __call__(self, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        inv_ls = torch.exp(-self.log_lengthscales)
        return torch.exp(self.log_variance)[..., None, None] * torch.exp(
            -0.5 * _sq_dists(X, Z, inv_ls))

    def diagonal(self, X: torch.Tensor) -> torch.Tensor:
        """(..., n_X) prior variances."""
        v = torch.exp(self.log_variance)[..., None]
        return v.expand(*v.shape[:-1], X.shape[-2])


def stack_kernels(kernels) -> SquaredExponentialARD:
    """One kernel whose parameters stack ``kernels`` along a leading axis."""
    return SquaredExponentialARD(
        log_variance=torch.stack([k.log_variance for k in kernels]),
        log_lengthscales=torch.stack([k.log_lengthscales for k in kernels]),
    )


def create_kernel(name: str, n_dims: int, device: DeviceLike = "cuda", **kw):
    """Factory with the JAX package's names; only SE-ARD is ported."""
    name = name.lower()
    if name in ("rbf", "se", "se_ard", "squared_exponential"):
        return SquaredExponentialARD.create(n_dims, device=device, **kw)
    if name in ("se_iso", "rbf_iso", "matern32", "matern_32", "matern3/2",
                "matern52", "matern_52", "matern5/2", "white", "white_noise",
                "noise"):
        raise NotImplementedError(f"kernel {name!r} is not ported yet")
    raise ValueError(f"unknown kernel {name!r}")
