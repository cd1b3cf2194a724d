"""GP covariance kernels (counterpart of ``gpmpc_tpu/gp/kernels.py``): SE-ARD,
isotropic SE, Matérn 3/2 and 5/2 with ARD, white noise, and sums and
products of kernels (``k1 + k2``, ``k1 * k2``).

A kernel's parameters are its log-hyperparameter tensors, in field order
(a sum or product lists its parts' in turn): ``get_params``/``set_params``
flatten them as the JAX package flattens the kernel pytree.

Parameters may carry a leading stack axis (one kernel per GP output); a call
then returns one Gram matrix per output: (..., n_out, n_X, n_Z). Ahead of the
output axis the parameters may carry further batch dims (one GP per lane),
matched by the leading dims of the inputs: parameters (B, n_out, d) with
inputs (B, n, d).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import List, Sequence

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


def _scalar(v: float, dev) -> torch.Tensor:
    return torch.tensor(math.log(v), dtype=torch.float32, device=dev)


class _KernelOps:
    """Composition operators and the flat parameter interface."""

    def __add__(self, other):
        return SumKernel(parts=(self, other))

    def __mul__(self, other):
        return ProductKernel(parts=(self, other))

    def params(self) -> List[torch.Tensor]:
        """The log-hyperparameter tensors, in the JAX package's leaf order."""
        out = []
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, tuple):
                for part in v:
                    out.extend(part.params())
        return out

    def with_params(self, leaves: Sequence[torch.Tensor]):
        """This kernel with its parameter tensors replaced, in order."""
        it = iter(leaves)

        def rebuild(k):
            kw = {}
            for f in fields(k):
                v = getattr(k, f.name)
                if isinstance(v, torch.Tensor):
                    kw[f.name] = next(it)
                elif isinstance(v, tuple):
                    kw[f.name] = tuple(rebuild(p) for p in v)
            return replace(k, **kw)

        return rebuild(self)

    def map_params(self, fn):
        """This kernel with ``fn`` applied to every parameter tensor."""
        return self.with_params([fn(p) for p in self.params()])

    def get_params(self) -> torch.Tensor:
        leaves = self.params()
        return torch.cat([p.reshape(-1) for p in leaves]) if leaves else torch.zeros(0)

    def set_params(self, theta: torch.Tensor):
        out, i = [], 0
        for p in self.params():
            out.append(theta[i : i + p.numel()].reshape(p.shape))
            i += p.numel()
        return self.with_params(out)

    @property
    def n_params(self) -> int:
        return sum(p.numel() for p in self.params())

    def diagonal(self, X: torch.Tensor) -> torch.Tensor:
        """(..., n_X) prior variances: σ² at every point."""
        v = torch.exp(self.log_variance)[..., None]
        return v.expand(*v.shape[:-1], X.shape[-2])


@dataclass
class SquaredExponentialARD(_KernelOps):
    """k(x,z) = σ² exp(−½ Σ (x_d−z_d)²/ℓ_d²)."""

    log_variance: torch.Tensor  # (...)
    log_lengthscales: torch.Tensor  # (..., d)

    @classmethod
    def create(cls, n_dims: int, variance: float = 1.0, lengthscale: float = 1.0,
               device: DeviceLike = "cuda") -> "SquaredExponentialARD":
        dev = resolve_device(device)
        return cls(log_variance=_scalar(variance, dev),
                   log_lengthscales=_scalar(lengthscale, dev).repeat(n_dims))

    def __call__(self, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        inv_ls = torch.exp(-self.log_lengthscales)
        return torch.exp(self.log_variance)[..., None, None] * torch.exp(
            -0.5 * _sq_dists(X, Z, inv_ls))


RBF = SquaredExponentialARD
SE_ARD = SquaredExponentialARD


@dataclass
class SquaredExponentialIso(_KernelOps):
    """Isotropic SE: one lengthscale for every input dimension."""

    log_variance: torch.Tensor  # (...)
    log_lengthscale: torch.Tensor  # (...)

    @classmethod
    def create(cls, variance: float = 1.0, lengthscale: float = 1.0,
               device: DeviceLike = "cuda") -> "SquaredExponentialIso":
        dev = resolve_device(device)
        return cls(log_variance=_scalar(variance, dev),
                   log_lengthscale=_scalar(lengthscale, dev))

    def __call__(self, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        inv = torch.exp(-self.log_lengthscale)[..., None]
        inv_ls = inv.expand(*inv.shape[:-1], X.shape[-1])
        return torch.exp(self.log_variance)[..., None, None] * torch.exp(
            -0.5 * _sq_dists(X, Z, inv_ls))


@dataclass
class _MaternARD(_KernelOps):
    log_variance: torch.Tensor  # (...)
    log_lengthscales: torch.Tensor  # (..., d)

    @classmethod
    def create(cls, n_dims: int, variance: float = 1.0, lengthscale: float = 1.0,
               device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        return cls(log_variance=_scalar(variance, dev),
                   log_lengthscales=_scalar(lengthscale, dev).repeat(n_dims))

    def _d2(self, X, Z):
        return _sq_dists(X, Z, torch.exp(-self.log_lengthscales))


@dataclass
class Matern32(_MaternARD):
    """Matérn ν=3/2 with ARD: σ² (1 + √3 r) e^(−√3 r)."""

    def __call__(self, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        s = math.sqrt(3.0) * torch.sqrt(self._d2(X, Z) + 1e-12)
        return torch.exp(self.log_variance)[..., None, None] * (1.0 + s) * torch.exp(-s)


@dataclass
class Matern52(_MaternARD):
    """Matérn ν=5/2 with ARD: σ² (1 + √5 r + 5r²/3) e^(−√5 r)."""

    def __call__(self, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        d2 = self._d2(X, Z)
        s = math.sqrt(5.0) * torch.sqrt(d2 + 1e-12)
        return (torch.exp(self.log_variance)[..., None, None]
                * (1.0 + s + 5.0 * d2 / 3.0) * torch.exp(-s))


@dataclass
class WhiteNoise(_KernelOps):
    """k(x,z) = σ²·[x = z]: nonzero only where inputs coincide exactly."""

    log_variance: torch.Tensor  # (...)

    @classmethod
    def create(cls, variance: float = 1e-2, device: DeviceLike = "cuda") -> "WhiteNoise":
        return cls(log_variance=_scalar(variance, resolve_device(device)))

    def __call__(self, X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        same = (X[..., :, None, :] == Z[..., None, :, :]).all(-1).to(X.dtype)
        if self.log_variance.dim() > 0:
            same = same[..., None, :, :]
        return torch.exp(self.log_variance)[..., None, None] * same


@dataclass
class SumKernel(_KernelOps):
    """k = Σ kᵢ."""

    parts: tuple = ()

    def __call__(self, X, Z):
        out = self.parts[0](X, Z)
        for k in self.parts[1:]:
            out = out + k(X, Z)
        return out

    def diagonal(self, X):
        out = self.parts[0].diagonal(X)
        for k in self.parts[1:]:
            out = out + k.diagonal(X)
        return out


@dataclass
class ProductKernel(_KernelOps):
    """k = Π kᵢ."""

    parts: tuple = ()

    def __call__(self, X, Z):
        out = self.parts[0](X, Z)
        for k in self.parts[1:]:
            out = out * k(X, Z)
        return out

    def diagonal(self, X):
        out = self.parts[0].diagonal(X)
        for k in self.parts[1:]:
            out = out * k.diagonal(X)
        return out


def stack_kernels(kernels):
    """One kernel whose parameters stack ``kernels`` (of one structure) along
    a leading axis."""
    leaves = [k.params() for k in kernels]
    return kernels[0].with_params([torch.stack(ps) for ps in zip(*leaves)])


def create_kernel(name: str, n_dims: int, device: DeviceLike = "cuda", **kw):
    """Factory with the JAX package's names."""
    name = name.lower()
    if name in ("rbf", "se", "se_ard", "squared_exponential"):
        return SquaredExponentialARD.create(n_dims, device=device, **kw)
    if name in ("se_iso", "rbf_iso"):
        return SquaredExponentialIso.create(device=device, **kw)
    if name in ("matern32", "matern_32", "matern3/2"):
        return Matern32.create(n_dims, device=device, **kw)
    if name in ("matern52", "matern_52", "matern5/2"):
        return Matern52.create(n_dims, device=device, **kw)
    if name in ("white", "white_noise", "noise"):
        return WhiteNoise.create(device=device, **kw)
    raise ValueError(f"unknown kernel {name!r}")
