"""The 3-DoF residual GP (counterpart of ``Simple3DoFGP`` and its helpers in
``gpmpc_tpu/gp/structured_gp.py``): a three-output sparse GP on the 11-dim
3-DoF features, learning the velocity residual, with a fixed-capacity FIFO
data store."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .features import Simple3DoFFeatureExtractor
from .kernels import create_kernel, stack_kernels
from .sparse_gp import (
    MultiOutputSparseGPState,
    fit_sparse_multi,
    init_inducing_points,
    predict_sparse_multi,
)


@dataclass(frozen=True)
class StructuredGPConfig:
    max_data_points: int = 512
    n_inducing: int = 100
    kernel: str = "se_ard"
    method: str = "fitc"
    noise: float = 1e-4


@dataclass
class RingBuffer:
    """Fixed-capacity FIFO feature/target store."""

    X: torch.Tensor  # (cap, d)
    Y: torch.Tensor  # (cap, n_out)
    head: torch.Tensor  # () next write slot
    count: torch.Tensor  # () active rows (≤ cap)

    @classmethod
    def create(cls, capacity: int, d: int, n_out: int,
               device: DeviceLike = "cuda") -> "RingBuffer":
        dev = resolve_device(device)
        return cls(
            X=torch.zeros(capacity, d, device=dev),
            Y=torch.zeros(capacity, n_out, device=dev),
            head=torch.zeros((), dtype=torch.int32, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @property
    def capacity(self) -> int:
        return self.X.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.X.device) < self.count

    def add_batch(self, Xb: torch.Tensor, Yb: torch.Tensor) -> "RingBuffer":
        k = Xb.shape[0]
        idx = (self.head + torch.arange(k, device=Xb.device)) % self.capacity
        X = self.X.clone()
        Y = self.Y.clone()
        X[idx] = Xb
        Y[idx] = Yb
        return replace(
            self, X=X, Y=Y,
            head=((self.head + k) % self.capacity).to(torch.int32),
            count=torch.clamp(self.count + k, max=self.capacity).to(torch.int32),
        )


def _stacked_kernels(name: str, d: int, n_out: int, lengthscales=None,
                     variance: float = 1.0, device: DeviceLike = "cuda"):
    """Stack n_out kernels; ARD lengthscales default to 1 or to the given
    data-driven scale (see :func:`_data_lengthscales`)."""
    k = stack_kernels([create_kernel(name, d, variance=variance, device=device)
                       for _ in range(n_out)])
    if lengthscales is not None:
        k.log_lengthscales = torch.log(lengthscales)[None, :].repeat(n_out, 1)
    return k


def _data_lengthscales(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ARD lengthscale init ∝ per-dimension std of the active data, scaled by
    √d and floored at 0.1 (see the JAX package for the rationale)."""
    mf = mask.to(X.dtype)
    n = mf.sum().clamp_min(1.0)
    mu = (X * mf[:, None]).sum(0) / n
    var = (((X - mu) ** 2) * mf[:, None]).sum(0) / n
    d = X.shape[1]
    return (torch.sqrt(var) * math.sqrt(float(d))).clamp_min(0.1)


@dataclass
class Simple3DoFGP:
    """Three-output velocity-residual GP on 11-dim features."""

    config: StructuredGPConfig
    extractor: Simple3DoFFeatureExtractor
    buffer: RingBuffer
    gp: Optional[MultiOutputSparseGPState] = None
    is_fitted: bool = False

    @classmethod
    def create(cls, config: Optional[StructuredGPConfig] = None,
               device: DeviceLike = "cuda") -> "Simple3DoFGP":
        cfg = config or StructuredGPConfig()
        ex = Simple3DoFFeatureExtractor()
        return cls(config=cfg, extractor=ex,
                   buffer=RingBuffer.create(cfg.max_data_points, ex.n_features,
                                            3, device=device))

    @property
    def device(self) -> torch.device:
        return self.buffer.X.device

    def add_data_batch(self, X, U, R) -> "Simple3DoFGP":
        return replace(self, buffer=self.buffer.add_batch(
            self.extractor.extract(X, U), R))

    def fit(self, generator: Optional[torch.Generator] = None,
            init_idx: Optional[torch.Tensor] = None) -> "Simple3DoFGP":
        """Fit the sparse GP on the buffered data. ``generator`` draws the
        k-means start (``init_idx`` fixes it instead)."""
        cfg = self.config
        b = self.buffer
        kernels = _stacked_kernels(
            cfg.kernel, self.extractor.n_features, 3,
            _data_lengthscales(b.X, b.mask), device=self.device)
        Z = init_inducing_points(b.X, min(cfg.n_inducing, b.capacity),
                                 mask=b.mask, generator=generator,
                                 init_idx=init_idx)
        gp = fit_sparse_multi(kernels, b.X, b.Y, Z, noise=cfg.noise,
                              mask=b.mask, method=cfg.method)
        return replace(self, gp=gp, is_fitted=True)

    def predict(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var), each (..., 3), at states/controls with any leading
        dims."""
        lead = x.shape[:-1]
        F = self.extractor.extract(x, u).reshape(-1, self.extractor.n_features)
        pr = predict_sparse_multi(self.gp, F)
        return pr.mean.reshape(*lead, 3), pr.variance.reshape(*lead, 3)

    def predict_gated(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """Variance-gated mean: scaled by w = clip(1 − σ²/σ²_prior, 0, 1) per
        output, so the correction fades to zero where the GP has no data."""
        mean, var = self.predict(x, u)
        prior = torch.exp(self.gp.kernels.log_variance)
        w = (1.0 - var / prior.clamp_min(1e-12)).clamp(0.0, 1.0)
        return mean * w, var

    @staticmethod
    def lift_residual(residual3: torch.Tensor, n_x: int = 7) -> torch.Tensor:
        """Velocity residual (..., 3) → full-state residual (..., n_x)."""
        lead = residual3.shape[:-1]
        zeros = residual3.new_zeros(*lead, 4)
        out = torch.cat([zeros, residual3], dim=-1)
        if n_x > 7:
            out = torch.cat([out, residual3.new_zeros(*lead, n_x - 7)], dim=-1)
        return out
