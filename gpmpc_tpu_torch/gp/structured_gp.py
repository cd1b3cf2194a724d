"""Structured residual GPs (counterpart of ``gpmpc_tpu/gp/structured_gp.py``):

- :class:`StructuredRocketGP`, the 6-DoF model: separate three-output sparse
  GPs for the translational (d_v) and rotational (d_ω) acceleration
  residuals, on the 13-dim translational and 12-dim rotational features;
- :class:`Simple3DoFGP`, the 3-DoF model: one three-output sparse GP on the
  11-dim 3-DoF features, learning the velocity residual;

each with fixed-capacity FIFO data stores. Not ported yet: the masked batch
insert, the novelty test and persistence."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .features import (
    RotationalFeatureExtractor,
    Simple3DoFFeatureExtractor,
    TranslationalFeatureExtractor,
)
from .kernels import create_kernel, stack_kernels
from .sparse_gp import (
    MultiOutputSparseGPState,
    fit_sparse_multi,
    init_inducing_points,
    predict_sparse_multi,
    refit_sparse_multi,
)


@dataclass(frozen=True)
class StructuredGPConfig:
    max_data_points: int = 512
    n_inducing: int = 100
    kernel: str = "se_ard"
    method: str = "fitc"
    noise: float = 1e-4
    # fixed ARD lengthscale inits per feature group (tuples); None: data-driven
    trans_lengthscales: Optional[tuple] = None
    rot_lengthscales: Optional[tuple] = None
    signal_variance: float = 1.0


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


def _initial_hyperparameters(cfg: StructuredGPConfig, buf: RingBuffer, d: int,
                             fixed_ls=None, variance: float = 1.0):
    """(kernels, log_noise) a three-output fit on ``buf`` starts from: the
    fixed or data-driven ARD lengthscales and the configured noise."""
    dev = buf.X.device
    ls = (torch.as_tensor(fixed_ls, dtype=torch.float32, device=dev) if fixed_ls is not None
          else _data_lengthscales(buf.X, buf.mask))
    kernels = _stacked_kernels(cfg.kernel, d, 3, ls, variance=variance, device=dev)
    return kernels, torch.full((3,), math.log(cfg.noise), device=dev)


def _fit_buffer(cfg: StructuredGPConfig, buf: RingBuffer, kernels, generator, init_idx
                ) -> MultiOutputSparseGPState:
    Z = init_inducing_points(buf.X, min(cfg.n_inducing, buf.capacity), mask=buf.mask,
                             generator=generator, init_idx=init_idx)
    return fit_sparse_multi(kernels, buf.X, buf.Y, Z, noise=cfg.noise, mask=buf.mask,
                            method=cfg.method)


def _refit(g: MultiOutputSparseGPState, buf: RingBuffer) -> MultiOutputSparseGPState:
    return refit_sparse_multi(g.kernels, g.Z, buf.X, buf.Y.T.contiguous(), buf.mask,
                              g.log_noise, g.method)


def _predict(g: MultiOutputSparseGPState, F: torch.Tensor):
    """(mean, var), each (..., n_out), at features F with any leading dims."""
    lead = F.shape[:-1]
    pr = predict_sparse_multi(g, F.reshape(-1, F.shape[-1]))
    n_out = pr.mean.shape[-1]
    return pr.mean.reshape(*lead, n_out), pr.variance.reshape(*lead, n_out)


@dataclass
class StructuredRocketGP:
    """Six-output residual model of the 6-DoF rocket: d_v from translational
    features, d_ω from rotational features, each a three-output sparse GP
    with its own data store (both stores fill in lockstep)."""

    config: StructuredGPConfig
    trans_extractor: TranslationalFeatureExtractor
    rot_extractor: RotationalFeatureExtractor
    trans_buffer: RingBuffer
    rot_buffer: RingBuffer
    trans_gp: Optional[MultiOutputSparseGPState] = None
    rot_gp: Optional[MultiOutputSparseGPState] = None
    is_fitted: bool = False

    @classmethod
    def create(cls, config: Optional[StructuredGPConfig] = None,
               device: DeviceLike = "cuda") -> "StructuredRocketGP":
        cfg = config or StructuredGPConfig()
        te, re = TranslationalFeatureExtractor(), RotationalFeatureExtractor()
        return cls(config=cfg, trans_extractor=te, rot_extractor=re,
                   trans_buffer=RingBuffer.create(cfg.max_data_points, te.n_features, 3,
                                                  device=device),
                   rot_buffer=RingBuffer.create(cfg.max_data_points, re.n_features, 3,
                                                device=device))

    @property
    def device(self) -> torch.device:
        return self.trans_buffer.X.device

    @property
    def buffer_count(self) -> torch.Tensor:
        return self.trans_buffer.count

    def add_data_batch(self, X, U, residuals) -> "StructuredRocketGP":
        """Store a batch of transitions; ``residuals`` is (n, 6) = [d_v, d_ω]."""
        return replace(
            self,
            trans_buffer=self.trans_buffer.add_batch(self.trans_extractor.extract(X, U),
                                                     residuals[:, :3]),
            rot_buffer=self.rot_buffer.add_batch(self.rot_extractor.extract(X, U),
                                                 residuals[:, 3:6]))

    def initial_hyperparameters(self):
        """((kernels, log_noise) translational, (kernels, log_noise)
        rotational) a fit starts from."""
        cfg = self.config
        return (_initial_hyperparameters(cfg, self.trans_buffer, self.trans_extractor.n_features,
                                         cfg.trans_lengthscales, cfg.signal_variance),
                _initial_hyperparameters(cfg, self.rot_buffer, self.rot_extractor.n_features,
                                         cfg.rot_lengthscales, cfg.signal_variance))

    def fit(self, generator: Optional[torch.Generator] = None,
            init_idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> "StructuredRocketGP":
        """Fit both sparse GPs on the stored data. ``generator`` draws the
        translational, then the rotational k-means start; ``init_idx`` (a
        pair) fixes them instead."""
        (kt, _), (kr, _) = self.initial_hyperparameters()
        it, ir = (None, None) if init_idx is None else init_idx
        return replace(
            self,
            trans_gp=_fit_buffer(self.config, self.trans_buffer, kt, generator, it),
            rot_gp=_fit_buffer(self.config, self.rot_buffer, kr, generator, ir),
            is_fitted=True)

    def refit(self) -> "StructuredRocketGP":
        """Refit on the current stores, keeping kernels and inducing points."""
        return replace(self, trans_gp=_refit(self.trans_gp, self.trans_buffer),
                       rot_gp=_refit(self.rot_gp, self.rot_buffer))

    def predict(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var), each (..., 6) = [d_v, d_ω], at states/controls with any
        leading dims."""
        mt, vt = _predict(self.trans_gp, self.trans_extractor.extract(x, u))
        mr, vr = _predict(self.rot_gp, self.rot_extractor.extract(x, u))
        return torch.cat([mt, mr], dim=-1), torch.cat([vt, vr], dim=-1)

    predict_batch = predict

    def prior_variance(self) -> torch.Tensor:
        """(6,) prior variances of the outputs."""
        return torch.exp(torch.cat([self.trans_gp.kernels.log_variance,
                                    self.rot_gp.kernels.log_variance]))

    def predict_gated(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """Variance-gated mean: scaled by w = clip(1 − σ²/σ²_prior, 0, 1) per
        output, so the correction fades to zero where the GP has no data."""
        mean, var = self.predict(x, u)
        w = (1.0 - var / self.prior_variance().clamp_min(1e-12)).clamp(0.0, 1.0)
        return mean * w, var

    @staticmethod
    def lift_residual(residual6: torch.Tensor, n_x: int = 14) -> torch.Tensor:
        """[d_v, d_ω] (..., 6) → full-state residual (..., n_x): d_v into the
        velocity slice [4:7], d_ω into the rate slice [11:14]."""
        z = lambda k: residual6.new_zeros(*residual6.shape[:-1], k)
        if n_x < 14:
            return torch.cat([z(4), residual6[..., :3], z(n_x - 7)], dim=-1)
        return torch.cat([z(4), residual6[..., :3], z(4), residual6[..., 3:6], z(n_x - 14)],
                         dim=-1)


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

    def initial_hyperparameters(self):
        """(kernels, log_noise) a fit starts from: data-driven ARD
        lengthscales on the buffered features and the configured noise."""
        return _initial_hyperparameters(self.config, self.buffer, self.extractor.n_features)

    def fit(self, generator: Optional[torch.Generator] = None,
            init_idx: Optional[torch.Tensor] = None) -> "Simple3DoFGP":
        """Fit the sparse GP on the buffered data. ``generator`` draws the
        k-means start (``init_idx`` fixes it instead)."""
        kernels, _ = self.initial_hyperparameters()
        return replace(self, gp=_fit_buffer(self.config, self.buffer, kernels, generator,
                                            init_idx), is_fitted=True)

    def predict(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var), each (..., 3), at states/controls with any leading
        dims."""
        return _predict(self.gp, self.extractor.extract(x, u))

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
