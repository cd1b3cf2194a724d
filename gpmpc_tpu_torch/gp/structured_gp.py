"""Structured residual GPs (counterpart of ``gpmpc_tpu/gp/structured_gp.py``):

- :class:`StructuredRocketGP`, the 6-DoF model: separate three-output sparse
  GPs for the translational (d_v) and rotational (d_ω) acceleration
  residuals, on the 13-dim translational and 12-dim rotational features;
- :class:`Simple3DoFGP`, the 3-DoF model: one three-output sparse GP on the
  11-dim 3-DoF features, learning the velocity residual;

each with fixed-capacity FIFO data stores, the novelty-gated one-point
insert of the online loop, the masked batch insert, the novelty test and
``.npz`` persistence.

A GP is one model, or one per lane (``create(..., lanes=B)``, or
:func:`broadcast_lanes` of one model): then every tensor of its stores and
of its sparse GPs carries the lane axis B first, ``fit`` runs one k-means and
one fit per lane in a batch, and ``predict`` treats dim 0 of its inputs as
that axis (the JAX package ``vmap``s one GP per lane)."""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..utils.profiler import span
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
    novelty_threshold: float = 0.3  # var > τ·prior_var ⇒ novel
    # fixed ARD lengthscale inits per feature group (tuples); None: data-driven
    trans_lengthscales: Optional[tuple] = None
    rot_lengthscales: Optional[tuple] = None
    signal_variance: float = 1.0


def ring_write(X, Y, head, count, x, y, ok=None):
    """Write (x, y) at ``head`` of a ring store, where ``ok`` (if given):
    X ([B,] cap, d), Y ([B,] cap, n_out), head and count ([B,]), x ([B,] d),
    y ([B,] n_out), ok ([B,]) bool. A one-hot row select, as in the JAX
    package; a rejected point moves neither head nor count. Returns (X, Y,
    head, count)."""
    cap = X.shape[-2]
    sel = torch.arange(cap, device=X.device) == head[..., None]
    new_head = ((head + 1) % cap).to(torch.int32)
    new_count = torch.clamp(count + 1, max=cap).to(torch.int32)
    if ok is not None:
        sel = sel & ok[..., None]
        new_head = torch.where(ok, new_head, head)
        new_count = torch.where(ok, new_count, count)
    sel = sel[..., None]
    return (torch.where(sel, x[..., None, :], X), torch.where(sel, y[..., None, :], Y),
            new_head, new_count)


def min_distance_to(X, mask, x) -> torch.Tensor:
    """([B,]) Euclidean distance from x ([B,] d) to the nearest stored row
    (inf for an empty store)."""
    d2 = ((X - x[..., None, :]) ** 2).sum(-1)
    return torch.sqrt(torch.where(mask, d2, torch.full_like(d2, float("inf"))).amin(-1))


@dataclass
class RingBuffer:
    """Fixed-capacity FIFO feature/target store, one or one per lane."""

    X: torch.Tensor  # ([B,] cap, d)
    Y: torch.Tensor  # ([B,] cap, n_out)
    head: torch.Tensor  # ([B,]) next write slot
    count: torch.Tensor  # ([B,]) active rows (≤ cap)

    @classmethod
    def create(cls, capacity: int, d: int, n_out: int, device: DeviceLike = "cuda",
               lanes: Optional[int] = None) -> "RingBuffer":
        dev = resolve_device(device)
        lead = () if lanes is None else (lanes,)
        return cls(
            X=torch.zeros(*lead, capacity, d, device=dev),
            Y=torch.zeros(*lead, capacity, n_out, device=dev),
            head=torch.zeros(lead, dtype=torch.int32, device=dev),
            count=torch.zeros(lead, dtype=torch.int32, device=dev),
        )

    @property
    def capacity(self) -> int:
        return self.X.shape[-2]

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.X.device) < self.count[..., None]

    def add(self, x, y) -> "RingBuffer":
        """Insert one point (a row per lane)."""
        X, Y, head, count = ring_write(self.X, self.Y, self.head, self.count, x, y)
        return replace(self, X=X, Y=Y, head=head, count=count)

    def add_if_novel(self, x, y, min_distance, accept=None) -> Tuple["RingBuffer", torch.Tensor]:
        """Novelty-gated insert, the per-cycle observe of the online loop: a
        point enters only where its distance to every stored row exceeds
        ``min_distance`` (and ``accept``, if given). Returns (buffer, ok)."""
        ok = min_distance_to(self.X, self.mask, x) > min_distance
        if accept is not None:
            ok = ok & accept
        X, Y, head, count = ring_write(self.X, self.Y, self.head, self.count, x, y, ok)
        return replace(self, X=X, Y=Y, head=head, count=count), ok

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

    def add_batch_masked(self, Xb, Yb, valid) -> "RingBuffer":
        """Admit the rows of Xb ([B,] k, d), Yb ([B,] k, n_out) where ``valid``
        ([B,] k) holds, in their order: the store ends as after a sequential
        ``add`` of the valid rows (a later row wins a slot it shares with an
        earlier one)."""
        cap, k = self.capacity, Xb.shape[-2]
        dev = Xb.device
        n = valid.to(torch.int32).sum(-1)
        pos = (self.head[..., None] + torch.cumsum(valid.to(torch.int64), -1) - 1) % cap
        hit = (pos[..., :, None] == torch.arange(cap, device=dev)) & valid[..., :, None]
        # the last valid row that lands on each slot, 1-based (0: none)
        row = torch.where(hit, torch.arange(1, k + 1, device=dev)[:, None], 0).amax(-2)
        take = (row > 0)[..., None]
        src = (row - 1).clamp_min(0)[..., None]
        return replace(
            self,
            X=torch.where(take, torch.take_along_dim(Xb, src, dim=-2), self.X),
            Y=torch.where(take, torch.take_along_dim(Yb, src, dim=-2), self.Y),
            head=((self.head + n) % cap).to(torch.int32),
            count=torch.clamp(self.count + n, max=cap).to(torch.int32),
        )


def _stacked_kernels(name: str, d: int, n_out: int, lengthscales=None,
                     variance: float = 1.0, device: DeviceLike = "cuda"):
    """Stack n_out kernels; ARD lengthscales default to 1 or to the given
    data-driven scale (see :func:`_data_lengthscales`): (d,), or ([B,] d)
    for one stack per lane."""
    k = stack_kernels([create_kernel(name, d, variance=variance, device=device)
                       for _ in range(n_out)])
    if lengthscales is not None and hasattr(k, "log_lengthscales"):
        lead = lengthscales.shape[:-1]
        k.log_lengthscales = torch.log(lengthscales)[..., None, :].expand(
            *lead, n_out, d).contiguous()
        k.log_variance = k.log_variance.expand(*lead, n_out).contiguous()
    return k


def _data_lengthscales(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ARD lengthscale init ∝ per-dimension std of the active data, scaled by
    √d and floored at 0.1 (see the JAX package for the rationale). X is
    (..., cap, d), mask (..., cap); returns (..., d)."""
    mf = mask.to(X.dtype)[..., None]
    n = mf.sum(-2).clamp_min(1.0)
    mu = (X * mf).sum(-2) / n
    var = (((X - mu[..., None, :]) ** 2) * mf).sum(-2) / n
    d = X.shape[-1]
    return (torch.sqrt(var) * math.sqrt(float(d))).clamp_min(0.1)


def _initial_hyperparameters(cfg: StructuredGPConfig, buf: RingBuffer, d: int,
                             fixed_ls=None, variance: float = 1.0):
    """(kernels, log_noise) a three-output fit on ``buf`` starts from: the
    fixed or data-driven ARD lengthscales and the configured noise."""
    dev, lead = buf.X.device, buf.X.shape[:-2]
    ls = (torch.as_tensor(fixed_ls, dtype=torch.float32, device=dev).expand(*lead, d)
          if fixed_ls is not None else _data_lengthscales(buf.X, buf.mask))
    kernels = _stacked_kernels(cfg.kernel, d, 3, ls, variance=variance, device=dev)
    return kernels, torch.full((*lead, 3), math.log(cfg.noise), device=dev)


def _fit_buffer(cfg: StructuredGPConfig, buf: RingBuffer, kernels, generator, init_idx
                ) -> MultiOutputSparseGPState:
    Z = init_inducing_points(buf.X, min(cfg.n_inducing, buf.capacity), mask=buf.mask,
                             generator=generator, init_idx=init_idx)
    return fit_sparse_multi(kernels, buf.X, buf.Y, Z, noise=cfg.noise, mask=buf.mask,
                            method=cfg.method)


def _refit(g: MultiOutputSparseGPState, buf: RingBuffer) -> MultiOutputSparseGPState:
    return refit_sparse_multi(g.kernels, g.Z, buf.X, buf.Y.transpose(-1, -2).contiguous(),
                              buf.mask, g.log_noise, g.method)


def _predict(g: MultiOutputSparseGPState, F: torch.Tensor):
    """(mean, var), each (..., n_out), at features F (..., d). A GP per lane
    takes dim 0 of F as its lane axis."""
    lead, d = F.shape[:-1], F.shape[-1]
    if g.Z.dim() == 2:
        pr = predict_sparse_multi(g, F.reshape(-1, d))
    else:
        lanes = g.Z.shape[0]
        if F.dim() < 2 or F.shape[0] != lanes:
            raise ValueError(f"the GP holds {lanes} lanes, but dim 0 of the query is "
                             f"{tuple(F.shape[:1])}")
        pr = predict_sparse_multi(g, F.reshape(lanes, -1, d))
    n_out = pr.mean.shape[-1]
    return pr.mean.reshape(*lead, n_out), pr.variance.reshape(*lead, n_out)


def _per_query(prior, var):
    """Prior variances ([B,] n_out) shaped against posterior variances
    ([B,] ..., n_out)."""
    if prior.dim() > 1:
        prior = prior.reshape(prior.shape[0], *([1] * (var.dim() - 2)), prior.shape[-1])
    return prior


def _gate(mean, var, prior):
    """Variance-gated mean: scaled by w = clip(1 − σ²/σ²_prior, 0, 1) per
    output, so the correction fades to zero where the GP has no data."""
    w = (1.0 - var / _per_query(prior, var).clamp_min(1e-12)).clamp(0.0, 1.0)
    return mean * w, var


def _lanes(buf: RingBuffer) -> Optional[int]:
    return buf.X.shape[0] if buf.X.dim() == 3 else None


def broadcast_lanes(obj, lanes: int):
    """A copy of a GP (or any dataclass tree of tensors) with every tensor
    repeated along a new leading lane axis of size ``lanes``: B identical
    per-lane GPs, as ``jnp.broadcast_to`` gives the JAX package's ``vmap``."""
    kw = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.expand(lanes, *v.shape).contiguous()
        elif is_dataclass(v) and any(True for _ in _tensors(v)):
            kw[f.name] = broadcast_lanes(v, lanes)
    return replace(obj, **kw)


def _tensors(obj, prefix: str = ""):
    """(dotted name, tensor) of every tensor in a dataclass tree."""
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif is_dataclass(v):
            yield from _tensors(v, prefix + f.name + ".")


def _with_tensors(obj, data, prefix: str = ""):
    """``obj`` with every tensor replaced by ``data``'s array of its dotted
    name, on the tensor's device."""
    kw = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = torch.as_tensor(data[prefix + f.name], device=v.device)
        elif is_dataclass(v) and any(True for _ in _tensors(v)):
            kw[f.name] = _with_tensors(v, data, prefix + f.name + ".")
    return replace(obj, **kw)


class _Persistent:
    """``.npz`` persistence of a GP: every tensor under its dotted name
    (``buffer.X``, ``gp.kernels.log_variance``, …)."""

    def save(self, path: str) -> None:
        np.savez(path, **{k: v.detach().cpu().numpy() for k, v in _tensors(self)})

    def load(self, path: str):
        """This GP with every tensor read back from ``path``; the instance
        gives the structure (fitted or not, lanes) and the device."""
        with np.load(path) as data:
            return _with_tensors(self, data)


@dataclass
class StructuredRocketGP(_Persistent):
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
               device: DeviceLike = "cuda", lanes: Optional[int] = None) -> "StructuredRocketGP":
        """An unfitted model, or one per lane with ``lanes``."""
        cfg = config or StructuredGPConfig()
        te, re = TranslationalFeatureExtractor(), RotationalFeatureExtractor()
        buf = lambda d: RingBuffer.create(cfg.max_data_points, d, 3, device=device, lanes=lanes)
        return cls(config=cfg, trans_extractor=te, rot_extractor=re,
                   trans_buffer=buf(te.n_features), rot_buffer=buf(re.n_features))

    @property
    def device(self) -> torch.device:
        return self.trans_buffer.X.device

    @property
    def lanes(self) -> Optional[int]:
        """The lane count of a GP per lane, else None."""
        return _lanes(self.trans_buffer)

    @property
    def buffer_count(self) -> torch.Tensor:
        """Stored-point count ([B,]; both stores fill in lockstep)."""
        return self.trans_buffer.count

    def add_data(self, x, u, residual) -> "StructuredRocketGP":
        """Store one transition (a row per lane); ``residual`` is [d_v, d_ω]."""
        return replace(
            self,
            trans_buffer=self.trans_buffer.add(self.trans_extractor.extract(x, u),
                                               residual[..., :3]),
            rot_buffer=self.rot_buffer.add(self.rot_extractor.extract(x, u), residual[..., 3:6]))

    def add_data_batch(self, X, U, residuals) -> "StructuredRocketGP":
        """Store a batch of transitions; ``residuals`` is (n, 6) = [d_v, d_ω]."""
        return replace(
            self,
            trans_buffer=self.trans_buffer.add_batch(self.trans_extractor.extract(X, U),
                                                     residuals[:, :3]),
            rot_buffer=self.rot_buffer.add_batch(self.rot_extractor.extract(X, U),
                                                 residuals[:, 3:6]))

    def add_data_batch_masked(self, X, U, residuals, valid) -> "StructuredRocketGP":
        """Store the transitions where ``valid`` holds, in order, in both
        stores (see :meth:`RingBuffer.add_batch_masked`)."""
        return replace(
            self,
            trans_buffer=self.trans_buffer.add_batch_masked(
                self.trans_extractor.extract(X, U), residuals[..., :3], valid),
            rot_buffer=self.rot_buffer.add_batch_masked(
                self.rot_extractor.extract(X, U), residuals[..., 3:6], valid))

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
        pair, each ([B,] n_inducing)) fixes them instead."""
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

    def _posterior(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) in the sub-GPs' own precision. The spans name each
        sub-GP's features and posterior in a profiler trace."""
        with span("gpmpc.gp_trans"):
            mt, vt = _predict(self.trans_gp, self.trans_extractor.extract(x, u))
        with span("gpmpc.gp_rot"):
            mr, vr = _predict(self.rot_gp, self.rot_extractor.extract(x, u))
        return torch.cat([mt, mr], dim=-1), torch.cat([vt, vr], dim=-1)

    def predict(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var), each (..., 6) = [d_v, d_ω], at states/controls with any
        leading dims (the first the lane axis of a GP per lane), in the
        states' dtype; sub-GPs held in float64 compute in float64."""
        mean, var = self._posterior(x, u)
        return mean.to(x.dtype), var.to(x.dtype)

    predict_batch = predict

    def prior_variance(self) -> torch.Tensor:
        """([B,] 6) prior variances of the outputs."""
        return torch.exp(torch.cat([self.trans_gp.kernels.log_variance,
                                    self.rot_gp.kernels.log_variance], dim=-1))

    def predict_gated(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """Variance-gated mean: scaled by w = clip(1 − σ²/σ²_prior, 0, 1) per
        output, so the correction fades to zero where the GP has no data."""
        mean, var = _gate(*self._posterior(x, u), self.prior_variance())
        return mean.to(x.dtype), var.to(x.dtype)

    def is_novel(self, x, u) -> torch.Tensor:
        """(...) bool: some output's posterior variance exceeds
        ``novelty_threshold`` times its prior variance."""
        _, var = self.predict(x, u)
        prior = _per_query(self.prior_variance(), var)
        return (var > self.config.novelty_threshold * prior).any(-1)

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
class Simple3DoFGP(_Persistent):
    """Three-output velocity-residual GP on 11-dim features."""

    config: StructuredGPConfig
    extractor: Simple3DoFFeatureExtractor
    buffer: RingBuffer
    gp: Optional[MultiOutputSparseGPState] = None
    is_fitted: bool = False

    @classmethod
    def create(cls, config: Optional[StructuredGPConfig] = None,
               device: DeviceLike = "cuda", lanes: Optional[int] = None) -> "Simple3DoFGP":
        """An unfitted model, or one per lane with ``lanes``."""
        cfg = config or StructuredGPConfig()
        ex = Simple3DoFFeatureExtractor()
        return cls(config=cfg, extractor=ex,
                   buffer=RingBuffer.create(cfg.max_data_points, ex.n_features,
                                            3, device=device, lanes=lanes))

    @property
    def device(self) -> torch.device:
        return self.buffer.X.device

    @property
    def lanes(self) -> Optional[int]:
        """The lane count of a GP per lane, else None."""
        return _lanes(self.buffer)

    @property
    def buffer_count(self) -> torch.Tensor:
        return self.buffer.count

    def add_data(self, x, u, residual3) -> "Simple3DoFGP":
        """Store one transition (a row per lane)."""
        return replace(self, buffer=self.buffer.add(self.extractor.extract(x, u), residual3))

    def add_data_batch(self, X, U, R) -> "Simple3DoFGP":
        return replace(self, buffer=self.buffer.add_batch(
            self.extractor.extract(X, U), R))

    def add_data_batch_masked(self, X, U, R, valid) -> "Simple3DoFGP":
        """Store the transitions where ``valid`` holds, in order."""
        return replace(self, buffer=self.buffer.add_batch_masked(
            self.extractor.extract(X, U), R, valid))

    def initial_hyperparameters(self):
        """(kernels, log_noise) a fit starts from: data-driven ARD
        lengthscales on the buffered features and the configured noise."""
        return _initial_hyperparameters(self.config, self.buffer, self.extractor.n_features)

    def fit(self, generator: Optional[torch.Generator] = None,
            init_idx: Optional[torch.Tensor] = None) -> "Simple3DoFGP":
        """Fit the sparse GP on the buffered data. ``generator`` draws the
        k-means start (``init_idx`` ([B,] n_inducing) fixes it instead)."""
        kernels, _ = self.initial_hyperparameters()
        return replace(self, gp=_fit_buffer(self.config, self.buffer, kernels, generator,
                                            init_idx), is_fitted=True)

    def refit(self) -> "Simple3DoFGP":
        """Refit on the current store, keeping kernels and inducing points."""
        return replace(self, gp=_refit(self.gp, self.buffer))

    def predict(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var), each (..., 3), at states/controls with any leading
        dims (the first the lane axis of a GP per lane)."""
        return _predict(self.gp, self.extractor.extract(x, u))

    def predict_gated(self, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
        """Variance-gated mean: scaled by w = clip(1 − σ²/σ²_prior, 0, 1) per
        output, so the correction fades to zero where the GP has no data."""
        return _gate(*self.predict(x, u), torch.exp(self.gp.kernels.log_variance))

    @staticmethod
    def lift_residual(residual3: torch.Tensor, n_x: int = 7) -> torch.Tensor:
        """Velocity residual (..., 3) → full-state residual (..., n_x)."""
        lead = residual3.shape[:-1]
        zeros = residual3.new_zeros(*lead, 4)
        out = torch.cat([zeros, residual3], dim=-1)
        if n_x > 7:
            out = torch.cat([out, residual3.new_zeros(*lead, n_x - 7)], dim=-1)
        return out
