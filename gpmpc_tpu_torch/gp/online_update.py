"""Online GP updating (counterpart of ``gpmpc_tpu/gp/online_update.py``):
the novelty-gated data buffer, the update cadence and residual collection.

Every piece is one store or one per lane: created with ``lanes=B``, the
buffer's tensors and the updater's counters carry the lane axis B first and
each lane observes its own point ``x`` (B, d) (the JAX package ``vmap``s one
updater per lane)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .structured_gp import min_distance_to, ring_write


@dataclass(frozen=True)
class OnlineUpdateConfig:
    """Field names and defaults are those of the JAX ``OnlineUpdateConfig``."""

    capacity: int = 512
    update_interval: int = 10
    refit_interval: int = 100
    min_distance: float = 1e-3
    novelty_threshold: float = 0.0  # 0: accept all (the distance gate still applies)


@dataclass
class DataBuffer:
    """Masked ring buffer with min-distance admission."""

    X: torch.Tensor  # ([B,] cap, d)
    Y: torch.Tensor  # ([B,] cap, n_out)
    head: torch.Tensor  # ([B,])
    count: torch.Tensor  # ([B,])
    n_rejected: torch.Tensor  # ([B,])

    @classmethod
    def create(cls, capacity: int, d: int, n_out: int, device: DeviceLike = "cuda",
               lanes: Optional[int] = None) -> "DataBuffer":
        dev = resolve_device(device)
        lead = () if lanes is None else (lanes,)
        zero = lambda: torch.zeros(lead, dtype=torch.int32, device=dev)
        return cls(X=torch.zeros(*lead, capacity, d, device=dev),
                   Y=torch.zeros(*lead, capacity, n_out, device=dev),
                   head=zero(), count=zero(), n_rejected=zero())

    @property
    def capacity(self) -> int:
        return self.X.shape[-2]

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.X.device) < self.count[..., None]

    def min_distance_to(self, x) -> torch.Tensor:
        return min_distance_to(self.X, self.mask, x)

    def add(self, x, y, accept=None) -> "DataBuffer":
        """Insert where ``accept`` holds (everywhere if None); a rejected
        point moves neither head nor count and counts as rejected."""
        ok = torch.ones_like(self.count, dtype=torch.bool) if accept is None else accept
        X, Y, head, count = ring_write(self.X, self.Y, self.head, self.count, x, y, ok)
        return replace(self, X=X, Y=Y, head=head, count=count,
                       n_rejected=self.n_rejected + (~ok).to(torch.int32))

    def add_if_novel(self, x, y, min_distance) -> "DataBuffer":
        return self.add(x, y, self.min_distance_to(x) > min_distance)

    def get_statistics(self) -> dict:
        return {
            "count": self.count,
            "capacity": self.capacity,
            "n_rejected": self.n_rejected,
            "fill_fraction": self.count / self.capacity,
        }


@dataclass
class OnlineGPUpdater:
    """Cadence state machine: every observation goes through the novelty gate
    into the buffer; every ``update_interval`` accepted points raise the
    factor-update flag, every ``refit_interval`` the full-refit flag."""

    config: OnlineUpdateConfig
    buffer: DataBuffer
    n_since_update: torch.Tensor  # ([B,])
    n_since_refit: torch.Tensor
    n_updates: torch.Tensor

    @classmethod
    def create(cls, config: OnlineUpdateConfig, d: int, n_out: int,
               device: DeviceLike = "cuda", lanes: Optional[int] = None) -> "OnlineGPUpdater":
        buf = DataBuffer.create(config.capacity, d, n_out, device=device, lanes=lanes)
        zero = lambda: torch.zeros_like(buf.count)
        return cls(config=config, buffer=buf, n_since_update=zero(), n_since_refit=zero(),
                   n_updates=zero())

    def observe(self, x, y) -> Tuple["OnlineGPUpdater", torch.Tensor, torch.Tensor]:
        """Returns (new state, do_update, do_refit), the flags ([B,]) of this
        step. A point admitted into a full buffer does not count as accepted
        (the count does not grow), as in the JAX package."""
        buf = self.buffer.add_if_novel(x, y, self.config.min_distance)
        accepted = (buf.count > self.buffer.count).to(torch.int32)
        n_u = self.n_since_update + accepted
        n_r = self.n_since_refit + accepted
        do_update = n_u >= self.config.update_interval
        do_refit = n_r >= self.config.refit_interval
        new = replace(
            self, buffer=buf,
            n_since_update=torch.where(do_update, torch.zeros_like(n_u), n_u),
            n_since_refit=torch.where(do_refit, torch.zeros_like(n_r), n_r),
            n_updates=self.n_updates + do_update.to(torch.int32),
        )
        return new, do_update, do_refit


# the structured (six-output) variant of the reference is the same machine
OnlineStructuredGPUpdater = OnlineGPUpdater


@dataclass(frozen=True)
class ResidualCollector:
    """d = (x_actual − f_nom(x, u)) / dt on the learned slices (velocity
    [4:7] and, for 14-state, rate [11:14])."""

    dt: float = 0.1

    def residual(self, step_fn: Callable, x, u, x_actual) -> torch.Tensor:
        """Residuals of transitions with any leading dims."""
        err = (x_actual - step_fn(x, u)) / self.dt
        if x.shape[-1] >= 14:
            return torch.cat([err[..., 4:7], err[..., 11:14]], dim=-1)
        return err[..., 4:7]

    def collect_batch(self, step_fn: Callable, X, U, X_next) -> torch.Tensor:
        """Residuals of a batch of transitions (any leading dims)."""
        return self.residual(step_fn, X, U, X_next)
