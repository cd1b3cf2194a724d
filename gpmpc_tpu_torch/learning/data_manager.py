"""Transition recording and residual training-data management (counterpart
of ``gpmpc_tpu/learning/data_manager.py``): residuals d = (x_actual −
F_nom(x, u))/dt on the learned slices, a fixed-capacity masked transition
store with episode ids and success flags, training-set selection by success
and recency, uniform subsampling, ``.npz`` persistence, and a threshold
update trigger."""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def compute_residual(step_fn: Callable, x, u, x_next, dt: float, mode: str = "velocity"
                     ) -> torch.Tensor:
    """d = (x_next − F_nom(x, u))/dt: every state (``"full"``) or the
    velocity slice [4:7], plus the rate slice [11:14] of a 14-state model
    (``"velocity"``; ``"acceleration"`` is the same)."""
    err = (x_next - step_fn(x, u)) / dt
    if mode == "full":
        return err
    if mode in ("velocity", "acceleration"):
        if x.shape[-1] >= 14:
            return torch.cat([err[..., 4:7], err[..., 11:14]], dim=-1)
        return err[..., 4:7]
    raise ValueError(f"unknown residual mode {mode!r}")


@dataclass
class TransitionStore:
    """Flat masked store of transitions (x, u, x_next, residual, episode id,
    success flag); a row is active once written (episode id ≥ 0)."""

    X: torch.Tensor  # (cap, n_x)
    U: torch.Tensor  # (cap, n_u)
    X_next: torch.Tensor  # (cap, n_x)
    R: torch.Tensor  # (cap, n_r)
    episode: torch.Tensor  # (cap,) int32, −1 for an empty row
    success: torch.Tensor  # (cap,) bool, resolved at episode end
    head: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, capacity: int, n_x: int, n_u: int, n_r: int,
               device: DeviceLike = "cuda") -> "TransitionStore":
        dev = resolve_device(device)
        z = lambda *s: torch.zeros(*s, device=dev)
        return cls(X=z(capacity, n_x), U=z(capacity, n_u), X_next=z(capacity, n_x),
                   R=z(capacity, n_r),
                   episode=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
                   success=torch.zeros(capacity, dtype=torch.bool, device=dev),
                   head=torch.zeros((), dtype=torch.int32, device=dev),
                   count=torch.zeros((), dtype=torch.int32, device=dev))

    @property
    def capacity(self) -> int:
        return self.X.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        return self.episode >= 0

    def add(self, x, u, x_next, r, episode_id, record=None) -> "TransitionStore":
        """Write one transition at ``head`` where ``record`` holds (default:
        always); a skipped write moves neither head nor count."""
        dev = self.X.device
        ok = torch.as_tensor(True if record is None else record, device=dev)
        sel = (torch.arange(self.capacity, device=dev) == self.head) & ok
        put = lambda a, v: torch.where(sel.reshape(-1, *([1] * (a.dim() - 1))),
                                       torch.as_tensor(v, dtype=a.dtype, device=dev), a)
        return replace(
            self, X=put(self.X, x), U=put(self.U, u), X_next=put(self.X_next, x_next),
            R=put(self.R, r), episode=put(self.episode, episode_id),
            head=torch.where(ok, (self.head + 1) % self.capacity, self.head).to(torch.int32),
            count=torch.where(ok, torch.clamp(self.count + 1, max=self.capacity),
                              self.count).to(torch.int32))

    def mark_episode(self, episode_id, succeeded) -> "TransitionStore":
        """Resolve the success flag of every transition of an episode."""
        hit = self.episode == episode_id
        return replace(self, success=torch.where(
            hit, torch.as_tensor(succeeded, device=self.X.device), self.success))


@dataclass
class DataManager:
    """Transition intake, residual computation and training-set retrieval."""

    store: TransitionStore
    dt: float = 0.1
    residual_mode: str = "velocity"

    @classmethod
    def create(cls, capacity: int, n_x: int, n_u: int, dt: float = 0.1,
               residual_mode: str = "velocity", device: DeviceLike = "cuda") -> "DataManager":
        n_r = n_x if residual_mode == "full" else (6 if n_x >= 14 else 3)
        return cls(store=TransitionStore.create(capacity, n_x, n_u, n_r, device), dt=dt,
                   residual_mode=residual_mode)

    def add_transition(self, step_fn, x, u, x_next, episode_id, record=None) -> "DataManager":
        r = compute_residual(step_fn, x, u, x_next, self.dt, self.residual_mode)
        return replace(self, store=self.store.add(x, u, x_next, r, episode_id, record))

    def end_episode(self, episode_id, succeeded) -> "DataManager":
        return replace(self, store=self.store.mark_episode(episode_id, succeeded))

    def training_mask(self, success_only: bool = False, recent_episodes: Optional[int] = None,
                      current_episode=None) -> torch.Tensor:
        """Rows to train on: active, of successful episodes if asked, of the
        last ``recent_episodes`` episodes if asked."""
        m = self.store.mask
        if success_only:
            m = m & self.store.success
        if recent_episodes is not None and current_episode is not None:
            m = m & (self.store.episode > current_episode - recent_episodes)
        return m

    def subsample_mask(self, generator: Optional[torch.Generator], m: torch.Tensor,
                       max_points: int, scores: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """A uniform subsample of mask ``m`` down to ``max_points`` rows:
        the rows of the smallest U(0, 1) scores (drawn from ``generator``, or
        given), inactive rows pushed past every active one."""
        if scores is None:
            gdev = m.device if generator is None else generator.device
            scores = torch.rand(m.shape, generator=generator, device=gdev).to(m.device)
        scores = scores + (~m).to(scores.dtype) * 2.0
        thresh = torch.sort(scores).values[min(max_points, m.shape[0]) - 1]
        return m & (scores <= thresh)

    def save(self, path: str) -> None:
        st = self.store
        np.savez(path, **{f.name: getattr(st, f.name).detach().cpu().numpy()
                          for f in fields(st)})

    def load(self, path: str) -> "DataManager":
        """This manager with its store read back from ``path``."""
        st = self.store
        with np.load(path) as data:
            return replace(self, store=replace(st, **{
                f.name: torch.as_tensor(data[f.name], device=getattr(st, f.name).device)
                for f in fields(st)}))


@dataclass
class StreamingDataCollector:
    """Counts accepted transitions and raises ``should_update`` every
    ``threshold`` of them; ``collect`` returns (collector, should_update)."""

    manager: DataManager
    threshold: int = 25
    since_update: int = 0

    def collect(self, step_fn, x, u, x_next, episode_id):
        mgr = self.manager.add_transition(step_fn, x, u, x_next, episode_id)
        n = self.since_update + 1
        should = n >= self.threshold
        return replace(self, manager=mgr, since_update=0 if should else n), should
