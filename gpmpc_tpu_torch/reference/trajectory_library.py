"""Reference trajectory container and library (counterpart of
``gpmpc_tpu/reference/trajectory_library.py``): ``Trajectory`` with time
interpolation and resampling, a fixed-capacity library of same-length
trajectories in stacked tensors (add, get, nearest-by-initial-state,
best-within-radius by cost or fuel, statistics, ``.npz`` persistence that
the JAX package reads and writes alike), and bulk seeding from a batched
solver such as :func:`~gpmpc_tpu_torch.reference.scvx.scvx_free_time`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..utils.profiler import span

Tensor = torch.Tensor


class TrajectoryMetadata(NamedTuple):
    cost: Tensor
    fuel_used: Tensor
    duration: Tensor
    converged: Tensor


def _interval(times: Tensor, t: Tensor, last: int) -> Tensor:
    """Index of the interval holding each t (searchsorted right, minus one),
    clipped to [0, last]."""
    idx = torch.searchsorted(times, t.contiguous(), right=True) - 1
    return idx.clamp(0, last)


@dataclass(frozen=True)
class Trajectory:
    """Time-indexed state/control trajectory with interpolation."""

    times: Tensor  # (T+1,)
    X: Tensor  # (T+1, n_x)
    U: Tensor  # (T, n_u)

    @property
    def duration(self) -> Tensor:
        return self.times[-1]

    def state_at(self, t) -> Tensor:
        """Linear interpolation in time; t a number or (K,) → (n_x,) or
        (K, n_x)."""
        t = torch.as_tensor(t, dtype=self.times.dtype, device=self.times.device)
        t = t.clamp(self.times[0], self.times[-1])
        idx = _interval(self.times, t.reshape(-1), self.times.shape[0] - 2)
        t0, t1 = self.times[idx], self.times[idx + 1]
        w = ((t.reshape(-1) - t0) / (t1 - t0).clamp_min(1e-9))[:, None]
        out = (1 - w) * self.X[idx] + w * self.X[idx + 1]
        return out.reshape(*t.shape, -1)

    def control_at(self, t) -> Tensor:
        """Zero-order-hold control lookup."""
        t = torch.as_tensor(t, dtype=self.times.dtype, device=self.times.device)
        t = t.clamp(self.times[0], self.times[-1])
        idx = _interval(self.times, t.reshape(-1), self.U.shape[0] - 1)
        return self.U[idx].reshape(*t.shape, -1)

    def resample(self, n: int) -> "Trajectory":
        """Uniform-time resampling to n intervals."""
        ts = torch.linspace(float(self.times[0]), float(self.times[-1]), n + 1,
                            device=self.times.device)
        return Trajectory(times=ts, X=self.state_at(ts), U=self.control_at(ts[:-1]))


@dataclass(frozen=True)
class TrajectoryLibrary:
    """Fixed-capacity stacked store of same-length trajectories."""

    times: Tensor  # (cap, T+1)
    X: Tensor  # (cap, T+1, n_x)
    U: Tensor  # (cap, T, n_u)
    cost: Tensor  # (cap,)
    fuel: Tensor  # (cap,)
    active: Tensor  # (cap,) bool
    count: Tensor  # () int32

    @classmethod
    def create(cls, capacity: int, T: int, n_x: int, n_u: int,
               device: DeviceLike = "cuda") -> "TrajectoryLibrary":
        dev = resolve_device(device)
        return cls(
            times=torch.zeros(capacity, T + 1, device=dev),
            X=torch.zeros(capacity, T + 1, n_x, device=dev),
            U=torch.zeros(capacity, T, n_u, device=dev),
            cost=torch.full((capacity,), torch.inf, device=dev),
            fuel=torch.full((capacity,), torch.inf, device=dev),
            active=torch.zeros(capacity, dtype=torch.bool, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @property
    def capacity(self) -> int:
        return self.X.shape[0]

    def replace(self, **kw) -> "TrajectoryLibrary":
        return replace(self, **kw)

    def add(self, traj: Trajectory, cost, fuel) -> "TrajectoryLibrary":
        """A library with ``traj`` written at slot count mod capacity."""
        sel = torch.arange(self.capacity, device=self.X.device) == self.count % self.capacity
        put = lambda old, new: torch.where(sel.reshape(-1, *([1] * (old.dim() - 1))),
                                           torch.as_tensor(new).to(old), old)
        return self.replace(times=put(self.times, traj.times), X=put(self.X, traj.X),
                            U=put(self.U, traj.U), cost=put(self.cost, cost),
                            fuel=put(self.fuel, fuel), active=self.active | sel,
                            count=self.count + 1)

    def get(self, i) -> Trajectory:
        return Trajectory(times=self.times[i], X=self.X[i], U=self.U[i])

    def _d2(self, x0: Tensor, weights: Optional[Tensor]) -> Tensor:
        """(…, cap) weighted squared distances of x0 (…, n_x) to the initial
        states."""
        w = torch.ones_like(x0) if weights is None else weights
        return (((self.X[:, 0, :] - x0[..., None, :]) ** 2) * w[..., None, :]).sum(-1)

    def _nearest(self, d2: Tensor) -> Tensor:
        return torch.where(self.active, d2, torch.inf).argmin(dim=-1)

    def nearest(self, x0: Tensor, weights: Optional[Tensor] = None) -> Tensor:
        """Index of the active trajectory whose initial state is nearest x0
        ((n_x,) or a batch (B, n_x))."""
        with span("scvx.library_query"):
            return self._nearest(self._d2(x0, weights))

    def best_within_radius(self, x0: Tensor, radius, by: str = "cost",
                           weights: Optional[Tensor] = None) -> Tensor:
        """Lowest-cost (or -fuel) active trajectory whose initial state lies
        within ``radius`` of x0; the nearest one where none does."""
        with span("scvx.library_query"):
            d2 = self._d2(x0, weights)
            inside = self.active & (d2 <= torch.as_tensor(radius).to(d2)[..., None] ** 2)
            metric = self.cost if by == "cost" else self.fuel
            idx = torch.where(inside, metric, torch.inf).argmin(dim=-1)
            return torch.where(inside.any(dim=-1), idx, self._nearest(d2))

    def get_statistics(self) -> dict:
        af = self.active.to(torch.float32)
        n = af.sum().clamp_min(1.0)
        return {
            "n_trajectories": self.active.sum(),
            "capacity": self.capacity,
            "mean_cost": torch.where(self.active, self.cost, 0.0).sum() / n,
            "mean_fuel": torch.where(self.active, self.fuel, 0.0).sum() / n,
            "best_cost": torch.where(self.active, self.cost, torch.inf).min(),
        }

    def save(self, path: str) -> None:
        """``.npz`` with one array a field, in the JAX package's order
        (arr_0 … arr_6), which the JAX package's ``load`` reads."""
        np.savez(path, *[getattr(self, f.name).detach().cpu().numpy() for f in fields(self)])

    def load(self, path: str) -> "TrajectoryLibrary":
        """The library of a ``.npz`` written by either package, on this
        library's device."""
        data = np.load(path)
        dev = self.X.device
        return TrajectoryLibrary(*[torch.as_tensor(data[k]).to(dev) for k in data.files])


def generate_trajectory_library(solver_fn: Callable[[Tensor], tuple], x0s: Tensor,
                                capacity: Optional[int] = None, dt: float = 0.1
                                ) -> TrajectoryLibrary:
    """Bulk seeding: ``solver_fn(x0s (B, n_x)) → (X (B, T+1, n_x), U (B, T,
    n_u), cost (B,), fuel (B,))``, one batched call (e.g. a closed-over
    :func:`scvx_free_time`). The times are k·dt."""
    X, U, cost, fuel = solver_fn(x0s)
    n, T1 = X.shape[0], X.shape[1]
    cap = capacity or n
    lib = TrajectoryLibrary.create(cap, T1 - 1, X.shape[2], U.shape[2], device=X.device)
    times = lib.times.clone()
    if cap == n:
        times = (torch.arange(T1, device=X.device, dtype=torch.float32) * dt).expand(cap, T1)
    sl = slice(0, n)
    put = lambda old, new: torch.cat([new.to(old), old[n:]]) if cap != n else new.to(old)
    active = lib.active.clone()
    active[sl] = True
    return lib.replace(times=times.contiguous(), X=put(lib.X, X), U=put(lib.U, U),
                       cost=put(lib.cost, cost), fuel=put(lib.fuel, fuel), active=active,
                       count=torch.tensor(n, dtype=torch.int32, device=X.device))
