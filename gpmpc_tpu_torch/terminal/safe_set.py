"""Sampled safe sets with static-shape device storage (counterpart of
``gpmpc_tpu/terminal/safe_set.py``).

States, cost-to-go values, controls, iteration ids, fuel requirements and
trajectory ids live in preallocated flat tensors with an active mask
(``traj_ids ≥ 0``). A trajectory enters with its backward cost-to-go
Q_k = Σ_{i≥k} l_i into a ring buffer; :meth:`SafeSet.add_trajectories`
inserts a whole fleet's trajectories in lane order in one scatter, giving
the slots, ids and counters that one insert per lane in that order gives.
Pruning (quality, FIFO, voxel diversity) marks rows inactive in place;
:func:`merge_safe_sets` keeps the best rows of several stores.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

Tensor = torch.Tensor

_INT32_MAX = torch.iinfo(torch.int32).max
# leaf order of the JAX package's SafeSet pytree (its .npz files' arr_0..)
_LEAVES = ("states", "q_values", "controls", "iterations", "fuel_required", "traj_ids",
           "head", "count", "n_trajectories", "best_cost", "written", "fuel_margin")


def cost_to_go(stage_costs: Tensor) -> Tensor:
    """Backward recursion Q_k = Σ_{i≥k} l_i along the last axis, as a
    reversed cumulative sum."""
    return stage_costs.flip(-1).cumsum(-1).flip(-1)


@dataclass
class SafeSet:
    """Flat store of (state, Q, control, iteration, fuel_required, traj_id)
    on one device. The scalars ``head``, ``count``, ``n_trajectories``,
    ``written`` (int32) and ``best_cost`` are 0-d tensors beside the rows.

    ``written`` is the monotone total of rows ever written, saturating at
    capacity + 1: ``written ≤ capacity`` iff every written slot lies in the
    prefix [0, written), the condition :func:`trim` needs."""

    states: Tensor  # (cap, n_x)
    q_values: Tensor  # (cap,)
    controls: Tensor  # (cap, n_u)
    iterations: Tensor  # (cap,) int32: the trajectory id that wrote the row
    fuel_required: Tensor  # (cap,)
    traj_ids: Tensor  # (cap,) int32, −1 = inactive
    head: Tensor  # () int32 next write slot
    count: Tensor  # () int32 active rows
    n_trajectories: Tensor  # () int32
    best_cost: Tensor  # () best total trajectory cost seen
    written: Tensor  # () int32
    fuel_margin: float = 0.05

    @classmethod
    def create(cls, capacity: int, n_x: int, n_u: int = 3, fuel_margin: float = 0.05,
               device: DeviceLike = "cuda") -> "SafeSet":
        dev = resolve_device(device)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        return cls(
            states=torch.zeros(capacity, n_x, device=dev),
            q_values=torch.full((capacity,), float("inf"), device=dev),
            controls=torch.zeros(capacity, n_u, device=dev),
            iterations=torch.zeros(capacity, dtype=torch.int32, device=dev),
            fuel_required=torch.zeros(capacity, device=dev),
            traj_ids=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
            head=i32(0), count=i32(0), n_trajectories=i32(0),
            best_cost=torch.tensor(float("inf"), device=dev), written=i32(0),
            fuel_margin=fuel_margin,
        )

    def replace(self, **kw) -> "SafeSet":
        return replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.states.shape[0]

    @property
    def device(self) -> torch.device:
        return self.states.device

    @property
    def mask(self) -> Tensor:
        return self.traj_ids >= 0

    def add_trajectory(self, X: Tensor, U: Tensor, stage_costs: Tensor,
                       valid: Optional[Tensor] = None) -> "SafeSet":
        """Insert one trajectory X (T, n_x), U (T, n_u), stage costs (T,)
        with its cost-to-go; a masked no-op when ``valid`` is False.
        Overwrites the oldest rows ring-buffer style once full."""
        v = None if valid is None else torch.as_tensor(valid, device=self.device).reshape(1)
        return self.add_trajectories(X[None], U[None], stage_costs[None], v)

    def add_trajectories(self, X: Tensor, U: Tensor, stage_costs: Tensor,
                         valid: Optional[Tensor] = None) -> "SafeSet":
        """Insert L trajectories X (L, T, n_x), U (L, T, n_u), stage costs
        (L, T) in lane order, skipping the lanes whose ``valid`` (L,) is
        False: the same slots, trajectory ids and counters as L calls of
        :meth:`add_trajectory` in that order, the ring wrap included (of
        rows written to one slot, the last stays). Reads the number of valid
        lanes on the host."""
        L, T = stage_costs.shape
        cap, dev = self.capacity, self.device
        if valid is None:
            lanes = torch.arange(L, device=dev)
        else:
            lanes = torch.as_tensor(valid, device=dev).reshape(L).nonzero()[:, 0]
        k = int(lanes.numel())
        if k == 0:
            return self
        X, U, c = X[lanes], U[lanes], stage_costs[lanes]
        Q = cost_to_go(c)
        fuel_req = X[:, :, 0] - X[:, -1:, 0] + self.fuel_margin
        tid = (self.n_trajectories + torch.arange(k, dtype=torch.int32, device=dev))
        tid = tid[:, None].expand(k, T).reshape(-1)
        rows = k * T
        slot = (self.head.long() + torch.arange(rows, device=dev)) % cap
        keep = slice(max(rows - cap, 0), rows)  # the last cap rows reach distinct slots
        slot = slot[keep]

        def write(arr, vals):
            out = arr.clone()
            out[slot] = vals.reshape(rows, *arr.shape[1:])[keep].to(arr.dtype)
            return out

        return self.replace(
            states=write(self.states, X), q_values=write(self.q_values, Q),
            controls=write(self.controls, U), iterations=write(self.iterations, tid),
            fuel_required=write(self.fuel_required, fuel_req),
            traj_ids=write(self.traj_ids, tid),
            head=((self.head + rows) % cap).to(torch.int32),
            count=torch.clamp(self.count + rows, max=cap).to(torch.int32),
            n_trajectories=(self.n_trajectories + k).to(torch.int32),
            best_cost=torch.minimum(self.best_cost, Q[:, 0].min()),
            written=torch.clamp(self.written + rows, max=cap + 1).to(torch.int32),
        )

    # -- queries -------------------------------------------------------------

    def feasible_mask(self, fuel_available=None) -> Tensor:
        """Active ∧ (fuel_required ≤ fuel_available): (cap,) for a scalar
        budget, (B, cap) for one budget per lane (B,)."""
        m = self.mask
        if fuel_available is None:
            return m
        fa = torch.as_tensor(fuel_available, dtype=self.fuel_required.dtype, device=self.device)
        if fa.dim() == 0:
            return m & (self.fuel_required <= fa)
        return m[None] & (self.fuel_required[None] <= fa[:, None])

    def any_feasible(self, fuel_available) -> Tensor:
        """Whether :meth:`feasible_mask` has an active row, per budget
        (``fuel_available`` scalar or (B,)), without the (B, cap) mask: the
        least fuel requirement among active rows against each budget."""
        least = torch.where(self.mask, self.fuel_required,
                            torch.full_like(self.fuel_required, float("inf"))).min()
        fa = torch.as_tensor(fuel_available, dtype=least.dtype, device=self.device)
        return least <= fa

    def states_from_iteration(self, it) -> Tensor:
        """Mask of the active rows written by trajectory/iteration ``it``."""
        return self.mask & (self.iterations == it)

    def get_statistics(self) -> dict:
        m = self.mask
        denom = m.float().sum().clamp_min(1.0)
        return {
            "n_states": self.count,
            "n_trajectories": self.n_trajectories,
            "capacity": self.capacity,
            "best_cost": self.best_cost,
            "mean_q": torch.where(m, self.q_values, torch.zeros_like(self.q_values)).sum() / denom,
            "fill_fraction": self.count / self.capacity,
        }

    # -- persistence: the JAX package's .npz layout ----------------------------

    def save(self, path: str) -> None:
        """``np.savez`` of the leaves in the JAX pytree's order (arr_0 …
        arr_11), so either package loads the other's file."""
        leaves = [getattr(self, k) for k in _LEAVES]
        np.savez(path, *[v.detach().cpu().numpy() if isinstance(v, Tensor) else np.asarray(v)
                         for v in leaves])

    def load(self, path: str) -> "SafeSet":
        """A store from a file written by :meth:`save` (or by the JAX
        package's ``SafeSet.save``), on this store's device."""
        data = np.load(path)
        vals = [data[k] for k in data.files]
        return safe_set_from_leaves(vals, self.device)


def safe_set_from_leaves(leaves, device: DeviceLike = "cuda") -> SafeSet:
    """A :class:`SafeSet` from its 12 leaves in the JAX pytree's order."""
    dev = resolve_device(device)
    kw = {}
    for name, v in zip(_LEAVES, leaves):
        a = np.asarray(v)
        if name == "fuel_margin":
            kw[name] = float(a)
        elif name in ("iterations", "traj_ids", "head", "count", "n_trajectories", "written"):
            kw[name] = torch.as_tensor(a.astype(np.int32), device=dev)
        else:
            kw[name] = torch.as_tensor(a.astype(np.float32), device=dev)
    return SafeSet(**kw)


_ROWS = ("states", "q_values", "controls", "iterations", "fuel_required", "traj_ids")


def trim(ss: SafeSet, size: int) -> SafeSet:
    """Prefix view of the leading ``size`` slots, the frozen-set KNN bucket.
    Valid whenever ``written ≤ size``: before the ring wraps, every row ever
    written lies in [0, written) and later rows are inactive. Indices into
    the view are indices into the full store."""
    return ss.replace(**{k: getattr(ss, k)[:size] for k in _ROWS})


def knn_bucket(written: int, capacity: int, floor: int = 4096) -> int:
    """Smallest power of four ≥ ``written`` (≥ ``floor``, ≤ ``capacity``).
    Pass ``SafeSet.written``: past a ring wrap (written > capacity) this is
    ``capacity``, the untrimmed view."""
    b = max(int(floor), 1)
    h = max(int(written), 1)
    while b < h:
        b <<= 2
    return min(b, capacity)


def _keep_first(ss: SafeSet, order: Tensor, keep: int) -> SafeSet:
    keep_mask = torch.zeros(ss.capacity, dtype=torch.bool, device=ss.device)
    keep_mask[order[:keep]] = True
    keep_mask = keep_mask & ss.mask
    return ss.replace(
        traj_ids=torch.where(keep_mask, ss.traj_ids, torch.full_like(ss.traj_ids, -1)),
        count=keep_mask.sum().to(torch.int32))


def prune_quality(ss: SafeSet, keep: int) -> SafeSet:
    """Keep the ``keep`` lowest-Q active rows; mark the rest inactive."""
    score = torch.where(ss.mask, ss.q_values, torch.full_like(ss.q_values, float("inf")))
    return _keep_first(ss, torch.argsort(score, stable=True), keep)


def prune_fifo(ss: SafeSet, keep: int) -> SafeSet:
    """Keep the ``keep`` most recently written active rows (recency from
    the ring head, so it follows write order across a wrap)."""
    cap = ss.capacity
    age = (ss.head.long() - 1 - torch.arange(cap, device=ss.device)) % cap
    score = torch.where(ss.mask, age, torch.full_like(age, cap + 1))
    return _keep_first(ss, torch.argsort(score, stable=True), keep)


def prune_diversity(ss: SafeSet, keep: int, resolution: int = 64) -> SafeSet:
    """Keep the lowest-Q row of every occupied cell of a voxel grid over the
    active rows' ±3σ box, then quality-prune the survivors to ``keep``.
    The cell key mixes the per-dimension cell ids in int32 arithmetic that
    wraps (as the JAX package's does); the (key, Q) order is a stable sort
    by Q and then a stable sort by key."""
    m = ss.mask
    mf = m.to(ss.states.dtype)
    denom = mf.sum().clamp_min(1.0)
    mean = (ss.states * mf[:, None]).sum(0) / denom
    var = ((ss.states - mean) ** 2 * mf[:, None]).sum(0) / denom
    half = (3.0 * torch.sqrt(var)).clamp_min(1e-6)
    cell = torch.floor((ss.states - mean + half) / (2.0 * half) * resolution).clamp(
        0, resolution - 1).to(torch.int32)
    key = torch.zeros(ss.capacity, dtype=torch.int32, device=ss.device)
    mult = torch.tensor(1000003, dtype=torch.int32, device=ss.device)
    for d in range(cell.shape[1]):
        key = key * mult + cell[:, d]
    q = torch.where(m, ss.q_values, torch.full_like(ss.q_values, float("inf")))
    k_sorted = torch.where(m, key, torch.full_like(key, _INT32_MAX))
    order = torch.argsort(q, stable=True)
    order = order[torch.argsort(k_sorted[order], stable=True)]
    sk = key[order]
    first = torch.ones(ss.capacity, dtype=torch.bool, device=ss.device)
    first[1:] = sk[1:] != sk[:-1]
    best = torch.zeros_like(first)
    best[order] = first
    best = best & m
    pruned = ss.replace(
        traj_ids=torch.where(best, ss.traj_ids, torch.full_like(ss.traj_ids, -1)),
        count=best.sum().to(torch.int32))
    return prune_quality(pruned, keep)


def prune(ss: SafeSet, keep: int, strategy: str = "quality", **kw) -> SafeSet:
    """Dispatch on the reference's pruning-strategy names."""
    fns = {"quality": prune_quality, "fifo": prune_fifo, "diversity": prune_diversity}
    if strategy not in fns:
        raise ValueError(
            f"unknown pruning strategy {strategy!r}; expected one of {sorted(fns)}")
    return fns[strategy](ss, keep, **kw)


def merge_safe_sets(sets: List[SafeSet], capacity: Optional[int] = None) -> SafeSet:
    """Concatenate several stores and keep the best ``capacity`` rows,
    compacted lowest-Q first."""
    cap = capacity or sets[0].capacity
    cat = {k: torch.cat([getattr(s, k) for s in sets]) for k in _ROWS}
    merged = sets[0].replace(
        **cat,
        head=torch.zeros((), dtype=torch.int32, device=sets[0].device),
        count=(cat["traj_ids"] >= 0).sum().to(torch.int32),
        n_trajectories=sum(s.n_trajectories for s in sets).to(torch.int32),
        best_cost=torch.stack([s.best_cost for s in sets]).min())
    pruned = prune_quality(merged, cap)
    score = torch.where(pruned.mask, pruned.q_values,
                        torch.full_like(pruned.q_values, float("inf")))
    order = torch.argsort(score, stable=True)[:cap]
    taken = {k: getattr(pruned, k)[order] for k in _ROWS}
    return pruned.replace(**taken, count=(taken["traj_ids"] >= 0).sum().to(torch.int32))


@dataclass
class StreamingSafeSet:
    """Buffered single-state adds: states stream in one at a time and flush
    into the safe set as one pseudo-trajectory when the buffer fills or
    :meth:`flush` is called."""

    safe_set: SafeSet
    buf_X: Tensor  # (buf, n_x)
    buf_U: Tensor
    buf_cost: Tensor
    buf_count: Tensor  # () int32

    @classmethod
    def create(cls, safe_set: SafeSet, buffer_size: int = 64) -> "StreamingSafeSet":
        dev = safe_set.device
        return cls(
            safe_set=safe_set,
            buf_X=torch.zeros(buffer_size, safe_set.states.shape[1], device=dev),
            buf_U=torch.zeros(buffer_size, safe_set.controls.shape[1], device=dev),
            buf_cost=torch.zeros(buffer_size, device=dev),
            buf_count=torch.zeros((), dtype=torch.int32, device=dev))

    def replace(self, **kw) -> "StreamingSafeSet":
        return replace(self, **kw)

    def add(self, x: Tensor, u: Tensor, cost) -> "StreamingSafeSet":
        """Buffer one (x, u, cost); flushes when the buffer is full (a host
        read of the buffer count)."""
        sel = torch.arange(self.buf_X.shape[0], device=self.buf_X.device) == self.buf_count
        cost = torch.as_tensor(cost, dtype=self.buf_cost.dtype, device=self.buf_cost.device)
        new = self.replace(
            buf_X=torch.where(sel[:, None], x.expand_as(self.buf_X), self.buf_X),
            buf_U=torch.where(sel[:, None], u.expand_as(self.buf_U), self.buf_U),
            buf_cost=torch.where(sel, cost, self.buf_cost),
            buf_count=self.buf_count + 1)
        return new.flush() if int(new.buf_count) >= self.buf_X.shape[0] else new

    def flush(self) -> "StreamingSafeSet":
        """Push the buffered states as one trajectory (a no-op when empty);
        padding rows carry zero stage cost so the cost-to-go is exact."""
        mask = torch.arange(self.buf_X.shape[0], device=self.buf_X.device) < self.buf_count
        ss = self.safe_set.add_trajectory(
            self.buf_X, self.buf_U, torch.where(mask, self.buf_cost, torch.zeros_like(self.buf_cost)),
            valid=self.buf_count > 0)
        return self.replace(safe_set=ss, buf_count=torch.zeros_like(self.buf_count))


# name-parity aliases for the reference surface
SampledSafeSet = SafeSet
FuelAwareSafeSet = SafeSet
MemoryOptimizedSafeSet = SafeSet

__all__ = ["FuelAwareSafeSet", "MemoryOptimizedSafeSet", "SafeSet", "SampledSafeSet",
           "StreamingSafeSet", "cost_to_go", "knn_bucket", "merge_safe_sets", "prune",
           "prune_diversity", "prune_fifo", "prune_quality", "safe_set_from_leaves", "trim"]
