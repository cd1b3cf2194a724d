"""Residual collection (counterpart of
``gpmpc_tpu/gp/online_update.py::ResidualCollector``; the online updater
arrives with the online-learning slice)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class ResidualCollector:
    """d = (x_actual − f_nom(x, u)) / dt on the learned slices (velocity
    [4:7] and, for 14-state, rate [11:14])."""

    dt: float = 0.1

    def collect_batch(self, step_fn: Callable, X, U, X_next) -> torch.Tensor:
        """Residuals of a batch of transitions (any leading dims)."""
        err = (X_next - step_fn(X, U)) / self.dt
        if X.shape[-1] >= 14:
            return torch.cat([err[..., 4:7], err[..., 11:14]], dim=-1)
        return err[..., 4:7]
