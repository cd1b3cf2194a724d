"""RTI configuration and the condensed-QP row helpers that GP-MPC uses
(counterpart of the corresponding parts of ``gpmpc_tpu/mpc/rti.py``).

The GP-free RTI cycle itself (``rti_init`` / ``rti_step``) is not ported in
this slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..ops.qp import ADMMConfig

_Q_DIAG = (0.0, 10.0, 10.0, 10.0, 1.0, 1.0, 1.0)


@dataclass(frozen=True)
class RTIConfig:
    """RTI settings; field names and defaults are those of the JAX
    ``RTIConfig`` (the fields only the GP-free RTI cycle reads come with
    that cycle). The matrices live on ``device`` (built once, so the
    control cycle never copies them); pass ``None`` to take the defaults."""

    N: int = 15
    dt: float = 0.1
    n_x: int = 7
    n_u: int = 3
    Q: Optional[torch.Tensor] = None
    R: Optional[torch.Tensor] = None
    Qf: Optional[torch.Tensor] = None
    x_min: Optional[torch.Tensor] = None
    x_max: Optional[torch.Tensor] = None
    u_min: Optional[torch.Tensor] = None
    u_max: Optional[torch.Tensor] = None
    admm: ADMMConfig = field(default_factory=lambda: ADMMConfig(max_iter=100, polish=True))
    solver: str = "admm"
    accept_pri_tol: float = 0.0
    condensed: bool = False
    Gx: Optional[torch.Tensor] = None
    gx_l: Optional[torch.Tensor] = None
    gx_u: Optional[torch.Tensor] = None
    Gu: Optional[torch.Tensor] = None
    gu_l: Optional[torch.Tensor] = None
    gu_u: Optional[torch.Tensor] = None
    x_bound_mask: Optional[tuple] = None
    stage_rows_fn: Optional[Callable] = None
    n_stage_rows: int = 0
    device: DeviceLike = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        defaults = {
            "Q": torch.diag(torch.tensor(_Q_DIAG)),
            "R": torch.eye(3) * 0.01,
            "Qf": torch.diag(torch.tensor(_Q_DIAG) * 10.0),
            "x_min": torch.tensor([-1e20, -100.0, -100.0, -100.0, -50.0, -50.0, -50.0]),
            "x_max": torch.tensor([1e20, 500.0, 100.0, 100.0, 50.0, 50.0, 50.0]),
            "u_min": torch.tensor([0.3, -5.0, -5.0]),
            "u_max": torch.tensor([5.0, 5.0, 5.0]),
        }
        for name, default in defaults.items():
            v = getattr(self, name)
            v = default if v is None else v
            object.__setattr__(self, name, torch.as_tensor(
                v, dtype=torch.float32).to(dev))

    def replace(self, **kw) -> "RTIConfig":
        return replace(self, **kw)


def _n_gx_rows(config) -> int:
    """Per-stage state-row count: constant facet block OR linearized rows."""
    if config.stage_rows_fn is not None:
        if config.Gx is not None:
            raise ValueError("stage_rows_fn replaces the Gx block — set Gx=None")
        if config.n_stage_rows <= 0:
            raise ValueError("stage_rows_fn requires n_stage_rows > 0")
        return config.n_stage_rows
    if config.Gx is None:
        return 0
    return config.Gx.shape[1] if config.Gx.dim() == 3 else config.Gx.shape[0]


def _n_extra_rows(config) -> int:
    n_gu = 0 if config.Gu is None else config.Gu.shape[0]
    return config.N * (_n_gx_rows(config) + n_gu)


def _gx_rows(config, X_lin):
    """(Gx, gx_l, gx_u): the configured constant block, or the per-cycle
    linearization around ``X_lin``."""
    if config.stage_rows_fn is not None:
        return config.stage_rows_fn(X_lin)
    return config.Gx, config.gx_l, config.gx_u


def _n_bound_states(config) -> int:
    """State components with condensed bound rows (see x_bound_mask)."""
    if config.x_bound_mask is None:
        return config.n_x
    return sum(bool(b) for b in config.x_bound_mask)


def _condensed_admm_cfg(config) -> ADMMConfig:
    """ADMM config with the condensed QP's row structure declared: state-bound
    rows block-lower-triangular, control-bound rows the identity, state facets
    BLT, control facets block-diagonal. User-set row_structure wins."""
    if config.admm.row_structure is not None:
        return config.admm
    N, n_u = config.N, config.n_u
    n_b = _n_bound_states(config)
    C = next((c for c in (5, 4, 3, 2) if N % c == 0), 1)
    s = N // C
    segs = []
    if n_b:
        segs.append(("blt", C, s * n_b, s * n_u))
    segs.append(("diag", N * n_u))
    n_gx = _n_gx_rows(config)
    if n_gx:
        segs.append(("blt", C, s * n_gx, s * n_u))
    if config.Gu is not None:
        segs.append(("blockdiag_shared", N, config.Gu.shape[0], n_u))
    return config.admm.replace(row_structure=tuple(segs))
