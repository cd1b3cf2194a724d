"""Carry state and configs across from the JAX package through plain NumPy.

The port never imports JAX: a caller (in this repository, the parity tests)
flattens a JAX object into a dict of NumPy arrays or plain values, and these
functions build the port's counterpart from that dict.

``simple3dof_gp_from_numpy`` expects the keys of a fitted ``Simple3DoFGP``:

- ``Z``, ``X``, ``Y`` (n_out, cap), ``mask``, ``log_noise`` — the sparse GP;
- ``log_lengthscales`` (n_out, d), ``log_variance`` (n_out,) — the stacked
  SE-ARD kernels;
- ``Luu_inv``, ``LB_inv``, ``c`` — the cached factors;
- ``buffer_X``, ``buffer_Y``, ``buffer_head``, ``buffer_count`` — the store;
- optionally ``method`` (default "fitc") and ``config`` (a dict of
  ``StructuredGPConfig`` fields).
"""

from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict

import numpy as np
import torch

from ._device import DeviceLike, as_f32, resolve_device
from .gp import Simple3DoFFeatureExtractor, Simple3DoFGP, StructuredGPConfig
from .gp.kernels import SquaredExponentialARD
from .gp.sparse_gp import MultiOutputSparseGPState
from .gp.structured_gp import RingBuffer
from .mpc import GPMPCConfig, RTIConfig
from .ops.qp import ADMMConfig


def simple3dof_gp_from_numpy(d: Dict[str, Any], device: DeviceLike = "cuda") -> Simple3DoFGP:
    dev = resolve_device(device)
    f = lambda k: as_f32(np.array(d[k]), dev)
    i32 = lambda k: torch.as_tensor(np.array(d[k]), dtype=torch.int32, device=dev)
    kernels = SquaredExponentialARD(log_variance=f("log_variance"),
                                    log_lengthscales=f("log_lengthscales"))
    gp = MultiOutputSparseGPState(
        kernels=kernels, Z=f("Z"), X=f("X"), Y=f("Y"),
        mask=torch.as_tensor(np.array(d["mask"]), dtype=torch.bool, device=dev),
        log_noise=f("log_noise"), method=str(d.get("method", "fitc")),
        Luu_inv=f("Luu_inv"), LB_inv=f("LB_inv"), c=f("c"),
    )
    buf = RingBuffer(X=f("buffer_X"), Y=f("buffer_Y"),
                     head=i32("buffer_head"), count=i32("buffer_count"))
    cfg = _dataclass_from(StructuredGPConfig, d.get("config", {}))
    return Simple3DoFGP(config=cfg, extractor=Simple3DoFFeatureExtractor(),
                        buffer=buf, gp=gp, is_fitted=True)


def _plain(v):
    """NumPy scalars → Python scalars, arrays stay arrays."""
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _dataclass_from(cls, d: Dict[str, Any], **extra):
    names = {f.name for f in fields(cls) if f.init}
    kw = {k: _plain(v) for k, v in d.items() if k in names}
    kw.update(extra)
    return cls(**kw)


def admm_config_from_fields(d: Dict[str, Any]) -> ADMMConfig:
    """The port's ``ADMMConfig`` from the JAX config's field values."""
    return _dataclass_from(ADMMConfig, d)


def rti_config_from_fields(d: Dict[str, Any], device: DeviceLike = "cuda") -> RTIConfig:
    """The port's ``RTIConfig`` from the JAX config's field values; the
    nested ``admm`` entry is itself a dict of ``ADMMConfig`` fields and the
    matrices are NumPy arrays (or None)."""
    dev = resolve_device(device)
    extra = {"device": dev}
    if "admm" in d:
        extra["admm"] = admm_config_from_fields(d["admm"])
    arrays = {k: (None if v is None else as_f32(np.array(v), dev))
              for k, v in d.items()
              if k in ("Q", "R", "Qf", "x_min", "x_max", "u_min", "u_max",
                       "Gx", "gx_l", "gx_u", "Gu", "gu_l", "gu_u")}
    extra.update(arrays)
    if d.get("x_bound_mask") is not None:
        extra["x_bound_mask"] = tuple(bool(b) for b in d["x_bound_mask"])
    return _dataclass_from(RTIConfig, d, **extra)


def gp_mpc_config_from_fields(d: Dict[str, Any], device: DeviceLike = "cuda") -> GPMPCConfig:
    """The port's ``GPMPCConfig``; ``base`` is a dict for
    :func:`rti_config_from_fields`."""
    extra = {}
    if "base" in d:
        extra["base"] = rti_config_from_fields(d["base"], device)
    if d.get("tighten_mask") is not None:
        extra["tighten_mask"] = as_f32(np.array(d["tighten_mask"]), resolve_device(device))
    return _dataclass_from(GPMPCConfig, d, **extra)
