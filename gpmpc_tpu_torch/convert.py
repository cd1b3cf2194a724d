"""Carry state and configs across from the JAX package through plain NumPy.

The port never imports JAX: a caller (in this repository, the parity tests)
flattens a JAX object into a dict of NumPy arrays or plain values, and these
functions build the port's counterpart from that dict.

``rti_state_from_numpy`` expects the fields of a (batched) ``RTIState``:
``X_lin``, ``U_lin``, ``X_prev``, ``U_prev``, ``y_prev``, ``rho``, ``x_ref``,
each with a leading lane axis, and optionally the warm-KKT carry
``kkt_inv``, ``scal_D``, ``scal_E``, ``scal_c``; ``gp_mpc_state_from_numpy``
those of a ``GPMPCState`` (``X_lin``, ``U_lin``, ``x_ref``, ``rho``,
``y_prev`` and the same carry). The carry is taken where ``kkt_inv`` holds
entries: the JAX package's zero-size placeholders (warm KKT off) become
None.

``simple3dof_gp_from_numpy`` expects the keys of a fitted ``Simple3DoFGP``,
tuned or not (a tuned GP differs only in its kernel parameters, noise and
factors):

- ``Z``, ``X``, ``Y`` (n_out, cap), ``mask``, ``log_noise`` — the sparse GP;
- ``log_lengthscales`` (n_out, d), ``log_variance`` (n_out,) — the stacked
  SE-ARD kernels;
- ``Luu_inv``, ``LB_inv``, ``c`` — the cached factors;
- ``buffer_X``, ``buffer_Y``, ``buffer_head``, ``buffer_count`` — the store;
- optionally ``method`` (default "fitc") and ``config`` (a dict of
  ``StructuredGPConfig`` fields).

``structured_rocket_gp_from_numpy`` expects the same keys for each of a
fitted ``StructuredRocketGP``'s two GPs and stores, prefixed ``trans_`` and
``rot_`` (``trans_Z``, …, ``rot_buffer_count``), plus the optional
unprefixed ``config``.

``online_gp_from_numpy`` carries a GP per lane across — the GP of a JAX
``OnlineGPMPCState``, or the ``gps`` of a JAX fleet
(``run_batched_learning``), i.e. per-lane GPs stacked on a leading axis: the
same keys as the two functions above, each array with the leading lane axis
(``Z`` (B, M, d), ``buffer_head`` (B,), …); the ``trans_`` keys select the
structured model.

``sparse_gp_state_from_numpy`` expects the fields of a single-output
``SparseGPState`` (``Z``, ``X``, ``y``, ``mask``, ``log_noise``,
``Luu_inv``, ``LB_inv``, ``c``, optionally ``method``) and
``exact_gp_state_from_numpy`` those of an ``ExactGPState`` (``X``, ``y``,
``mask``, ``log_noise``, ``L``, ``alpha``); the kernel is an SE-ARD one from
``log_variance`` and ``log_lengthscales`` unless the caller passes one.

``batched_learning_config_from_fields`` expects the fields of a
``BatchedLearningConfig``, its ``gp`` entry a dict of ``StructuredGPConfig``
fields.

``rocket6dof_params_from_fields`` expects the fields of a
``Rocket6DoFParams`` (the vectors and matrices as NumPy arrays).

``safe_set_from_numpy`` reads a JAX ``SafeSet``: its 12 leaves in pytree
order (``jax.tree.flatten(ss)[0]``, the order its ``.npz`` files use) or a
dict of its fields. ``lmpc_config_from_fields`` and
``ipm_config_from_fields`` take the fields of an ``LMPCConfig`` (its
``admm`` entry a dict of ``ADMMConfig`` fields, the matrices NumPy arrays)
and of an ``IPMConfig``.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict

import numpy as np
import torch

from ._device import DeviceLike, as_f32, resolve_device
from .dynamics import Rocket6DoFParams
from .gp import (
    RotationalFeatureExtractor,
    Simple3DoFFeatureExtractor,
    Simple3DoFGP,
    StructuredGPConfig,
    StructuredRocketGP,
    TranslationalFeatureExtractor,
)
from .gp.exact_gp import ExactGPState
from .gp.kernels import SquaredExponentialARD
from .gp.sparse_gp import MultiOutputSparseGPState, SparseGPState
from .gp.structured_gp import RingBuffer
from .learning.batched_learner import BatchedLearningConfig
from .lmpc import LMPCConfig
from .mpc import GPMPCConfig, GPMPCState, RTIConfig, RTIState
from .ops.qp import ADMMConfig, IPMConfig
from .terminal.safe_set import _LEAVES, SafeSet, safe_set_from_leaves


def _getters(d: Dict[str, Any], prefix: str, dev: torch.device):
    """(float32, bool) tensor getters of the ``prefix``-ed keys."""
    f = lambda k: as_f32(np.array(d[prefix + k]), dev)
    b = lambda k: torch.as_tensor(np.array(d[prefix + k]), dtype=torch.bool, device=dev)
    return f, b


def _se_ard(f) -> SquaredExponentialARD:
    return SquaredExponentialARD(log_variance=f("log_variance"),
                                 log_lengthscales=f("log_lengthscales"))


def _sparse_gp(d: Dict[str, Any], prefix: str, dev: torch.device):
    """(MultiOutputSparseGPState, RingBuffer) from the ``prefix``-ed keys."""
    f, b = _getters(d, prefix, dev)
    i32 = lambda k: torch.as_tensor(np.array(d[prefix + k]), dtype=torch.int32, device=dev)
    gp = MultiOutputSparseGPState(
        kernels=_se_ard(f), Z=f("Z"), X=f("X"), Y=f("Y"), mask=b("mask"),
        log_noise=f("log_noise"), method=str(d.get(prefix + "method", "fitc")),
        Luu_inv=f("Luu_inv"), LB_inv=f("LB_inv"), c=f("c"),
    )
    buf = RingBuffer(X=f("buffer_X"), Y=f("buffer_Y"),
                     head=i32("buffer_head"), count=i32("buffer_count"))
    return gp, buf


def simple3dof_gp_from_numpy(d: Dict[str, Any], device: DeviceLike = "cuda") -> Simple3DoFGP:
    gp, buf = _sparse_gp(d, "", resolve_device(device))
    cfg = _dataclass_from(StructuredGPConfig, d.get("config", {}))
    return Simple3DoFGP(config=cfg, extractor=Simple3DoFFeatureExtractor(),
                        buffer=buf, gp=gp, is_fitted=True)


def structured_rocket_gp_from_numpy(d: Dict[str, Any],
                                    device: DeviceLike = "cuda") -> StructuredRocketGP:
    dev = resolve_device(device)
    trans_gp, trans_buf = _sparse_gp(d, "trans_", dev)
    rot_gp, rot_buf = _sparse_gp(d, "rot_", dev)
    return StructuredRocketGP(
        config=_dataclass_from(StructuredGPConfig, d.get("config", {})),
        trans_extractor=TranslationalFeatureExtractor(),
        rot_extractor=RotationalFeatureExtractor(),
        trans_buffer=trans_buf, rot_buffer=rot_buf, trans_gp=trans_gp, rot_gp=rot_gp,
        is_fitted=True)


def online_gp_from_numpy(d: Dict[str, Any], device: DeviceLike = "cuda"):
    """A GP per lane (``Simple3DoFGP`` or ``StructuredRocketGP``) from the
    leaves of a JAX online controller's GP or of a JAX fleet's ``gps``."""
    if "trans_Z" in d:
        return structured_rocket_gp_from_numpy(d, device)
    return simple3dof_gp_from_numpy(d, device)


def sparse_gp_state_from_numpy(d: Dict[str, Any], device: DeviceLike = "cuda",
                               kernel=None) -> SparseGPState:
    f, b = _getters(d, "", resolve_device(device))
    return SparseGPState(
        kernel=_se_ard(f) if kernel is None else kernel, Z=f("Z"), X=f("X"), y=f("y"),
        mask=b("mask"), log_noise=f("log_noise"), method=str(d.get("method", "fitc")),
        Luu_inv=f("Luu_inv"), LB_inv=f("LB_inv"), c=f("c"))


def exact_gp_state_from_numpy(d: Dict[str, Any], device: DeviceLike = "cuda",
                              kernel=None) -> ExactGPState:
    f, b = _getters(d, "", resolve_device(device))
    return ExactGPState(kernel=_se_ard(f) if kernel is None else kernel, X=f("X"), y=f("y"),
                        mask=b("mask"), log_noise=f("log_noise"), L=f("L"), alpha=f("alpha"))


def batched_learning_config_from_fields(d: Dict[str, Any]) -> BatchedLearningConfig:
    """The port's ``BatchedLearningConfig`` from the JAX config's field values."""
    extra = {}
    if "gp" in d:
        extra["gp"] = _dataclass_from(StructuredGPConfig, d["gp"])
    return _dataclass_from(BatchedLearningConfig, d, **extra)


def rocket6dof_params_from_fields(d: Dict[str, Any],
                                  device: DeviceLike = "cuda") -> Rocket6DoFParams:
    """The port's ``Rocket6DoFParams`` from the JAX params' field values."""
    return _dataclass_from(Rocket6DoFParams, d, device=resolve_device(device))


_KKT_CARRY = ("kkt_inv", "scal_D", "scal_E", "scal_c")


def _state_from_numpy(cls, d: Dict[str, Any], device: DeviceLike):
    dev = resolve_device(device)
    warm = d.get("kkt_inv") is not None and np.asarray(d["kkt_inv"]).size > 0
    return cls(**{f.name: as_f32(np.array(d[f.name]), dev) for f in fields(cls)
                  if f.name not in _KKT_CARRY or warm})


def rti_state_from_numpy(d: Dict[str, Any], device: DeviceLike = "cuda") -> RTIState:
    return _state_from_numpy(RTIState, d, device)


def gp_mpc_state_from_numpy(d: Dict[str, Any], device: DeviceLike = "cuda") -> GPMPCState:
    return _state_from_numpy(GPMPCState, d, device)


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


def safe_set_from_numpy(d, device: DeviceLike = "cuda") -> SafeSet:
    """The port's ``SafeSet`` from a JAX one's leaves (a sequence in pytree
    order) or fields (a dict)."""
    leaves = [d[k] for k in _LEAVES] if isinstance(d, dict) else list(d)
    return safe_set_from_leaves(leaves, device)


def ipm_config_from_fields(d: Dict[str, Any]) -> IPMConfig:
    """The port's ``IPMConfig`` from the JAX config's field values."""
    return _dataclass_from(IPMConfig, d)


def lmpc_config_from_fields(d: Dict[str, Any], device: DeviceLike = "cuda") -> LMPCConfig:
    """The port's ``LMPCConfig`` from the JAX config's field values."""
    dev = resolve_device(device)
    extra = {"device": dev}
    if "admm" in d:
        extra["admm"] = admm_config_from_fields(d["admm"])
    extra.update({k: as_f32(np.array(d[k]), dev)
                  for k in ("Q", "R", "x_min", "x_max", "u_min", "u_max") if k in d})
    if d.get("x_bound_mask") is not None:
        extra["x_bound_mask"] = tuple(bool(b) for b in d["x_bound_mask"])
    return _dataclass_from(LMPCConfig, d, **extra)
