"""Chance-constraint helpers (counterpart of
``gpmpc_tpu/mpc/constraints.py::normal_quantile``)."""

from __future__ import annotations

import torch


def normal_quantile(confidence: torch.Tensor) -> torch.Tensor:
    """κ = Φ⁻¹(confidence)."""
    return torch.special.ndtri(confidence)
