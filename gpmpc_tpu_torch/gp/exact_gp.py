"""GP prediction container (counterpart of
``gpmpc_tpu/gp/exact_gp.py::GPPrediction``; the exact GP itself comes with
a later slice)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class GPPrediction(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
