"""Batched convex-QP solvers (counterpart of ``gpmpc_tpu/ops/qp``)."""

from .admm import ADMMConfig, solve
from .condensed import build_condensed_qp, prediction_matrices, recover_states
from .mpc_qp import join_z, split_z
from .ruiz import Scaling, ruiz_equilibrate
from .types import (
    DUAL_INFEASIBLE,
    MAX_ITER,
    PRIMAL_INFEASIBLE,
    SOLVED,
    STATUS_NAMES,
    QPData,
    QPSolution,
)

__all__ = [
    "ADMMConfig", "DUAL_INFEASIBLE", "MAX_ITER", "PRIMAL_INFEASIBLE",
    "SOLVED", "STATUS_NAMES", "QPData", "QPSolution", "Scaling",
    "build_condensed_qp", "join_z", "prediction_matrices", "recover_states",
    "ruiz_equilibrate", "solve", "split_z",
]
