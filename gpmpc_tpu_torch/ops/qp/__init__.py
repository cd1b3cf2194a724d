"""Batched convex-QP solvers (counterpart of ``gpmpc_tpu/ops/qp``)."""

from .admm import ADMMConfig, solve, solve_batch, solve_jit
from .ipm import IPMConfig, solve_ipm
from .condensed import (
    build_condensed_qp,
    n_condensed_constraints,
    prediction_matrices,
    recover_states,
)
from .mpc_qp import (
    build_constraints,
    build_cost,
    build_mpc_qp,
    build_stage_rows,
    extend_qp,
    join_z,
    n_constraints,
    n_vars,
    split_z,
)
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
    "ADMMConfig", "IPMConfig", "DUAL_INFEASIBLE", "MAX_ITER", "PRIMAL_INFEASIBLE",
    "SOLVED", "STATUS_NAMES", "QPData", "QPSolution", "Scaling",
    "build_condensed_qp", "build_constraints", "build_cost", "build_mpc_qp",
    "build_stage_rows", "extend_qp", "join_z", "n_condensed_constraints",
    "n_constraints", "n_vars", "prediction_matrices", "recover_states",
    "ruiz_equilibrate", "solve", "solve_batch", "solve_ipm", "solve_jit", "split_z",
]
