"""QP problem/solution containers (counterpart of ``gpmpc_tpu/ops/qp/types.py``).

Canonical OSQP form, one QP per lane of a leading batch axis B:

    min  ½ zᵀPz + qᵀz
    s.t. l ≤ Az ≤ u

Equality rows are expressed as l_i = u_i.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# status codes (int32 per batch lane)
SOLVED = 0
MAX_ITER = 1
PRIMAL_INFEASIBLE = 2
DUAL_INFEASIBLE = 3

STATUS_NAMES = {
    SOLVED: "solved",
    MAX_ITER: "max_iter_reached",
    PRIMAL_INFEASIBLE: "primal_infeasible",
    DUAL_INFEASIBLE: "dual_infeasible",
}


@dataclass
class QPData:
    """Dense batched QP data: P (B,n,n) symmetric PSD, q (B,n), A (B,m,n),
    l, u (B,m)."""

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor

    @property
    def n(self) -> int:
        return self.q.shape[-1]

    @property
    def m(self) -> int:
        return self.l.shape[-1]

    @property
    def batch(self) -> int:
        return self.q.shape[0]


@dataclass
class QPSolution:
    """Solver output per lane: ``x`` primal (B,n), ``y`` dual (B,m), ``z`` the
    slack estimate Ax (B,m); scalars per lane are (B,)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    obj: torch.Tensor
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    iterations: torch.Tensor
    status: torch.Tensor
    rho: torch.Tensor  # adapted ADMM penalty at exit (feed back as rho0)
