"""Convex-hull terminal constraints in vertex (λ) form (counterpart of
``gpmpc_tpu/terminal/convex_hull.py``), lanes first.

The terminal constraint x_N = Σλᵢvᵢ, Σλ = 1, λ ≥ 0; membership through the
projection QP min‖x − Vᵀλ‖² on the shared ADMM solver (its chunk kernel
on the card); :func:`hull_constraint_rows` emits the rows the LMPC QP
appends for its λ block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.qp import SOLVED, ADMMConfig, QPData
from ..ops.qp import solve as qp_solve
from .local_safe_set import KNNResult, LocalSafeSetConfig, knn_query
from .safe_set import SafeSet

Tensor = torch.Tensor


class HullProjection(NamedTuple):
    point: Tensor  # (B, n_x) Vᵀλ, the closest point in the hull
    lam: Tensor  # (B, K) barycentric weights
    distance: Tensor  # (B,) ‖x − Vᵀλ‖
    inside: Tensor  # (B,) bool — distance ≤ tol and the QP solved


def project_onto_hull(vertices: Tensor, x: Tensor, vertex_valid: Optional[Tensor] = None,
                      admm: Optional[ADMMConfig] = None, tol: float = 1e-3) -> HullProjection:
    """min_λ ‖x − Vᵀλ‖² s.t. Σλ = 1, λ ≥ 0 for every lane: vertices
    (B, K, n_x), x (B, n_x), vertex_valid (B, K); invalid vertices are
    pinned to λ = 0. 150 ADMM iterations with polish unless ``admm`` says
    otherwise."""
    Bsz, K, n_x = vertices.shape
    dt, dev = vertices.dtype, vertices.device
    valid = (torch.ones(Bsz, K, dtype=torch.bool, device=dev) if vertex_valid is None
             else vertex_valid)
    admm = admm or ADMMConfig(max_iter=150, polish=True)
    vf = valid.to(dt)
    V = vertices * vf[..., None]
    P = V @ V.transpose(-1, -2) + 1e-8 * torch.eye(K, dtype=dt, device=dev)
    q = -(V @ x[..., None])[..., 0]
    # rows: Σλ = 1; λ bounds (invalid ones forced to 0)
    A = torch.cat([vf[:, None, :], torch.eye(K, dtype=dt, device=dev).expand(Bsz, K, K)], dim=1)
    ones = torch.ones(Bsz, 1, dtype=dt, device=dev)
    l = torch.cat([ones, torch.zeros(Bsz, K, dtype=dt, device=dev)], dim=1)
    u = torch.cat([ones, vf], dim=1)
    sol = qp_solve(QPData(P=P, q=q, A=A, l=l, u=u), config=admm)
    lam = sol.x
    point = (V.transpose(-1, -2) @ lam[..., None])[..., 0]
    dist = torch.linalg.vector_norm(x - point, dim=-1)
    return HullProjection(point=point, lam=lam, distance=dist,
                          inside=(dist <= tol) & (sol.status == SOLVED))


def contains(vertices: Tensor, x: Tensor, vertex_valid: Optional[Tensor] = None,
             tol: float = 1e-3) -> Tensor:
    """Membership per lane by projection distance."""
    return project_onto_hull(vertices, x, vertex_valid, tol=tol).inside


def hull_constraint_rows(vertices: Tensor, q_values: Tensor, vertex_valid: Tensor,
                         n_z: int, xN_offset: int, soft: bool = True
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Rows and cost pieces appending a hull λ block to every lane's MPC QP:
    vertices (B, K, n_x), q_values and vertex_valid (B, K). The extended
    decision vector is z_ext = [z_base; λ (K); s (n_x slack)]:

        x_N − Vᵀλ − s = 0   (n_x equality rows)
        Σλ = 1,  0 ≤ λᵢ ≤ valid_i

    Returns (A (B, n_x+1+K, n_z+K+n_x), l, u, q_lambda (B, K)); q_lambda is
    the linear terminal cost Qᵀλ on the valid vertices. ``soft`` is taken
    for the JAX signature's sake: the slack columns are always emitted and
    the caller prices them."""
    Bsz, K, n_x = vertices.shape
    dt, dev = vertices.dtype, vertices.device
    vf = vertex_valid.to(dt)
    rows = n_x + 1 + K
    A = torch.zeros(Bsz, rows, n_z + K + n_x, dtype=dt, device=dev)
    i_x, i_k = torch.arange(n_x, device=dev), torch.arange(K, device=dev)
    A[:, i_x, xN_offset + i_x] = 1.0
    A[:, :n_x, n_z:n_z + K] = -(vertices * vf[..., None]).transpose(-1, -2)
    A[:, i_x, n_z + K + i_x] = -1.0
    A[:, n_x, n_z:n_z + K] = vf
    A[:, n_x + 1 + i_k, n_z + i_k] = 1.0
    zx = torch.zeros(Bsz, n_x, dtype=dt, device=dev)
    one = torch.ones(Bsz, 1, dtype=dt, device=dev)
    l = torch.cat([zx, one, torch.zeros(Bsz, K, dtype=dt, device=dev)], dim=1)
    u = torch.cat([zx, one, vf], dim=1)
    q_lambda = torch.where(vertex_valid, q_values, torch.zeros_like(q_values))
    return A, l, u, q_lambda


class ConvexHullConstraint:
    """OO facade over one vertex set per lane."""

    def __init__(self, vertices: Tensor, vertex_valid: Optional[Tensor] = None):
        self.vertices = vertices
        self.vertex_valid = (torch.ones(vertices.shape[:2], dtype=torch.bool,
                                        device=vertices.device)
                             if vertex_valid is None else vertex_valid)

    def contains(self, x: Tensor, tol: float = 1e-3) -> Tensor:
        return contains(self.vertices, x, self.vertex_valid, tol)

    def project(self, x: Tensor) -> HullProjection:
        return project_onto_hull(self.vertices, x, self.vertex_valid)


# CasADi-name parity: the QP-row builder plays that role here
CasADiConvexHullConstraint = ConvexHullConstraint


class TerminalSetManager:
    """KNN query → hull vertices and Q-values per lane."""

    def __init__(self, n_vertices: int = 10, knn_config: Optional[LocalSafeSetConfig] = None):
        self.n_vertices = n_vertices
        self.knn_config = knn_config or LocalSafeSetConfig(K=n_vertices)

    def get_terminal_set(self, ss: SafeSet, x_query: Tensor, fuel_available=None) -> KNNResult:
        """Local vertices around each lane's expected terminal state."""
        return knn_query(ss, x_query, self.n_vertices, None, fuel_available)
