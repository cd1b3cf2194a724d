"""The sparse-form MPC QP, batch-first (counterpart of
``gpmpc_tpu/ops/qp/mpc_qp.py``): the linearized-dynamics LTV problem as a
dense OSQP-form QP per lane, with the decision layout
z = [x₀, u₀, x₁, u₁, …, x_N] and the row order

    [ x₀ = x_init ;  A_k x_k + B_k u_k − x_{k+1} = −c_k ;  I z bounds ]

(plus any per-stage facet rows appended by :func:`extend_qp`). Every lane has
its own dynamics rows and bounds; the cost blocks are shared and broadcast.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .types import QPData


def n_vars(N: int, n_x: int, n_u: int) -> int:
    return (N + 1) * n_x + N * n_u


def n_constraints(N: int, n_x: int, n_u: int) -> int:
    return (N + 1) * n_x + n_vars(N, n_x, n_u)


def join_z(X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """(B,N+1,n_x), (B,N,n_u) → interleaved decision vectors (B, n_vars)."""
    Bsz, N, n_u = U.shape
    body = torch.cat([X[:, :-1], U], dim=2).reshape(Bsz, -1)
    return torch.cat([body, X[:, -1]], dim=1)


def split_z(z: torch.Tensor, N: int, n_x: int, n_u: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decision vectors (B, n_vars) → (X (B,N+1,n_x), U (B,N,n_u))."""
    Bsz = z.shape[0]
    body = z[:, : N * (n_x + n_u)].reshape(Bsz, N, n_x + n_u)
    X = torch.cat([body[:, :, :n_x], z[:, None, N * (n_x + n_u):]], dim=1)
    return X, body[:, :, n_x:]


def build_cost(N: int, Q, R, Qf, x_ref, u_ref=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal P = diag(Q,R,…,Q,R,Q_f) (nz,nz), shared by the lanes,
    and the reference-tracking q = [−Q x_ref_k; −R u_ref_k; …; −Q_f x_ref_N]
    (B,nz) for x_ref (B,N+1,n_x); the control slots stay zero for
    ``u_ref=None``."""
    P = torch.block_diag(*([Q, R] * N), Qf)
    qx = -(x_ref[:, :-1] @ Q.T)
    qu = (torch.zeros(*qx.shape[:2], R.shape[0], dtype=Q.dtype, device=Q.device)
          if u_ref is None else -(u_ref @ R.T))
    q = torch.cat([torch.cat([qx, qu], dim=2).flatten(1), -(x_ref[:, -1] @ Qf.T)], dim=1)
    return P, q


def build_constraints(Aks, Bks, cks, x_init, x_min, x_max, u_min, u_max
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Constraint matrix (B,m,nz) and bounds (B,m): Aks (B,N,n_x,n_x), Bks
    (B,N,n_x,n_u), cks (B,N,n_x), x_init (B,n_x); bounds constant ((n_x,),
    (n_u,)) or per stage and lane ((B,N+1,n_x), (B,N,n_u))."""
    Bsz, N, n_x, n_u = Bks.shape
    nz = n_vars(N, n_x, n_u)
    n_eq = (N + 1) * n_x
    dtype, dev = Aks.dtype, Aks.device
    s = n_x + n_u

    A = torch.zeros(Bsz, n_eq + nz, nz, dtype=dtype, device=dev)
    i_x = torch.arange(n_x, device=dev)
    A[:, i_x, i_x] = 1.0  # x_0 = x_init
    # dynamics rows of stage k: [A_k B_k −I] at columns k·s … k·s + s + n_x
    stage = torch.cat([Aks, Bks, -torch.eye(n_x, dtype=dtype, device=dev)
                       .expand(Bsz, N, n_x, n_x)], dim=3)  # (B,N,n_x,s+n_x)
    rows = (n_x + torch.arange(N, device=dev) * n_x)[:, None, None] + i_x[None, :, None]
    cols = (torch.arange(N, device=dev) * s)[:, None, None] + torch.arange(
        s + n_x, device=dev)[None, None, :]
    A[:, rows, cols] = stage
    i_z = torch.arange(nz, device=dev)
    A[:, n_eq + i_z, i_z] = 1.0  # identity for the variable bounds

    eq = torch.cat([x_init, (-cks).flatten(1)], dim=1)
    Xlo = torch.broadcast_to(x_min, (Bsz, N + 1, n_x))
    Xhi = torch.broadcast_to(x_max, (Bsz, N + 1, n_x))
    Ulo = torch.broadcast_to(u_min, (Bsz, N, n_u))
    Uhi = torch.broadcast_to(u_max, (Bsz, N, n_u))
    l = torch.cat([eq, join_z(Xlo, Ulo)], dim=1)
    u = torch.cat([eq, join_z(Xhi, Uhi)], dim=1)
    return A, l, u


def build_stage_rows(N: int, n_x: int, n_u: int, Gx=None, gx_l=None, gx_u=None,
                     Gu=None, gu_l=None, gu_u=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-stage general linear rows Gx·x_k ∈ [gx_l, gx_u] for k = 1..N
    (stage 0 is pinned by the x_init equality) and Gu·u_k ∈ [gu_l, gu_u] for
    every k < N, in the interleaved layout, the same for every lane. Returns
    (A_ext (m_ext,nz), l_ext, u_ext)."""
    nz = n_vars(N, n_x, n_u)
    s = n_x + n_u
    ref = Gx if Gx is not None else Gu
    rows, ls, us = [], [], []
    if Gx is not None:
        n_gx = Gx.shape[0]
        A = torch.zeros(N, n_gx, nz, dtype=ref.dtype, device=ref.device)
        for k in range(1, N + 1):
            A[k - 1, :, k * s : k * s + n_x] = Gx
        rows.append(A.reshape(N * n_gx, nz))
        ls.append(gx_l.repeat(N))
        us.append(gx_u.repeat(N))
    if Gu is not None:
        n_gu = Gu.shape[0]
        A = torch.zeros(N, n_gu, nz, dtype=ref.dtype, device=ref.device)
        for k in range(N):
            A[k, :, k * s + n_x : (k + 1) * s] = Gu
        rows.append(A.reshape(N * n_gu, nz))
        ls.append(gu_l.repeat(N))
        us.append(gu_u.repeat(N))
    return torch.cat(rows), torch.cat(ls), torch.cat(us)


def extend_qp(data: QPData, A_ext, l_ext, u_ext) -> QPData:
    """Append general constraint rows (shared by the lanes, or per lane with
    a leading batch axis) to a built QP; the cost is unchanged."""
    Bsz = data.batch
    return QPData(
        P=data.P, q=data.q,
        A=torch.cat([data.A, A_ext.expand(Bsz, *A_ext.shape[-2:])], dim=1),
        l=torch.cat([data.l, l_ext.expand(Bsz, l_ext.shape[-1])], dim=1),
        u=torch.cat([data.u, u_ext.expand(Bsz, u_ext.shape[-1])], dim=1),
    )


def build_mpc_qp(Aks, Bks, cks, x_init, Q, R, Qf, x_ref, x_min, x_max, u_min, u_max,
                 u_ref: Optional[torch.Tensor] = None) -> QPData:
    """Assemble the full LTV-MPC QP of every lane in OSQP form; x_ref is
    (B,N+1,n_x) or broadcastable to it."""
    Bsz, N, n_x, _ = Bks.shape
    P, q = build_cost(N, Q, R, Qf, torch.broadcast_to(x_ref, (Bsz, N + 1, n_x)), u_ref)
    A, l, u = build_constraints(Aks, Bks, cks, x_init, x_min, x_max, u_min, u_max)
    return QPData(P=P.expand(Bsz, *P.shape), q=q, A=A, l=l, u=u)
