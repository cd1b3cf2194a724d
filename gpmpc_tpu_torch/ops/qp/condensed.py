"""Condensed MPC QP, batch-first (counterpart of
``gpmpc_tpu/ops/qp/condensed.py``): eliminate the states, decision variables
are the controls only.

    X = Γ·U + d,   Γ_{k,j} = A_{k-1}…A_{j+1} B_j,   d_k = A…(x₀) + Σ A…c

so each lane's QP has n = N·n_u variables and no equality rows.

Row order: [ state bounds k=1..N (components selected by x_bound_mask) ;
             control bounds k=0..N-1 ].
Facet rows (Gx, Gu) arrive with the 6-DoF slice and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .types import QPData


def prediction_matrices(Aks, Bks, cks, x0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Γ stages and free response: Aks (B,N,n_x,n_x), Bks (B,N,n_x,n_u),
    cks (B,N,n_x), x0 (B,n_x) → Gs (B,N,n_x,N·n_u) with Gs[:,k] = Γ_{k+1},
    ds (B,N,n_x) with ds[:,k] = d_{k+1}."""
    Bsz, N, n_x, n_u = Bks.shape
    G = torch.zeros(Bsz, n_x, N * n_u, dtype=Aks.dtype, device=Aks.device)
    d = x0
    Gs, ds = [], []
    for k in range(N):
        G = Aks[:, k] @ G
        G[:, :, k * n_u : (k + 1) * n_u] = Bks[:, k]  # G is a fresh product
        d = torch.bmm(Aks[:, k], d[:, :, None])[:, :, 0] + cks[:, k]
        Gs.append(G)
        ds.append(d)
    return torch.stack(Gs, dim=1), torch.stack(ds, dim=1)


def recover_states(Gs, ds, u, x0) -> torch.Tensor:
    """(B, N+1, n_x) trajectory from the condensed solution u (B, N·n_u)."""
    X = torch.einsum("bkij,bj->bki", Gs, u) + ds
    return torch.cat([x0[:, None], X], dim=1)


def build_condensed_qp(
    Aks, Bks, cks, x0, Q, R, Qf,
    x_ref,  # (B,N+1,n_x) or broadcastable
    x_min, x_max,  # (n_x,) or (B,N+1,n_x)
    u_min, u_max,  # (n_u,) or (B,N,n_u)
    Gx=None, gx_l=None, gx_u=None, Gu=None, gu_l=None, gu_u=None,
    x_bound_mask: Optional[tuple] = None,
) -> Tuple[QPData, torch.Tensor, torch.Tensor]:
    """Assemble the batched condensed QP; returns (data, Gs, ds) — keep
    (Gs, ds) for :func:`recover_states`. Cost/bound semantics match the JAX
    builder (objective ½(x−r)ᵀQ(x−r) per stage, Qf at k=N)."""
    if Gx is not None or Gu is not None:
        raise NotImplementedError(
            "condensed facet rows (Gx/Gu) are not ported yet; they arrive "
            "with the 6-DoF slice")
    Bsz, N, n_x, n_u = Bks.shape
    nu = N * n_u
    dtype, dev = Aks.dtype, Aks.device

    Gs, ds = prediction_matrices(Aks, Bks, cks, x0)

    x_ref = torch.broadcast_to(x_ref, (Bsz, N + 1, n_x))
    # stage weights: Q for k=1..N-1, Qf for k=N
    Wg = torch.cat([Q.expand(N - 1, n_x, n_x), Qf[None]], dim=0)
    WG = torch.einsum("kij,bkjl->bkil", Wg, Gs)  # (B,N,n_x,nu)
    P = torch.einsum("bkij,bkil->bjl", Gs, WG)
    P = P + torch.block_diag(*([R] * N))
    P = 0.5 * (P + P.transpose(1, 2))

    err = ds - x_ref[:, 1:]
    q = torch.einsum("bkil,bki->bl", WG, err)

    Xlo = torch.broadcast_to(x_min, (Bsz, N + 1, n_x))[:, 1:]
    Xhi = torch.broadcast_to(x_max, (Bsz, N + 1, n_x))[:, 1:]
    Ulo = torch.broadcast_to(u_min, (Bsz, N, n_u)).reshape(Bsz, nu)
    Uhi = torch.broadcast_to(u_max, (Bsz, N, n_u)).reshape(Bsz, nu)

    sel = (list(range(n_x)) if x_bound_mask is None
           else [i for i, keep in enumerate(x_bound_mask) if keep])
    blocks, ls, us = [], [], []
    if sel:
        # keep genuinely-free rows at ±inf instead of (±inf − d_k), so the
        # solver's free-row detection (|bound| ≥ 1e20) still fires
        big = 1e19
        Gs_b, ds_b = Gs[:, :, sel, :], ds[:, :, sel]
        Xlo_b, Xhi_b = Xlo[:, :, sel], Xhi[:, :, sel]
        blocks.append(Gs_b.reshape(Bsz, N * len(sel), nu))
        ls.append(torch.where(Xlo_b <= -big, Xlo_b, Xlo_b - ds_b).reshape(Bsz, -1))
        us.append(torch.where(Xhi_b >= big, Xhi_b, Xhi_b - ds_b).reshape(Bsz, -1))
    blocks.append(torch.eye(nu, dtype=dtype, device=dev).expand(Bsz, nu, nu))
    ls.append(Ulo)
    us.append(Uhi)

    data = QPData(
        P=P, q=q,
        A=torch.cat(blocks, dim=1),
        l=torch.cat(ls, dim=1),
        u=torch.cat(us, dim=1),
    )
    return data, Gs, ds

