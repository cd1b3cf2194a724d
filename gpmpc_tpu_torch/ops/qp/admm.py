"""Batched OSQP-semantics ADMM QP solver in PyTorch (counterpart of
``gpmpc_tpu/ops/qp/admm.py``).

Same operator splitting, knobs and termination rules as the JAX solver,
written batch-first: every QP is one lane of a leading axis B, and the
``vmap``-ed lockstep of the JAX code is the batch dimension itself.

    (P + σI + AᵀRA) x̃ᵏ⁺¹ = σxᵏ − q + Aᵀ(R zᵏ − yᵏ)
    z̃ᵏ⁺¹ = A x̃ᵏ⁺¹
    xᵏ⁺¹  = α x̃ᵏ⁺¹ + (1−α) xᵏ
    zᵏ⁺¹  = Π_[l,u]( α z̃ᵏ⁺¹ + (1−α) zᵏ + R⁻¹ yᵏ )
    yᵏ⁺¹  = yᵏ + R( α z̃ᵏ⁺¹ + (1−α) zᵏ − zᵏ⁺¹ )

The KKT solve uses an explicit Cholesky-based inverse of the reduced (n×n)
matrix so each iteration is three batched matvecs. The iterations of one
check interval (a "chunk") run either through the hand-written chunk kernel
(``use_pallas`` "on"/"auto"/"lanes": the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor) or as the streamed, structure-compacted loop
(``use_pallas="off"``). Converged lanes are frozen; the chunk loop stops once
every lane is done.

Not in this slice (each raises ``NotImplementedError``): ``polish``,
``infeas_certs=True``, ``kkt_inv0`` (warm KKT / Newton–Schulz refresh),
``matvec_dtype="bf16"`` and the ``blt`` / ``blockdiag`` /
``blockdiag_shared`` row-structure segments.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
from torch.profiler import record_function

from ..kernels import admm_chunk as chunk_kernel
from .ruiz import Scaling, ruiz_equilibrate
from .types import MAX_ITER, SOLVED, QPData, QPSolution

_RHO_MIN = 1e-6
_RHO_MAX = 1e6
_INF = 1e20  # treat |bound| above this as infinite

_KERNEL_MODES = ("on", "auto", "lanes", "lanes_interpret")


@dataclass(frozen=True)
class ADMMConfig:
    """Solver settings; field names and defaults are those of the JAX
    ``ADMMConfig`` (see there for the meaning of each). Fields that only
    tune features outside this slice are left out; the switches of those
    features stay, so that turning one on raises."""

    max_iter: int = 250
    check_interval: int = 25
    early_exit: bool = True
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    adaptive_rho: bool = True
    rho_adapt_chunks: int = 4
    scaling: int = 10
    polish: bool = False
    # "off": streamed structure-compacted loop; "on"/"auto"/"lanes"/
    # "lanes_interpret": the chunk kernel (CUDA kernel on a CUDA tensor, its
    # plain version on a CPU tensor) — one kernel serves all four names
    use_pallas: str = "auto"
    row_structure: Optional[tuple] = None
    infeas_certs: bool = True
    matvec_dtype: str = "f32"
    tail_f32_iters: int = 0

    def replace(self, **kw) -> "ADMMConfig":
        return replace(self, **kw)


def _check_supported(cfg: ADMMConfig, kkt_inv0) -> None:
    later = "a later slice of the port"
    if cfg.polish:
        raise NotImplementedError(f"ADMM polish is not ported yet ({later})")
    if cfg.infeas_certs:
        raise NotImplementedError(
            "infeasibility certificates (infeas_certs=True) are not ported "
            f"yet ({later}); real-time configs set infeas_certs=False")
    if kkt_inv0 is not None:
        raise NotImplementedError(
            f"warm KKT (kkt_inv0, Newton–Schulz refresh) is not ported yet ({later})")
    if cfg.matvec_dtype != "f32" or cfg.tail_f32_iters:
        raise NotImplementedError(
            f"matvec_dtype={cfg.matvec_dtype!r} / tail_f32_iters is not "
            f"ported ({later}); only f32 matvecs")
    if cfg.use_pallas not in _KERNEL_MODES + ("off",):
        raise ValueError(f"unknown use_pallas={cfg.use_pallas!r}")


def _compact_structure(A: torch.Tensor, segs: tuple) -> tuple:
    """Compact per-segment operands of the batched (scaled) A (B,m,n), in
    row order; rows past the declared segments form a trailing dense one."""
    m = A.shape[1]
    ops = []
    r0 = 0
    for seg in segs:
        kind = seg[0]
        if kind == "dense":
            ops.append(("dense", A[:, r0 : r0 + seg[1]]))
            r0 += seg[1]
        elif kind == "diag":
            nr = seg[1]
            ops.append(("diag", torch.diagonal(A[:, r0 : r0 + nr, :nr], dim1=1, dim2=2)))
            r0 += nr
        elif kind in ("blt", "blockdiag", "blockdiag_shared"):
            raise NotImplementedError(
                f"row-structure segment {kind!r} is not ported yet (it arrives "
                "with the 6-DoF slice); only 'dense' and 'diag'")
        else:
            raise ValueError(f"unknown row-structure segment {kind!r}")
    if r0 > m:
        raise ValueError("row structure exceeds A's rows")
    if r0 < m:
        ops.append(("dense", A[:, r0:]))
    return tuple(ops)


def _make_A_ops(ops: tuple, n: int):
    """(A_apply, AT_apply) on batched vectors from compacted structure ops."""

    def A_apply(v):
        outs = []
        for kind, M in ops:
            if kind == "dense":
                outs.append(torch.bmm(M, v[:, :, None])[:, :, 0])
            else:  # diag
                outs.append(M * v[:, : M.shape[1]])
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def AT_apply(t):
        out = torch.zeros(t.shape[0], n, dtype=t.dtype, device=t.device)
        r0 = 0
        for kind, M in ops:
            nr = M.shape[1]
            ts = t[:, r0 : r0 + nr]
            if kind == "dense":
                out = out + torch.bmm(M.transpose(1, 2), ts[:, :, None])[:, :, 0]
            else:  # diag
                out = out + torch.nn.functional.pad(M * ts, (0, n - nr))
            r0 += nr
        return out

    return A_apply, AT_apply


def _rho_vec(l: torch.Tensor, u: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Per-row ρ (B,m) from per-lane ρ (B,): equality rows boosted ×1e3,
    free rows dropped to ρ_min."""
    r = rho[:, None].expand_as(l)
    eq = (u - l) <= 1e-9
    free = (l <= -_INF) & (u >= _INF)
    r = torch.where(eq, r * 1e3, r)
    r = torch.where(free, torch.full_like(r, _RHO_MIN), r)
    return r.clamp(_RHO_MIN, _RHO_MAX)


def _factor(P: torch.Tensor, A: torch.Tensor, rho_v: torch.Tensor,
            sigma: float) -> torch.Tensor:
    """Explicit inverse of M = P + σI + Aᵀ diag(ρ) A per lane via a batched
    Cholesky and a triangular solve. A lane whose M is not positive definite
    gets a NaN inverse (as ``jnp.linalg.cholesky`` gives NaN): its solve
    then fails the acceptance test instead of stopping the batch."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    M = P + sigma * eye + (A.transpose(1, 2) * rho_v[:, None, :]) @ A
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Linv.transpose(1, 2) @ Linv


def _amax(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(dim=-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def solve(
    data: QPData,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    config: Optional[ADMMConfig] = None,
    rho0=None,
    fixed_scaling: Optional[Scaling] = None,
    kkt_inv0: Optional[torch.Tensor] = None,
) -> QPSolution:
    """Solve a batch of QPs (one per lane). Warm starts accept *unscaled*
    x0 (B,n) / y0 (B,m) like ``osqp.warm_start``; ``rho0`` (scalar or (B,))
    carries the adapted penalty across successive solves.
    ``fixed_scaling`` reuses a precomputed Ruiz equilibration."""
    cfg = config or ADMMConfig()
    _check_supported(cfg, kkt_inv0)
    dtype, dev = data.P.dtype, data.P.device
    B, n, m = data.batch, data.n, data.m

    # -- scaling ------------------------------------------------------------
    if fixed_scaling is not None:
        scal = fixed_scaling
        D, E, c = scal.D, scal.E, scal.c
        sdata = QPData(
            P=c[:, None, None] * D[:, :, None] * data.P * D[:, None, :],
            q=c[:, None] * D * data.q,
            A=E[:, :, None] * data.A * D[:, None, :],
            l=E * data.l,
            u=E * data.u,
        )
    elif cfg.scaling > 0:
        sdata, scal = ruiz_equilibrate(data, cfg.scaling)
    else:
        sdata = data
        scal = Scaling(
            D=torch.ones(B, n, dtype=dtype, device=dev),
            E=torch.ones(B, m, dtype=dtype, device=dev),
            c=torch.ones(B, dtype=dtype, device=dev),
        )
    P, q, A, l, u = sdata.P, sdata.q, sdata.A, sdata.l, sdata.u
    D, E, c = scal.D, scal.E, scal.c
    Dinv, Einv = 1.0 / D, 1.0 / E

    x = torch.zeros(B, n, dtype=dtype, device=dev) if x0 is None else Dinv * x0
    y = torch.zeros(B, m, dtype=dtype, device=dev) if y0 is None else (c[:, None] / E) * y0
    z = _mv(A, x)

    rho_init = torch.as_tensor(cfg.rho if rho0 is None else rho0, dtype=dtype, device=dev)
    rho = rho_init.expand(B).clone() if rho_init.dim() == 0 else rho_init
    rho_v = _rho_vec(l, u, rho)

    use_kernel = cfg.use_pallas in _KERNEL_MODES
    segs = cfg.row_structure if cfg.row_structure is not None else (("dense", m),)
    A_apply, AT_apply = _make_A_ops(_compact_structure(A, segs), n)
    L = _factor(P, A, rho_v, cfg.sigma)

    q_unsc_norm = _amax(Dinv * q) / c
    AT = A.transpose(1, 2)

    def residuals(x, z, y):
        """Unscaled residuals and their relative normalizers, per lane."""
        Ax = _mv(A, x)
        r_prim = _amax(Einv * (Ax - z))
        Px = _mv(P, x)
        ATy = _mv(AT, y)
        r_dual = _amax(Dinv * (Px + q + ATy)) / c
        prim_norm = torch.maximum(_amax(Einv * Ax), _amax(Einv * z))
        dual_norm = torch.maximum(
            torch.maximum(_amax(Dinv * Px), _amax(Dinv * ATy)) / c, q_unsc_norm)
        return r_prim, r_dual, prim_norm, dual_norm

    def run_chunk(x, z, y, rho_v, L):
        if use_kernel:
            return chunk_kernel.admm_chunk(
                L, A, q, l, u, rho_v, x, z, y,
                iters=cfg.check_interval, sigma=cfg.sigma, alpha=cfg.alpha)
        for _ in range(cfg.check_interval):
            rhs = cfg.sigma * x - q + AT_apply(rho_v * z - y)
            x_t = _mv(L, rhs)
            z_t = A_apply(x_t)
            x_new = cfg.alpha * x_t + (1.0 - cfg.alpha) * x
            z_relax = cfg.alpha * z_t + (1.0 - cfg.alpha) * z
            z_new = torch.minimum(torch.maximum(z_relax + y / rho_v, l), u)
            y = y + rho_v * (z_relax - z_new)
            x, z = x_new, z_new
        return x, z, y

    # the chunk schedule runs n_chunks · check_interval iterations; the
    # guard is two-sided (see the JAX solver): a non-dividing pair would
    # silently truncate the budget, max_iter < check_interval overrun it
    if cfg.max_iter % cfg.check_interval != 0:
        would = max(cfg.max_iter // cfg.check_interval, 1) * cfg.check_interval
        raise ValueError(
            f"max_iter={cfg.max_iter} must be a multiple of "
            f"check_interval={cfg.check_interval} (the chunked schedule "
            f"would run {would} iterations instead)"
        )
    n_chunks = max(cfg.max_iter // cfg.check_interval, 1)

    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    status = torch.full((B,), MAX_ITER, dtype=torch.int32, device=dev)
    r_prim = torch.zeros(B, dtype=dtype, device=dev)
    r_dual = torch.zeros(B, dtype=dtype, device=dev)

    n_adapt = min(cfg.rho_adapt_chunks, n_chunks) if cfg.adaptive_rho else 0
    for k in range(n_chunks):
        allow_refactor = k < n_adapt
        # early exit: stop at the first chunk boundary where every lane is
        # done (frozen lanes are identity updates, so the output is the same
        # as the fixed schedule). The first chunk needs no host sync.
        if cfg.early_exit and not allow_refactor and k > 0 and bool(done.all()):
            break
        with record_function("admm.chunk"):
            x_n, z_n, y_n = run_chunk(x, z, y, rho_v, L)
        keep = ~done
        x = torch.where(keep[:, None], x_n, x)
        z = torch.where(keep[:, None], z_n, z)
        y = torch.where(keep[:, None], y_n, y)
        it = it + torch.where(keep, cfg.check_interval, 0).to(torch.int32)

        with record_function("admm.residuals"):
            rp, rd, prim_norm, dual_norm = residuals(x, z, y)
        # frozen lanes keep the residuals they converged at
        r_prim = torch.where(keep, rp, r_prim)
        r_dual = torch.where(keep, rd, r_dual)
        converged = (rp <= cfg.eps_abs + cfg.eps_rel * prim_norm) & (
            rd <= cfg.eps_abs + cfg.eps_rel * dual_norm)
        status = torch.where(
            done, status,
            torch.where(converged, SOLVED, MAX_ITER).to(torch.int32))
        done = done | converged

        if cfg.adaptive_rho and allow_refactor:
            ratio = torch.sqrt(
                (rp / prim_norm.clamp_min(1e-10))
                / (rd / dual_norm.clamp_min(1e-10)).clamp_min(1e-10)
            )
            rho_new = (rho * ratio.clamp(0.1, 10.0)).clamp(_RHO_MIN, _RHO_MAX)
            upd = (~done) & ((ratio > 5.0) | (ratio < 0.2))
            rho = torch.where(upd, rho_new, rho)
            rho_v_new = _rho_vec(l, u, rho)
            rho_v = torch.where(upd[:, None], rho_v_new, rho_v)
            L = torch.where(upd[:, None, None], _factor(P, A, rho_v_new, cfg.sigma), L)

    # unscale
    x_u = D * x
    y_u = (E * y) / c[:, None]
    z_u = Einv * z
    obj = 0.5 * (x_u * _mv(data.P, x_u)).sum(-1) + (data.q * x_u).sum(-1)
    return QPSolution(
        x=x_u, y=y_u, z=z_u, obj=obj, pri_res=r_prim, dua_res=r_dual,
        iterations=it, status=status, rho=rho,
    )
