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
(``use_pallas="off"``); both take the declared ``row_structure`` with every
segment kind of the JAX solver ("dense", "diag", "blt", "blockdiag",
"blockdiag_shared"). At every chunk boundary the termination test and, with
``infeas_certs``, OSQP's δx/δy infeasibility certificates run per lane; a
lane that is solved or certified infeasible is frozen with its status and
residuals, and the chunk loop stops once every lane is done (the host read
that tests it is the span ``admm.exit_check``; ``TRACE_RECORDS`` counts the
lane-iterations spent on frozen lanes). ``polish`` runs the active-set KKT
polish on the unscaled exit point, per lane with masks instead of per-lane
active sets.

Successive solves can carry the adapted ρ (``rho0``), the Ruiz scaling
(``fixed_scaling``) and the KKT inverse (``kkt_inv0``): the inverse is then
refreshed by ``ns_iters`` Newton–Schulz steps in place of the Cholesky
factorization, each lane keeping the refreshed inverse only where it
lowered ‖MX − I‖ (plain batched matmuls, TF32 off; the chunk kernel takes
the refreshed M⁻¹ like any other).

``matvec_dtype="bf16"`` follows the JAX package's rule for each mode. On
the streamed path (``use_pallas="off"``) every matrix operand but the
"diag" segments and the vector it multiplies are rounded to bf16 and the
products accumulate in f32 (the rounded operands are held as f32, which
computes what a bf16 product with f32 accumulation computes); the KKT
inverse is factored from the materialized rounded operator, and
``tail_f32_iters`` f32 iterations with their own f32 factorization follow
the bulk. On the kernel modes ("on", "auto", "lanes", "lanes_interpret")
the chunk applies the f32 A, so bf16 changes nothing there and
``tail_f32_iters > 0`` with bf16 raises ``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ...utils.graph_segments import eager_call
from ...utils.profiler import profiling, span
from ..kernels import admm_chunk as chunk_kernel
from ..kernels.admm_chunk import compact_structure, make_A_ops
from .ruiz import Scaling, ruiz_equilibrate
from .types import DUAL_INFEASIBLE, MAX_ITER, PRIMAL_INFEASIBLE, SOLVED, QPData, QPSolution

_RHO_MIN = 1e-6
_RHO_MAX = 1e6
_INF = 1e20  # treat |bound| above this as infinite

_KERNEL_MODES = ("on", "auto", "lanes", "lanes_interpret")

# One record a solve while a torch.profiler runs, and none otherwise: the
# lanes B, the chunks run, the check interval, the f32 tail's iterations and
# the per-lane iteration count (the solution's ``iterations``, held by
# reference: no device op, no sync). Over a window, the lane-iterations on
# live lanes are Σ iterations, those launched Σ B·(chunks·interval + tail).
TRACE_RECORDS: list = []


@dataclass(frozen=True)
class ADMMConfig:
    """Solver settings; field names and defaults are those of the JAX
    ``ADMMConfig`` (see there for the meaning of each). Left out:
    ``rho_eq_scale`` (the JAX solver boosts equality rows by a fixed 1e3
    whatever it says) and ``iter_unroll`` (an XLA loop-unrolling knob)."""

    max_iter: int = 250
    check_interval: int = 25
    early_exit: bool = True
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_infeas: float = 1e-6
    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    adaptive_rho: bool = True
    rho_adapt_chunks: int = 4
    scaling: int = 10
    ns_iters: int = 4  # Newton–Schulz refresh steps of a carried KKT inverse
    polish: bool = False
    polish_delta: float = 1e-4
    polish_refine_iters: int = 6
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


def _check_supported(cfg: ADMMConfig) -> None:
    if cfg.use_pallas not in _KERNEL_MODES + ("off",):
        raise ValueError(f"unknown use_pallas={cfg.use_pallas!r}")
    if cfg.matvec_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown matvec_dtype={cfg.matvec_dtype!r}: use 'f32' or 'bf16'")
    if cfg.use_pallas in _KERNEL_MODES and cfg.matvec_dtype == "bf16" and cfg.tail_f32_iters > 0:
        raise ValueError(
            f"tail_f32_iters > 0 cannot run on a kernel path (use_pallas="
            f"{cfg.use_pallas!r} applies the f32 A in the chunk kernel; the bf16 bulk + "
            f"f32 tail split exists on the streamed path only). Set use_pallas='off' "
            f"or tail_f32_iters=0.")


def host_reads(cfg: ADMMConfig) -> bool:
    """Whether :func:`solve` under ``cfg`` reads the device from the host:
    the early-exit test at a chunk boundary past the ρ-adaptation chunks
    (``admm.exit_check``), or the test before the bf16 stream's f32 tail."""
    n_chunks = max(cfg.max_iter // cfg.check_interval, 1)
    n_adapt = min(cfg.rho_adapt_chunks, n_chunks) if cfg.adaptive_rho else 0
    exit_read = cfg.early_exit and n_chunks > max(n_adapt, 1)
    tail_read = (cfg.matvec_dtype == "bf16" and cfg.use_pallas not in _KERNEL_MODES
                 and cfg.tail_f32_iters > 0)
    return exit_read or tail_read


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (round to nearest even), held as f32."""
    return t.to(torch.bfloat16).to(t.dtype)


def _cast_ops(ops: tuple) -> tuple:
    """The compacted operands rounded to bf16; "diag" segments and the
    auxiliary factors of "blockdiag_shared" (its per-stage ratios) stay f32."""
    out = []
    for op in ops:
        if op[0] == "diag":
            out.append(op)
        elif op[0] == "blt":
            out.append(("blt", tuple(_bf16(b) for b in op[1])))
        else:
            out.append((op[0], _bf16(op[1]), *op[2:]))
    return tuple(out)


def _materialize_ops(ops: tuple, n: int) -> torch.Tensor:
    """The dense (B, m, n) operator that the compacted ``ops`` apply, so the
    KKT system is factored from exactly the operator the bf16 stream
    applies (operator/factor consistency is per row: "diag" rows stay f32,
    every other row as rounded)."""
    pad = torch.nn.functional.pad
    rows = []
    for op in ops:
        kind, M = op[0], op[1]
        if kind == "dense":
            rows.append(M)
        elif kind == "diag":
            rows.append(pad(torch.diag_embed(M), (0, n - M.shape[1])))
        elif kind == "blt":
            rows.extend(pad(b, (0, n - b.shape[2])) for b in M)
        else:
            if kind == "blockdiag":
                Bd = M
            else:  # blockdiag_shared: stage k's block r_k · B0 · c_k
                _, B0, r, c = op
                Bd = r[:, :, :, None] * B0[:, None] * c[:, :, None, :]
            Bsz, nb, h, w = Bd.shape
            eye = torch.eye(nb, dtype=Bd.dtype, device=Bd.device)
            rows.append(torch.einsum("bkij,kl->bkilj", Bd, eye).reshape(Bsz, nb * h, nb * w))
    return torch.cat(rows, dim=1)


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
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    return _spd_inverse(P + sigma * eye + (A.transpose(1, 2) * rho_v[:, None, :]) @ A)


def _ns_refresh(P: torch.Tensor, A: torch.Tensor, rho_v: torch.Tensor, sigma: float,
                X0: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Newton–Schulz refresh of every lane's KKT inverse from a previous
    solve's X0: ``iters`` steps of X ← 2X − X M X (quadratic convergence for
    ‖I − M X0‖ < 1), then the monotone acceptance per lane: the refreshed X
    is kept only where it lowered the Frobenius norm of M X − I, else X0
    (a divergent refresh, NaN included, keeps the previous inverse)."""
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    M = P + sigma * eye + (A.transpose(1, 2) * rho_v[:, None, :]) @ A
    X = X0
    for _ in range(iters):
        X = 2.0 * X - X @ (M @ X)
    e0 = torch.linalg.matrix_norm(M @ X0 - eye)
    e1 = torch.linalg.matrix_norm(M @ X - eye)
    return torch.where((e1 < e0)[:, None, None], X, X0)


def _amax(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(dim=-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def _spd_inverse(S: torch.Tensor) -> torch.Tensor:
    """S⁻¹ per lane through a Cholesky factor; NaN where S is not positive
    definite."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Linv.transpose(1, 2) @ Linv


def _polish(data: QPData, x, y, z, cfg: ADMMConfig):
    """Active-set KKT polish (OSQP §5.2) of every lane: guess the active set
    from the ADMM duals, solve the equality-constrained KKT system at fixed
    shape by masking inactive rows to ν_i = 0, and clean f32 error with
    iterative refinement on the δ-regularized system. A lane whose polished
    point is not finite keeps (x, y, z)."""
    P, q, A, l, u = data.P, data.q, data.A, data.l, data.u
    n = data.n
    dtype = P.dtype

    # a bound is active when the slack is smaller than the (signed) dual
    # pushing into it: lower iff z−l < −y, upper iff u−z < y
    eq = (u - l) <= 1e-9
    act_low = ((z - l) < -y) | eq
    act_high = ((u - z) < y) | eq
    active = act_low | act_high
    b = torch.where(act_high & ~act_low, u, l)
    b = torch.where(active, b, torch.zeros_like(b))
    af = active.to(dtype)

    # K = [[P+δI, Aaᵀ], [Aa, −D]], D = diag(1−a) + δ·diag(a), solved through
    # the Schur complement S = P + δI + Aaᵀ D⁻¹ Aa (n×n, SPD)
    delta = cfg.polish_delta
    Aa = af[:, :, None] * A
    AaT = Aa.transpose(1, 2)
    Dinv = 1.0 / (1.0 - af + delta * af)
    eye = torch.eye(n, dtype=dtype, device=P.device)
    Sinv = _spd_inverse(P + delta * eye + (AaT * Dinv[:, None, :]) @ Aa)

    def kkt_solve(r1, r2):
        xs = _mv(Sinv, r1 + _mv(AaT, Dinv * r2))
        return xs, Dinv * (_mv(Aa, xs) - r2)

    x_p, nu_p = kkt_solve(-q, b)
    for _ in range(cfg.polish_refine_iters):
        # residual of the unregularized K₀ = [[P, Aaᵀ], [Aa, −diag(1−a)]]
        r1 = -q - (_mv(P, x_p) + _mv(AaT, nu_p))
        r2 = b - (_mv(Aa, x_p) - (1.0 - af) * nu_p)
        dx, dnu = kkt_solve(r1, r2)
        x_p, nu_p = x_p + dx, nu_p + dnu

    y_p = torch.where(active, nu_p, torch.zeros_like(nu_p))
    z_p = torch.minimum(torch.maximum(_mv(A, x_p), l), u)
    ok = (torch.isfinite(x_p).all(dim=1) & torch.isfinite(nu_p).all(dim=1))[:, None]
    return torch.where(ok, x_p, x), torch.where(ok, y_p, y), torch.where(ok, z_p, z)


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
    ``fixed_scaling`` reuses a precomputed Ruiz equilibration; with it,
    ``kkt_inv0`` (B,n,n), the scaled-space KKT inverse of a previous solve,
    replaces the Cholesky factorization by a Newton–Schulz refresh, and the
    solution's ``kkt_inv`` feeds the next call."""
    cfg = config or ADMMConfig()
    _check_supported(cfg)
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
    ops_f32 = compact_structure(A, segs, E=E, D=D)
    # the kernel modes apply the f32 A, so bf16 streams only on "off"; the
    # factor then comes from the rounded operator (see the module docstring)
    bf16 = cfg.matvec_dtype == "bf16" and not use_kernel
    if bf16:
        ops_stream = _cast_ops(ops_f32)
        A_apply, AT_apply = make_A_ops(ops_stream, n, cast=_bf16)
        A_fact = _materialize_ops(ops_stream, n)
    else:  # the kernel modes apply A inside the chunk: no streamed operator is built
        A_apply, AT_apply = (None, None) if use_kernel else make_A_ops(ops_f32, n)
        A_fact = A
    with span("admm.factor"):
        if kkt_inv0 is not None:
            L = _ns_refresh(P, A_fact, rho_v, cfg.sigma, kkt_inv0, iters=cfg.ns_iters)
        else:
            L = _factor(P, A_fact, rho_v, cfg.sigma)

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

    def certificates(dx_s, dy_s):
        """OSQP's primal / dual infeasibility tests per lane on the unscaled
        δ sequences; with the scaled differences dy_s, dx_s of one check
        interval the unscaled ones are δy = (E/c)·dy_s, Aᵀδy = D⁻¹Āᵀdy_s/c,
        δx = D·dx_s, Pδx = D⁻¹P̄dx_s/c, qᵀδx = q̄·dx_s/c, Aδx = E⁻¹Ādx_s."""
        eps = cfg.eps_infeas
        dy = (E / c[:, None]) * dy_s
        dy_norm = _amax(dy)
        dx_norm = _amax(D * dx_s)
        zero = torch.zeros_like(u)
        uu = torch.where(u >= _INF, zero, Einv * u)
        ll = torch.where(l <= -_INF, zero, Einv * l)
        prim_cert = (
            (dy_norm > 1e-12)
            & (_amax(Dinv * _mv(AT, dy_s)) / c <= eps * dy_norm)
            & (((uu * dy.clamp_min(0.0)).sum(-1) + (ll * dy.clamp_max(0.0)).sum(-1))
               <= eps * dy_norm)
        )
        Adx = Einv * _mv(A, dx_s)
        tol = (eps * dx_norm)[:, None]
        dual_cert = (
            (dx_norm > 1e-12)
            & (_amax(Dinv * _mv(P, dx_s)) / c <= eps * dx_norm)
            & ((q * dx_s).sum(-1) / c <= eps * dx_norm)
            & ((u >= _INF) | (Adx <= tol)).all(dim=-1)
            & ((l <= -_INF) | (Adx >= -tol)).all(dim=-1)
        )
        return prim_cert, dual_cert

    def streamed(x, z, y, rho_v, L_mv, iters, A_apply, AT_apply, cast):
        for _ in range(iters):
            rhs = cfg.sigma * x - q + AT_apply(rho_v * z - y)
            x_t = _mv(L_mv, cast(rhs))
            z_t = A_apply(x_t)
            x_new = cfg.alpha * x_t + (1.0 - cfg.alpha) * x
            z_relax = cfg.alpha * z_t + (1.0 - cfg.alpha) * z
            z_new = torch.minimum(torch.maximum(z_relax + y / rho_v, l), u)
            y = y + rho_v * (z_relax - z_new)
            x, z = x_new, z_new
        return x, z, y

    def run_chunk(x, z, y, rho_v, L):
        if use_kernel:
            # a launch of its own between two segments of a CUDA-graph
            # recording (utils/graph_segments.py), on every replay
            return eager_call(lambda out: chunk_kernel.admm_chunk(
                L, A, q, l, u, rho_v, x, z, y, iters=cfg.check_interval,
                sigma=cfg.sigma, alpha=cfg.alpha, row_structure=segs, E=E, D=D, out=out),
                (x, z, y))
        if bf16:  # the KKT inverse streams rounded too, one cast a chunk
            return streamed(x, z, y, rho_v, _bf16(L), cfg.check_interval,
                            A_apply, AT_apply, _bf16)
        return streamed(x, z, y, rho_v, L, cfg.check_interval, A_apply, AT_apply,
                        lambda t: t)

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
    chunks = 0
    for k in range(n_chunks):
        allow_refactor = k < n_adapt
        # early exit: stop at the first chunk boundary where every lane is
        # done (frozen lanes are identity updates, so the output is the same
        # as the fixed schedule). The first chunk needs no host sync.
        if cfg.early_exit and not allow_refactor and k > 0:
            with span("admm.exit_check"):
                all_done = bool(done.all())
            if all_done:
                break
        x_prev, y_prev = x, y
        with span("admm.chunk"):
            x_n, z_n, y_n = run_chunk(x, z, y, rho_v, L)
        chunks += 1
        # freeze converged / infeasible lanes
        keep = ~done
        x = torch.where(keep[:, None], x_n, x)
        z = torch.where(keep[:, None], z_n, z)
        y = torch.where(keep[:, None], y_n, y)
        it = it + torch.where(keep, cfg.check_interval, 0).to(torch.int32)

        with span("admm.residuals"):
            rp, rd, prim_norm, dual_norm = residuals(x, z, y)
            converged = (rp <= cfg.eps_abs + cfg.eps_rel * prim_norm) & (
                rd <= cfg.eps_abs + cfg.eps_rel * dual_norm)
            code = torch.where(converged, SOLVED, MAX_ITER)
            if cfg.infeas_certs:
                prim_cert, dual_cert = certificates(x - x_prev, y - y_prev)
                code = torch.where(
                    converged, code,
                    torch.where(prim_cert, PRIMAL_INFEASIBLE,
                                torch.where(dual_cert, DUAL_INFEASIBLE, code)))
                converged = converged | prim_cert | dual_cert
        # frozen lanes keep their status and the residuals they stopped at
        r_prim = torch.where(keep, rp, r_prim)
        r_dual = torch.where(keep, rd, r_dual)
        status = torch.where(done, status, code.to(torch.int32))
        done = done | converged

        if cfg.adaptive_rho and allow_refactor:
            with span("admm.rho_update"):
                ratio = torch.sqrt(
                    (rp / prim_norm.clamp_min(1e-10))
                    / (rd / dual_norm.clamp_min(1e-10)).clamp_min(1e-10)
                )
                rho_new = (rho * ratio.clamp(0.1, 10.0)).clamp(_RHO_MIN, _RHO_MAX)
                upd = (~done) & ((ratio > 5.0) | (ratio < 0.2))
                rho = torch.where(upd, rho_new, rho)
                rho_v_new = _rho_vec(l, u, rho)
                rho_v = torch.where(upd[:, None], rho_v_new, rho_v)
                L = torch.where(upd[:, None, None], _factor(P, A_fact, rho_v_new, cfg.sigma),
                                L)

    tail = 0
    if bf16 and cfg.tail_f32_iters > 0:
        with span("admm.exit_check"):
            tail = 0 if bool(done.all()) else cfg.tail_f32_iters
    if tail:
        # the f32 tail: re-converge toward the f32 fixed point from the bf16
        # iterate with the f32 operands and their own factorization from the
        # true A; lanes already done stay frozen. A batch that is all done
        # skips it, as the JAX while_loop does
        x_t, z_t, y_t = streamed(x, z, y, rho_v, _factor(P, A, rho_v, cfg.sigma),
                                 cfg.tail_f32_iters, *make_A_ops(ops_f32, n), lambda t: t)
        keep = ~done
        x = torch.where(keep[:, None], x_t, x)
        z = torch.where(keep[:, None], z_t, z)
        y = torch.where(keep[:, None], y_t, y)
        it = it + torch.where(keep, cfg.tail_f32_iters, 0).to(torch.int32)
        rp, rd, prim_norm, dual_norm = residuals(x, z, y)
        r_prim = torch.where(keep, rp, r_prim)
        r_dual = torch.where(keep, rd, r_dual)
        tail_ok = (rp <= cfg.eps_abs + cfg.eps_rel * prim_norm) & (
            rd <= cfg.eps_abs + cfg.eps_rel * dual_norm)
        status = torch.where(keep & tail_ok, torch.full_like(status, SOLVED), status)
    if profiling():
        TRACE_RECORDS.append({"lanes": B, "chunks": chunks, "interval": cfg.check_interval,
                              "tail": tail, "iterations": it})

    # unscale
    x_u = D * x
    y_u = (E * y) / c[:, None]
    z_u = Einv * z

    if cfg.polish:
        with span("admm.polish"):
            x_u, y_u, z_u, r_prim, r_dual, status = _accept_polish(
                data, cfg, x_u, y_u, z_u, r_prim, r_dual, status)
    obj = 0.5 * (x_u * _mv(data.P, x_u)).sum(-1) + (data.q * x_u).sum(-1)
    return QPSolution(
        x=x_u, y=y_u, z=z_u, obj=obj, pri_res=r_prim, dua_res=r_dual,
        iterations=it, status=status, rho=rho,
        kkt_inv=L if kkt_inv0 is not None else None,
    )


def solve_jit(data: QPData, x0=None, y0=None, config: Optional[ADMMConfig] = None,
              rho0=None) -> QPSolution:
    """The same solve as :func:`solve` (the JAX package's is its ``jax.jit``).
    The port has no tracing compiler on this path: the call runs eagerly,
    its chunks through the hand-written kernel on a CUDA tensor."""
    return solve(data, x0, y0, config, rho0)


def solve_batch(data: QPData, x0: Optional[torch.Tensor] = None,
                y0: Optional[torch.Tensor] = None, config: Optional[ADMMConfig] = None,
                rho0: Optional[torch.Tensor] = None) -> QPSolution:
    """Solve a batch of QPs stacked on the leading axis: the default warm
    starts are zeros and ``config.rho`` on every lane, as the JAX function
    fills them, and :func:`solve` (lanes first already) does the rest."""
    cfg = config or ADMMConfig()
    if x0 is None:
        x0 = torch.zeros_like(data.q)
    if y0 is None:
        y0 = torch.zeros_like(data.l)
    if rho0 is None:
        rho0 = torch.full((data.batch,), cfg.rho, dtype=data.l.dtype, device=data.l.device)
    return solve(data, x0, y0, cfg, rho0)


def _accept_polish(data: QPData, cfg: ADMMConfig, x_u, y_u, z_u, r_prim, r_dual, status):
    """Polish every lane and keep the polished point where it lowers the KKT
    error; a lane at MAX_ITER whose polished point passes the termination
    test becomes SOLVED (OSQP reports ``solved`` likewise)."""
    P, q, A, l, u = data.P, data.q, data.A, data.l, data.u
    AT = A.transpose(1, 2)
    x_p, y_p, z_p = _polish(data, x_u, y_u, z_u, cfg)

    def kkt_err(xx, yy, zz):
        Ax = _mv(A, xx)
        r1 = _amax(Ax - zz)
        r2 = _amax(_mv(P, xx) + q + _mv(AT, yy))
        viol = torch.maximum((Ax - u).clamp_min(0.0).amax(dim=-1),
                             (l - Ax).clamp_min(0.0).amax(dim=-1))
        return torch.maximum(torch.maximum(r1, r2), viol)

    better = kkt_err(x_p, y_p, z_p) < kkt_err(x_u, y_u, z_u)
    x_u = torch.where(better[:, None], x_p, x_u)
    y_u = torch.where(better[:, None], y_p, y_u)
    z_u = torch.where(better[:, None], z_p, z_u)
    Ax, Px, ATy = _mv(A, x_u), _mv(P, x_u), _mv(AT, y_u)
    r_prim = torch.where(better, _amax(Ax - z_u), r_prim)
    r_dual = torch.where(better, _amax(Px + q + ATy), r_dual)
    pn = torch.maximum(_amax(Ax), _amax(z_u))
    dn = torch.maximum(torch.maximum(_amax(Px), _amax(ATy)), _amax(q))
    now_ok = (r_prim <= cfg.eps_abs + cfg.eps_rel * pn) & (
        r_dual <= cfg.eps_abs + cfg.eps_rel * dn)
    status = torch.where((status == MAX_ITER) & now_ok,
                         torch.full_like(status, SOLVED), status)
    return x_u, y_u, z_u, r_prim, r_dual, status
