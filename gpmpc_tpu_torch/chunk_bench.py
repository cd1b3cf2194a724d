"""Measurements of the ADMM chunk kernel on the card, and its tile sweep.

``chip_smoke.py`` times the kernel with these helpers. Run alone, the module
sweeps the kernel's tilings through ``csrc/admm_chunk_tiles.cu``, a build of
the same kernels that takes the tiling per call:

- ``register``: the register variant's threads per row (K, fixed at 2 in
  ``csrc/admm_chunk.cu``), K = 1, 2 and 4, at the main-path shape (512 lanes,
  n = m = 60, every row declared diagonal, 50 iterations) and at the dense
  60×60 shape, beside the time of a chunk of 0 iterations (launch, operand
  loads, stores);
- ``cluster``: the cluster variant's CTAs a lane (C = 4, 8, 16), threads a
  CTA (T = 256, 512) and threads per row dot product (K = 8, 16) at the
  sparse-form golden shape (n = 207, m = 354, 25 iterations), 4 and 512 lanes;
- ``shared``: the shared variant's T = 128, 256, 512 and K = 4, 8, 16 at the
  condensed QP with state bounds (n = 60, m = 200) at 25, 30 and 50
  iterations and at the 6-DoF QP with cone facets (n = 60, m = 380) at 30.

- ``stages``: what the stages of the shared and cluster variants cost, by
  leaving them out one at a time (``csrc/admm_chunk_probe.cu``, a build with
  the kernel's stage probe on): the column walk for Aᵀt, the M⁻¹ dot
  products, the row dot products, the row updates, the cluster's remote sum
  and its cluster barriers, at the bounded, facets and golden shapes.

Each tiling row reports the registers and spills ``ptxas`` gives the instance, the
agreement with the plain version and the device time from a CUDA-graph replay:

    python -m gpmpc_tpu_torch.chunk_bench [--sweep register cluster shared stages] [--out FILE.json]

Needs a Hopper card; there is no CPU path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

# published H100 SXM peaks: HBM bandwidth and non-tensor-core f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BATCH, N_VARS, ITERS = 512, 60, 50
SHAPES = (("main", (("diag", N_VARS),)), ("dense", None))
KERNEL_ARGS = dict(iters=ITERS, sigma=1e-6, alpha=1.6)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps, replays=10):
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph and replayed, so that the host's enqueue cost is out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, replays) / reps


def host_us(fn, reps):
    """Host time of one ``fn`` call, the device left to run behind it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


BOUNDED_SEGS = (("blt", 5, 28, 12), ("diag", N_VARS))  # 140 state-bound rows, then controls
# the 6-DoF condensed QP at N = 20 with 8 cone facets and the linearized
# glideslope row, translation bounds dropped: 7 × 20 state-bound rows, the
# controls, 20 glideslope rows, 20 blocks of 8 cone rows on a stage's 3 controls
FACETS_SEGS = BOUNDED_SEGS + (("blt", 5, 4, 12), ("blockdiag", 20, 8, 3))
# Path F's 6-DoF QP (condensed, N = 15, every state bound kept): 14 × 15
# state-bound rows, then the 45 control rows
FLEET6_SEGS = (("blt", 5, 42, 9), ("diag", 45))
# the fleet-LMPC ADMM arm's condensed hull QP (N = 15, every state bound
# kept): 7 × 15 state-bound rows, the 45 control rows, then 18 dense hull rows
# (7 terminal equalities, Σλ, 10 λ bounds) past the declared segments
LMPC_SEGS = (("blt", 5, 21, 9), ("diag", 45))


def _structured_rows(segs, B, n, gen, dev):
    """Random A (B,m,n) with the declared segments' zero pattern; a "diag"
    segment is the identity, as build_condensed_qp makes the control rows."""
    cols = torch.arange(n, device=dev)[None, :]
    blocks = []
    for seg in segs:
        if seg[0] == "diag":
            blocks.append(torch.eye(seg[1], n, device=dev).expand(B, seg[1], n))
            continue
        _, C, h, w = seg
        block = torch.arange(C * h, device=dev)[:, None] // h
        keep = cols < (block + 1) * w
        if seg[0] == "blockdiag":
            keep = keep & (cols >= block * w)
        blocks.append(torch.randn(B, C * h, n, generator=gen, device=dev) * keep)
    return torch.cat(blocks, dim=1)


def sixdof_qp(kind, lanes, gen, dev):
    """The first-cycle QP of a 6-DoF path at its real data, ``lanes`` lanes:
    "sixdof", Path D's condensed QP (``main_path.sixdof_path``: n = 60,
    m = 200, translation bounds elided, rows BOUNDED_SEGS) for a fleet at
    15 ± 2 m; "sparse6dof", the sparse-form QP of the 6-DoF pretraining
    episodes (``rti_config_6dof(N=15)``: n = 269, m = 224 equality rows then
    269 bound rows, every row dense) for initial states drawn as
    ``collect_residuals_6dof`` draws them. The linearization trajectory is
    the re-anchored rollout of hover thrust, as the controllers' first cycle
    makes it."""
    from .dynamics import trajectory_jacobians
    from .main_path import sixdof_fleet_x0, sixdof_path
    from .mpc import rti_config_6dof, rti_init
    from .mpc.rti import _build_rti_qp, _rollout
    from .ops.qp import build_condensed_qp

    sp = sixdof_path(dev)
    if kind == "sixdof":
        cfg = sp.config.base
        x0s = sixdof_fleet_x0(gen, lanes, dev)
    else:
        cfg = rti_config_6dof(sp.params, N=15)
        u = torch.rand(lanes, 3, generator=gen, device=dev)
        x0s = sp.x_target.repeat(lanes, 1)
        x0s[:, 1] = 17.0 + 6.0 * u[:, 0]
        x0s[:, 4] = -3.5 + 1.5 * u[:, 1]
        x0s[:, 5] = 0.6 * (u[:, 2] - 0.5)
    st = rti_init(cfg, x0s, sp.x_target)
    X = _rollout(sp.F, x0s, st.U_lin)
    Aks, Bks, cks = trajectory_jacobians(sp.F, X, st.U_lin)
    if kind == "sparse6dof":
        return _build_rti_qp(cfg, Aks, Bks, cks, x0s, st.x_ref)
    ref = sp.reference_fn(x0s)[:, :cfg.N + 1]
    return build_condensed_qp(Aks, Bks, cks, x0s, cfg.Q, cfg.R, cfg.Qf, ref, cfg.x_min,
                              cfg.x_max, cfg.u_min, cfg.u_max,
                              x_bound_mask=cfg.x_bound_mask)[0]


def fleet_qp(kind, lanes, gen, dev):
    """The first-cycle QP of Path F's controllers at their real data,
    ``lanes`` lanes of ``main_path.fleet_learning_x0``: "fleet3dof", the sparse form of
    ``RTIConfig()`` (n = 157, m = 269, every row dense); "fleet6dof", the
    condensed ``rti_config_6dof(N=15)`` (n = 45, m = 255, FLEET6_SEGS). The
    linearization trajectory is the rollout of hover thrust, the bounds are
    the box ∩ the trust region, the reference the fleet's cubic descent."""
    from .dynamics import trajectory_jacobians
    from .main_path import fleet_learning_path, fleet_learning_x0
    from .mpc import gp_mpc_init
    from .mpc.rti import _rollout
    from .ops.qp import build_condensed_qp, build_mpc_qp
    from .reference import cubic_descent_reference

    model = kind[len("fleet"):]
    fp = fleet_learning_path(model, dev)
    cfg, F, xT = fp.mpc.base, fp.F, fp.x_target
    x0s = fleet_learning_x0(model, gen, lanes, dev)
    st = gp_mpc_init(fp.mpc, x0s, xT, device=dev)
    X = _rollout(F, x0s, st.U_lin)
    Aks, Bks, cks = trajectory_jacobians(F, X, st.U_lin)
    ref = cubic_descent_reference(x0s, xT, fp.config.max_steps - 10, cfg.dt)[:, :cfg.N + 1]
    tx, tu = fp.mpc.trust_region_x, fp.mpc.trust_region_u
    bounds = (torch.maximum(cfg.x_min, X - tx), torch.minimum(cfg.x_max, X + tx),
              torch.maximum(cfg.u_min, st.U_lin - tu), torch.minimum(cfg.u_max, st.U_lin + tu))
    if cfg.condensed:
        return build_condensed_qp(Aks, Bks, cks, x0s, cfg.Q, cfg.R, cfg.Qf, ref, *bounds,
                                  x_bound_mask=cfg.x_bound_mask)[0]
    return build_mpc_qp(Aks, Bks, cks, x0s, cfg.Q, cfg.R, cfg.Qf, ref, *bounds)


def chunk_inputs(kind, gen, golden_path=None, lanes=8):
    """Chunk operands on the card: (Minv, A, q, l, u, rho_v, x, z, y).
    "main": 512 lanes (or ``lanes`` where that is more; so for "dense",
    "bounded" and "facets"), n = m = 60, A the identity control-bound rows as
    build_condensed_qp makes them; "dense": the same size with a random A;
    "bounded": n = 60, m = 200, the condensed QP that keeps its state-bound
    rows: 140 block-lower-triangular rows (BOUNDED_SEGS), then the identity;
    "facets": n = 60, m = 380, the same with 20 glideslope and 160 cone-facet
    rows behind the identity (FACETS_SEGS);
    "golden": ``lanes`` sparse-form golden QPs (n = 207, m = 354), the four of
    ``golden_path`` repeated; "sixdof" and "sparse6dof": ``lanes`` lanes of
    the 6-DoF paths' QPs (:func:`sixdof_qp`); "fleet3dof" and "fleet6dof":
    ``lanes`` lanes of Path F's QPs (:func:`fleet_qp`); "lmpc": ``lanes``
    lanes of the fleet-LMPC hull QP (:func:`lmpc_qp`), "lmpc_rows" a random
    QP with its rows' structure (n = 62, LMPC_SEGS and 18 dense rows);
    "hull": ``lanes`` lanes of the hull projection QP (:func:`hull_qp`);
    "filter": ``lanes`` lanes of the safety filter's intervention QP
    (:func:`filter_qp`); "suite_gp" and "suite_rti": the experiment suite's
    two MPC QPs (:func:`suite_qp`); "scvx": the SCVX library's first
    subproblem (:func:`scvx_library_qp`)."""
    from .ops.qp import QPData, ruiz_equilibrate
    from .ops.qp.admm import _factor, _rho_vec

    dev = gen.device
    if kind in ("sixdof", "sparse6dof"):
        data = sixdof_qp(kind, lanes, gen, dev)
    elif kind in ("fleet3dof", "fleet6dof"):
        data = fleet_qp(kind, lanes, gen, dev)
    elif kind == "filter":
        data = filter_qp(lanes, gen, dev)
    elif kind in ("suite_gp", "suite_rti"):
        data = suite_qp(kind, lanes, dev)
    elif kind == "scvx":
        data = scvx_library_qp(lanes, dev)
    elif kind in ("lmpc", "hull"):
        data = lmpc_qp(lanes, gen, dev) if kind == "lmpc" else hull_qp(lanes, gen, dev)
    elif kind == "lmpc_rows":
        n = 62
        A = torch.cat([_structured_rows(LMPC_SEGS, lanes, n, gen, dev),
                       torch.randn(lanes, 18, n, generator=gen, device=dev)], dim=1)
        G = torch.randn(lanes, n, n, generator=gen, device=dev)
        m = A.shape[1]
        data = QPData(P=G @ G.transpose(1, 2) / n + 0.1 * torch.eye(n, device=dev),
                      q=torch.randn(lanes, n, generator=gen, device=dev), A=A,
                      l=-torch.rand(lanes, m, generator=gen, device=dev) - 0.5,
                      u=torch.rand(lanes, m, generator=gen, device=dev) + 0.5)
    elif kind == "golden":
        fx = np.load(golden_path)
        names = (("canonical", "high_fast", "low_slow", "lateral") * ((lanes + 3) // 4))[:lanes]
        stack = lambda p: torch.tensor(np.stack([fx[f"{s}/{p}"] for s in names]),
                                       dtype=torch.float32, device=dev)
        data = QPData(*[stack(p) for p in ("P", "q", "A", "l", "u")])
    else:
        B, n = max(lanes, BATCH), N_VARS
        G = torch.randn(B, n, n, generator=gen, device=dev)
        P = G @ G.transpose(1, 2) / n + 0.1 * torch.eye(n, device=dev)
        if kind == "main":
            A = torch.eye(n, device=dev).expand(B, n, n).contiguous()
        elif kind in ("bounded", "facets"):
            A = _structured_rows(BOUNDED_SEGS if kind == "bounded" else FACETS_SEGS,
                                 B, n, gen, dev)
        else:
            A = torch.randn(B, n, n, generator=gen, device=dev)
        m = A.shape[1]
        lo = -torch.rand(B, m, generator=gen, device=dev) - 0.5
        hi = torch.rand(B, m, generator=gen, device=dev) + 0.5
        q = torch.randn(B, n, generator=gen, device=dev)
        data = QPData(P=P, q=q, A=A, l=lo, u=hi)
    sdata, _ = ruiz_equilibrate(data, 2)
    B, m, n = sdata.A.shape
    rho_v = _rho_vec(sdata.l, sdata.u, torch.full((B,), 0.1, device=dev))
    Minv = _factor(sdata.P, sdata.A, rho_v, 1e-6)
    x = 0.1 * torch.randn(B, n, generator=gen, device=dev)
    z = torch.bmm(sdata.A, x[:, :, None])[:, :, 0]
    y = 0.01 * torch.randn(B, m, generator=gen, device=dev)
    return (Minv, sdata.A.contiguous(), sdata.q, sdata.l, sdata.u, rho_v, x, z, y)


def bmm_chain_graph(args, iters, row_structure):
    """The chunk as a chain of cuBLAS batched products (elementwise products
    for the declared diagonal rows), captured once in a CUDA graph and
    replayed — the library yardstick (never used by the port)."""
    from .ops.kernels import admm_chunk as K

    Minv, A, q, l, u, rho, x, z, y = [a.clone() for a in args]
    segs = row_structure if row_structure is not None else (("dense", A.shape[1]),)
    A_apply, AT_apply = K.make_A_ops(K.compact_structure(A, segs), A.shape[2])
    inv_rho = 1.0 / rho
    bufs = [x, z, y]

    def chain():
        xx, zz, yy = bufs
        for _ in range(iters):
            rhs = 1e-6 * xx - q + AT_apply(rho * zz - yy)
            xt = torch.bmm(Minv, rhs[:, :, None])[:, :, 0]
            zt = A_apply(xt)
            xn = 1.6 * xt - 0.6 * xx
            zr = 1.6 * zt - 0.6 * zz
            zn = torch.clamp(zr + yy * inv_rho, l, u)
            yy = yy + rho * (zr - zn)
            xx, zz = xn, zn
        return xx, zz, yy

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()  # warm cuBLAS handles before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    return graph.replay


def bound_ms(args, iters, row_structure):
    """Least time for the chunk on this card: max(bytes / HBM rate, flops /
    f32 rate) over the operands the kernel reads — M⁻¹, A's dense rows, the
    diagonal of its declared diagonal rows, seven vectors — each read once,
    and three vectors written once; the matvec work counts the nonzeros of
    the dense rows in this run's data and one per diagonal row."""
    from .ops.kernels import admm_chunk as K

    Minv, A = args[0], args[1]
    B, m, n = A.shape
    Ak, d0, mg = K.kernel_rows(A, row_structure)
    nnz_dense = sum(int((rows != 0).sum().item()) for rows in (Ak[:, :d0], Ak[:, d0 + mg:]))
    nnz_a = nnz_dense + B * mg
    n_in = Minv.numel() + B * (m - mg) * n + sum(t.numel() for t in args[2:])
    bytes_moved = 4 * (n_in + B * mg + B * (n + 2 * m))
    flops = iters * (2 * (B * n * n + 2 * nnz_a) + B * (11 * m + 5 * n))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_moved, flops)


def kernel_entry(variant, n, m, mg, row_threads=None, threads=None):
    """A pattern of the mangled name of the kernel instance a chunk launches
    (the register tile with any threads per row when ``row_threads`` is None;
    the row-split kernel with the port's threads a CTA when ``threads`` is)."""
    from .ops.kernels.admm_chunk import ROWS_THREADS

    md = m - mg
    k = r"\d+" if row_threads is None else str(row_threads)
    t = ROWS_THREADS if threads is None else threads
    return {
        "register": (f"admm_chunk_regILi{32 if n <= 32 and md <= 32 else 64}"
                     f"ELi{k}ELb{int(md > 0)}E"),
        "shared": f"admm_chunk_rowsILi{t}ELb{int(n <= 64)}ELb0E",  # M⁻¹ in registers, n ≤ 64
        "cluster": f"admm_chunk_rowsILi{t}ELb0ELb1E",
        "global": "admm_chunk_global",
    }[variant]


def ptxas_report(build_log, entry):
    """(registers, spill stores, spill loads) that ``-Xptxas -v`` reported
    for the kernel instance whose mangled name matches ``entry``."""
    lines = build_log.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if "Compiling entry" in ln and re.search(entry, ln))
    block = " ".join(lines[at:at + 4])
    num = lambda key: int(block.split(key)[0].split()[-1])
    return num(" registers"), num(" bytes spill stores"), num(" bytes spill loads")


TILES = "admm_chunk_tiles"


def tile_chunk(lib, row_threads, args, row_structure, iters=ITERS):
    """One chunk through the sweep's build with ``row_threads`` threads per
    row of the register tile; returns (x, z, y)."""
    from .ops.kernels import admm_chunk as K

    Minv, A, *vecs = args
    A, d0, mg = K.kernel_rows(A, row_structure)
    B, m, n = A.shape
    outs = [torch.empty(B, k, device=A.device) for k in (n, m, m)]
    err = lib.admm_chunk_tile_f32(
        *[t.data_ptr() for t in (Minv, A, *vecs, *outs)], B, n, m, d0, mg, iters,
        KERNEL_ARGS["sigma"], KERNEL_ARGS["alpha"], row_threads, A.device.index,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"admm_chunk_tile_f32 failed: CUDA error {err}")
    return outs


def rows_chunk(lib, threads, row_threads, cluster, args, row_structure, iters):
    """One chunk through the sweep's build of the row-split kernel with
    ``threads`` a CTA, ``row_threads`` a row dot product and ``cluster`` CTAs
    a lane (1: the shared variant); returns (x, z, y)."""
    from .ops.kernels import admm_chunk as K

    Minv, A, *vecs = args
    A, d0, mg = K.kernel_rows(A, row_structure)
    B, m, n = A.shape
    outs = [torch.empty(B, k, device=A.device) for k in (n, m, m)]
    err = lib.admm_chunk_rows_f32(
        *[t.data_ptr() for t in (Minv, A, *vecs, *outs)], B, n, m, d0, mg, iters,
        KERNEL_ARGS["sigma"], KERNEL_ARGS["alpha"], threads, row_threads, cluster,
        A.device.index, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"admm_chunk_rows_f32 failed: CUDA error {err} (B={B}, n={n}, "
                           f"m={m}, T={threads}, K={row_threads}, C={cluster})")
    return outs


def _tiles_library():
    from .ops.kernels import _build

    lib = _build.load(TILES)
    if lib.admm_chunk_tile_f32.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.admm_chunk_tile_f32.argtypes = [p] * 12 + [i] * 6 + [f, f, i, i, p]
        lib.admm_chunk_tile_f32.restype = i
        lib.admm_chunk_rows_f32.argtypes = [p] * 12 + [i] * 6 + [f, f, i, i, i, i, p]
        lib.admm_chunk_rows_f32.restype = i
    return lib


def sweep_rows(which, golden_path):
    """The row-split kernel's tilings: "cluster" at the golden shape, 4 and
    512 lanes; "shared" at the bounded shape (25, 30, 50 iterations) and the
    facets shape (30, the 6-DoF bench's chunk)."""
    from .ops.kernels import _build
    from .ops.kernels import admm_chunk as K

    lib = _tiles_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if which == "cluster":
        cases = [("golden", lanes, None, 25) for lanes in (4, BATCH)]
        tilings = [(t, k, c) for c in (4, 8, 16) for t in (256, 512) for k in (8, 16)]
    else:
        cases = [("bounded", BATCH, BOUNDED_SEGS, it) for it in (25, 30, 50)]
        cases.append(("facets", BATCH, FACETS_SEGS, 30))
        tilings = [(t, k, 1) for t in (128, 256, 512) for k in (4, 8, 16)]
    rows, inputs = [], {}
    for kind, lanes, segs, iters in cases:
        if (kind, lanes) not in inputs:
            inputs[kind, lanes] = chunk_inputs(kind, gen, golden_path, lanes)
        args = inputs[kind, lanes]
        B, m, n = args[1].shape
        mg = K.kernel_rows(args[1], segs)[2]
        ref = K.admm_chunk_plain(*args, row_structure=segs, **{**KERNEL_ARGS, "iters": iters})
        scale = [max(1.0, r.abs().max().item()) for r in ref]
        reps = 20 if B * n * m < 1e7 else 4
        for t, k, c in tilings:
            regs, st, ld = ptxas_report(
                _build.build_log(TILES),
                kernel_entry("shared" if c == 1 else "cluster", n, m, mg, threads=t))
            run = lambda: rows_chunk(lib, t, k, c, args, segs, iters)
            out = run()
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() / s for a, b, s in zip(out, ref, scale))
            rows.append(dict(sweep=which, shape=kind, lanes=B, n=n, m=m, iters=iters,
                             threads=t, row_threads=k, cluster=c, registers=regs,
                             spill_stores=st, spill_loads=ld, max_rel_err=err,
                             ms=graph_ms(run, reps), ms_repeat=graph_ms(run, reps),
                             ms_0_iters=graph_ms(
                                 lambda: rows_chunk(lib, t, k, c, args, segs, 0), reps),
                             bound_ms=bound_ms(args, iters, segs)[0]))
            print(json.dumps(rows[-1]), flush=True)
    return rows


PROBE = "admm_chunk_probe"
# Stage bits of csrc/admm_chunk.cu, and the sets the probe leaves out
STAGES = {"column_walk": 1, "minv_dots": 2, "row_dots": 4, "row_updates": 8,
          "remote_sum": 16, "cluster_sync": 32}


def sweep_stages(golden_path):
    """The port's own tiling with stages left out: per shape the whole
    chunk, each stage out alone, the arithmetic out (what is left is load,
    barriers, exchange and loop control), and everything out."""
    from .ops.kernels import _build
    from .ops.kernels import admm_chunk as K

    lib = _build.load(PROBE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_chunk_probe_f32.argtypes = [p] * 12 + [i] * 6 + [f, f, i, i, p]
    lib.admm_chunk_probe_f32.restype = i
    gen = torch.Generator(device="cuda").manual_seed(0)
    arithmetic = sum(STAGES[k] for k in ("column_walk", "minv_dots", "row_dots", "row_updates"))
    masks = [("none", 0)] + list(STAGES.items()) + [("arithmetic", arithmetic), ("all", 63)]
    rows = []
    for kind, lanes, segs, iters in (("bounded", BATCH, BOUNDED_SEGS, 25),
                                     ("facets", BATCH, FACETS_SEGS, 30),
                                     ("golden", 4, None, 25), ("golden", BATCH, None, 25)):
        Minv, A, *vecs = chunk_inputs(kind, gen, golden_path, lanes)
        A, d0, mg = K.kernel_rows(A, segs)
        B, m, n = A.shape
        outs = [torch.empty(B, k, device=A.device) for k in (n, m, m)]
        ptrs = [t.data_ptr() for t in (Minv, A, *vecs, *outs)]
        reps = 20 if B * n * m < 1e7 else 4

        def run(skip, its):
            err = lib.admm_chunk_probe_f32(
                *ptrs, B, n, m, d0, mg, its, KERNEL_ARGS["sigma"], KERNEL_ARGS["alpha"], skip,
                A.device.index, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"admm_chunk_probe_f32 failed: CUDA error {err}")

        variant, ctas = K.variant(n, m, mg, B), K.cluster_size(n, m, mg, B)
        for name, skip in masks:
            if variant == "shared" and skip in (16, 32):
                continue
            rows.append(dict(sweep="stages", shape=kind, lanes=B, n=n, m=m, iters=iters,
                             variant=variant, ctas_per_lane=ctas, left_out=name,
                             ms=graph_ms(lambda: run(skip, iters), reps),
                             ms_0_iters=graph_ms(lambda: run(skip, 0), reps)))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def sweep(row_threads=(1, 2, 4)):
    """Each threads-per-row value of the register tile timed at both shapes."""
    from .ops.kernels import _build
    from .ops.kernels import admm_chunk as K

    lib = _tiles_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {kind: chunk_inputs(kind, gen) for kind, _ in SHAPES}
    rows = []
    for k in row_threads:
        for kind, segs in SHAPES:
            args = inputs[kind]
            mg = K.kernel_rows(args[1], segs)[2]
            regs, st, ld = ptxas_report(_build.build_log(TILES),
                                        kernel_entry("register", N_VARS, N_VARS, mg, k))
            run = lambda: tile_chunk(lib, k, args, segs)
            out = run()
            ref = K.admm_chunk_plain(*args, row_structure=segs, **KERNEL_ARGS)
            err = max((a - b).abs().max().item() for a, b in zip(out, ref))
            ms = graph_ms(run, 20)
            load_only = lambda: tile_chunk(lib, k, args, segs, iters=0)
            rows.append(dict(row_threads=k, shape=kind, registers=regs, spill_stores=st,
                             spill_loads=ld, max_abs_err=err, ms=ms,
                             ms_repeat=graph_ms(run, 20), ms_0_iters=graph_ms(load_only, 20),
                             bound_ms=bound_ms(args, ITERS, segs)[0]))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    ap.add_argument("--sweep", nargs="+", default=["register", "cluster", "shared"],
                    choices=["register", "cluster", "shared", "stages"])
    ap.add_argument("--golden", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "fixtures",
        "qp_golden.npz"), help="the golden QP fixtures")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chunk_bench: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    rows = []
    for which in args.sweep:
        if which == "register":
            rows += sweep()
        elif which == "stages":
            rows += sweep_stages(args.golden)
        else:
            rows += sweep_rows(which, args.golden)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()


def lmpc_qp(lanes, gen, dev):
    """The first-solve hull QP of the fleet-LMPC campaign's ADMM arm at its
    real data, ``lanes`` lanes of ``main_path.lmpc_fleet_x0`` against the
    seed's safe set: condensed, n = 45 + 10 + 7 = 62, m = 105 + 45 + 18 = 168
    (LMPC_SEGS, then the hull rows)."""
    from .lmpc import lmpc_init
    from .lmpc.lmpc import _lmpc_qp
    from .main_path import lmpc_fleet_path, lmpc_fleet_x0
    from .terminal import SafeSet

    lp = lmpc_fleet_path("3dof", dev, solver="admm")
    X, U, C = lp.seed
    ss = SafeSet.create(4096, 7, device=dev).add_trajectory(X, U, C)
    x0s = lmpc_fleet_x0(lp, gen, lanes)
    st = lmpc_init(lp.config, x0s, lp.x_target)
    return _lmpc_qp(lp.F, lp.config, ss, st, x0s).data


def hull_qp(lanes, gen, dev):
    """The hull projection QP of ``terminal.project_onto_hull`` at real data:
    ``lanes`` lanes of ``main_path.lmpc_fleet_x0``, each shifted 0.3 m
    sideways, projected onto its 10 nearest states of the 3-DoF seed
    flight (n = 10, m = 11: Σλ = 1 and the λ bounds, every row dense)."""
    from .main_path import lmpc_fleet_path, lmpc_fleet_x0
    from .ops.qp import QPData
    from .terminal import SafeSet, knn_query

    lp = lmpc_fleet_path("3dof", dev)
    X, U, C = lp.seed
    ss = SafeSet.create(4096, 7, device=dev).add_trajectory(X, U, C)
    pts = lmpc_fleet_x0(lp, gen, lanes)
    pts[:, 2] += 0.3
    res = knn_query(ss, pts, 10)
    V = res.states * res.valid[..., None]
    K = V.shape[1]
    eye = torch.eye(K, device=dev)
    vf = res.valid.float()
    ones = torch.ones(lanes, 1, device=dev)
    return QPData(P=V @ V.transpose(-1, -2) + 1e-8 * eye, q=-(V @ pts[..., None])[..., 0],
                  A=torch.cat([vf[:, None], eye.expand(lanes, K, K)], dim=1),
                  l=torch.cat([ones, torch.zeros(lanes, K, device=dev)], dim=1),
                  u=torch.cat([ones, vf], dim=1))


def filter_lanes(lanes, gen, dev):
    """States and nominal controls of ``lanes`` lanes under the downdraft,
    drawn from ``gen``: altitude 0.5-8 m, descending at 0.5-4 m/s, ±0.5 m
    and ±0.3 m/s sideways; controls 0.5-3 up and ±0.3 sideways."""
    r = torch.rand(lanes, 9, generator=gen, device=gen.device).to(dev)
    x = torch.stack([torch.full_like(r[:, 0], 2.0), 0.5 + 7.5 * r[:, 0], r[:, 1] - 0.5,
                     r[:, 2] - 0.5, -4.0 + 3.5 * r[:, 3], 0.3 * (2 * r[:, 4] - 1),
                     0.3 * (2 * r[:, 5] - 1)], dim=1)
    u = torch.stack([0.5 + 2.5 * r[:, 6], 0.3 * (2 * r[:, 7] - 1), 0.3 * (2 * r[:, 8] - 1)],
                    dim=1)
    return x, u


def filter_qp(lanes, gen, dev):
    """The safety filter's minimal-intervention QP at real data: the rescue
    campaign's filter (``main_path.safety_rescue_path``: the funnel over
    emergency braking, N = 5, the downdraft-padded model), its first SCP
    iteration at :func:`filter_lanes`: n = 4 (u and the slack), m = 6 dense
    rows (V's linearization, s ≥ 0, the box of [u, s])."""
    from .main_path import safety_rescue_path
    from .safety.safety_filter import _intervention_qp, _target, _value_and_grad

    sp = safety_rescue_path(dev)
    cfg = sp.filter_config
    x, u = filter_lanes(lanes, gen, dev)
    V0, g = _value_and_grad(sp.F_filter, sp.backup, sp.invariant, cfg.N, x, u)
    return _intervention_qp(cfg, u, u, V0, g, _target(cfg, sp.invariant))


def suite_qp(kind, lanes, dev):
    """The first-cycle QP of the experiment suite's MPC arms at their real
    data, the first ``lanes`` of its initial states (``main_path.experiments_x0``):
    "suite_gp", GP-MPC's condensed QP at N = 15 with every state bound kept
    (n = 45, m = 105 block-lower-triangular + 45 diagonal rows: LMPC_SEGS),
    linearized along the rollout of hover thrust with the trust region;
    "suite_rti", the RTI ablation's sparse-form QP (n = 157, m = 269, every
    row dense)."""
    from .dynamics import trajectory_jacobians
    from .main_path import experiment_suite_path, experiments_x0
    from .mpc import gp_mpc_init, rti_init
    from .mpc.rti import _build_rti_qp, _rollout
    from .ops.qp import build_condensed_qp

    sp = experiment_suite_path(device=dev)
    x0s = experiments_x0(lanes, dev)
    if kind == "suite_rti":
        cfg = sp.rti_config
        st = rti_init(cfg, x0s, sp.x_target)
        X = _rollout(sp.F, x0s, st.U_lin)
        Aks, Bks, cks = trajectory_jacobians(sp.F, X, st.U_lin)
        return _build_rti_qp(cfg, Aks, Bks, cks, x0s, st.x_ref)
    gcfg = sp.gp_config
    cfg = gcfg.base
    st = gp_mpc_init(gcfg, x0s, sp.x_target, device=dev)
    X = _rollout(sp.F, x0s, st.U_lin)
    Aks, Bks, cks = trajectory_jacobians(sp.F, X, st.U_lin)
    ref = sp.reference_fn(x0s)[:, :cfg.N + 1]
    tx, tu = gcfg.trust_region_x, gcfg.trust_region_u
    return build_condensed_qp(Aks, Bks, cks, x0s, cfg.Q, cfg.R, cfg.Qf, ref,
                              torch.maximum(cfg.x_min, X - tx), torch.minimum(cfg.x_max, X + tx),
                              torch.maximum(cfg.u_min, st.U_lin - tu),
                              torch.minimum(cfg.u_max, st.U_lin + tu),
                              x_bound_mask=cfg.x_bound_mask)[0]


def scvx_library_qp(lanes, dev):
    """The SCVX library's first subproblem at its real data
    (``main_path.scvx_library_path``): the first ``lanes`` of its (initial
    state, duration) lanes, states from ``main_path.experiments_x0`` and each
    state's 11 candidate time steps; N = 40, n = 407, m = 694 (7 initial-
    state rows, 280 dynamics rows, 407 bound rows, every row dense)."""
    from .main_path import SCVX_LIBRARY_STATES, experiments_x0, scvx_library_path
    from .reference.scvx import scvx_qp

    lp = scvx_library_path(dev)
    C = lp.dt_candidates.shape[0]
    x0s = experiments_x0(SCVX_LIBRARY_STATES, dev).repeat_interleave(C, dim=0)[:lanes]
    dts = lp.dt_candidates.repeat(SCVX_LIBRARY_STATES)[:lanes]
    U = x0s.new_zeros(x0s.shape[0], lp.config.N, 3)
    U[:, :, 0] = x0s[:, :1]
    return scvx_qp(lp.step_dt, lp.config, x0s, lp.x_target, dts, U)[0]
