"""Measurements of the ADMM chunk kernel on the card, and its tile sweep.

``chip_smoke.py`` times the kernel with these helpers. Run alone, the module
sweeps the register variant's threads per row (K, fixed at 2 in
``csrc/admm_chunk.cu``) through ``csrc/admm_chunk_tiles.cu``, a build of the
same kernel that takes K per call. For K = 1, 2 and 4 it reports the
registers and spills ``ptxas`` gives the register kernels, the agreement with
the plain version, and the device time at the main-path shape (512 lanes,
n = m = 60, every row declared diagonal, 50 iterations) and at the dense
60×60 shape, beside the time of a chunk of 0 iterations (launch, operand
loads, stores):

    python -m gpmpc_tpu_torch.chunk_bench [--out FILE.json]

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


def chunk_inputs(kind, gen, golden_path=None, lanes=8):
    """Chunk operands on the card: (Minv, A, q, l, u, rho_v, x, z, y).
    "main": 512 lanes, n = m = 60, A the identity control-bound rows as
    build_condensed_qp makes them; "dense": the same size with a random A;
    "bounded": n = 60, m = 200, the condensed QP that keeps its state-bound
    rows: 140 block-lower-triangular rows (BOUNDED_SEGS), then the identity;
    "golden": ``lanes`` sparse-form golden QPs (n = 207, m = 354), the four of
    ``golden_path`` repeated."""
    from .ops.qp import QPData, ruiz_equilibrate
    from .ops.qp.admm import _factor, _rho_vec

    dev = torch.device("cuda")
    if kind == "golden":
        fx = np.load(golden_path)
        names = (("canonical", "high_fast", "low_slow", "lateral") * ((lanes + 3) // 4))[:lanes]
        stack = lambda p: torch.tensor(np.stack([fx[f"{s}/{p}"] for s in names]),
                                       dtype=torch.float32, device=dev)
        data = QPData(*[stack(p) for p in ("P", "q", "A", "l", "u")])
    else:
        B, n = BATCH, N_VARS
        G = torch.randn(B, n, n, generator=gen, device=dev)
        P = G @ G.transpose(1, 2) / n + 0.1 * torch.eye(n, device=dev)
        if kind == "main":
            A = torch.eye(n, device=dev).expand(B, n, n).contiguous()
        elif kind == "bounded":
            _, C, h, w = BOUNDED_SEGS[0]
            keep = (torch.arange(n, device=dev)[None, :]
                    < (torch.arange(C * h, device=dev)[:, None] // h + 1) * w)
            blt = torch.randn(B, C * h, n, generator=gen, device=dev) * keep
            A = torch.cat([blt, torch.eye(n, device=dev).expand(B, n, n)], dim=1)
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


def kernel_entry(variant, n, m, mg, row_threads=None):
    """A pattern of the mangled name of the kernel instance a chunk launches
    (any threads per row when ``row_threads`` is None)."""
    md = m - mg
    k = r"\d+" if row_threads is None else str(row_threads)
    return {
        "register": (f"admm_chunk_regILi{32 if n <= 32 and md <= 32 else 64}"
                     f"ELi{k}ELb{int(md > 0)}E"),
        "shared": "admm_chunk_kernelILb1E",
        "global": "admm_chunk_kernelILb0E",
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


def sweep(row_threads=(1, 2, 4)):
    """Each threads-per-row value timed at both shapes."""
    from .ops.kernels import _build
    from .ops.kernels import admm_chunk as K

    lib = _build.load(TILES)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_chunk_tile_f32.argtypes = [p] * 12 + [i] * 6 + [f, f, i, i, p]
    lib.admm_chunk_tile_f32.restype = i
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chunk_bench: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    rows = sweep()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
