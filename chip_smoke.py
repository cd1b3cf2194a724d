#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Drives the port's main path — the 3-DoF GP-MPC real-time cycle that
``bench.py`` times, at its full width (512 lanes, N = 20, one 50-iteration
ADMM chunk per cycle) — through the entry points a user calls, and checks
the hand-written kernel on the way:

1. the card: CUDA with compute capability 9.x, its name and power limit;
2. build every kernel of the path from ``gpmpc_tpu_torch/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card, at the
   main-path shape (its 60 rows declared diagonal), a dense QP of that size
   and the sparse-form golden shape, with the variant each launches and its
   registers and spills; times at the first two;
4. the main path: fit the GP on the card, then time GP-MPC cycles + plant
   steps with the launch counters reset just before and read just after,
   and hold one cycle on the card against the same cycle on the CPU;
5. a closed-loop landing of the 512-lane fleet under the dispersed plant,
   judged by the landing demo's pass criteria.

Everything worth reporting is printed before the last two lines: a JSON
object with one entry per kernel, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises (exit code ≠ 0); there
is no CPU fallback. Run: ``python3 chip_smoke.py``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# the main path's shape (gpmpc_tpu_torch/main_path.py holds its configuration)
N = 20
BATCH = 512
ITERS = 50
DT = 0.1
# the TPU kernels this path's kernel replaces (gpmpc_tpu/ops/pallas)
REPLACES = ("gpmpc_tpu/ops/pallas/admm_kernel.py:29 (_chunk_kernel via admm_chunk:75), "
            "gpmpc_tpu/ops/pallas/admm_kernel.py:137 (_lanes_kernel via make_admm_chunk_lanes:227)")
# tests/test_pallas.py tolerances: duals on ρ-boosted rows amplify f32
# reordering noise, hence the looser bound on y. They are absolute for O(1)
# iterates; the check divides by max(1, max|plain|) so that they stay a
# statement about f32 reordering on the golden QP too, whose iterates reach
# |x| ≈ 1.4e2 and |y| ≈ 6.9e3 (there plain f32 itself differs from float64 by
# 6e-4 in x and 4e-3 in y after 50 iterations).
ATOL_XZ, ATOL_Y = 3e-4, 2e-3


def log(*a):
    print(*a, flush=True)


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — needs an H100")
    cap = torch.cuda.get_device_capability(0)
    if cap[0] != 9:
        raise SystemExit(f"chip_smoke: needs compute capability 9.x, found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)} capability {cap} | nvidia-smi: {smi}")
    log(f"[card] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    from gpmpc_tpu_torch.ops.kernels import _build

    t0 = time.time()
    _build.build(["admm_chunk"])  # one nvcc per source, started together
    log(f"[build] admm_chunk built in {time.time() - t0:.1f} s")
    for line in _build.build_log("admm_chunk").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")


def phase_kernels():
    """Kernel vs plain at three shapes; times at the main-path shape (its
    declared diagonal rows) and at the dense 60×60 shape. Returns the timing
    of both, main first: ``ms`` is the kernel's device time from a CUDA-graph
    replay, ``eager_ms`` the time of eager back-to-back calls (it reads the
    wrapper's host time wherever that exceeds the kernel's), ``wrapper_us``
    the host time of one wrapper call."""
    from gpmpc_tpu_torch.chunk_bench import (bmm_chain_graph, bound_ms, chunk_inputs, cuda_ms,
                                             graph_ms, host_us, kernel_entry, ptxas_report)
    from gpmpc_tpu_torch.ops.kernels import _build
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    golden = os.path.join(ROOT, "tests", "fixtures", "qp_golden.npz")
    timings = []
    # the main path's QP declares its 60 identity control rows as "diag"
    # (mpc/rti.py::_condensed_admm_cfg); the other two shapes are all dense
    for kind, segs in (("main", (("diag", N * 3),)), ("dense", None), ("golden", None)):
        args = chunk_inputs(kind, gen, golden)
        B, m, n = args[1].shape
        kw = dict(iters=ITERS, sigma=1e-6, alpha=1.6, row_structure=segs)
        xk, zk, yk = K.admm_chunk(*args, **kw)
        xp, zp, yp = K.admm_chunk_plain(*args, **kw)
        torch.cuda.synchronize()
        err = [(a - b).abs().max().item() for a, b in ((xk, xp), (zk, zp), (yk, yp))]
        scale = [max(1.0, b.abs().max().item()) for b in (xp, zp, yp)]
        rel = [e / s for e, s in zip(err, scale)]
        finite = all(bool(torch.isfinite(t).all()) for t in (xk, zk, yk))
        mg = K.kernel_rows(args[1], segs)[1]
        variant = K.variant(n, m, mg)
        regs, spill_st, spill_ld = ptxas_report(_build.build_log("admm_chunk"),
                                                kernel_entry(variant, n, m, mg))
        log(f"[kernel] {kind}: B={B} n={n} m={m} diagonal rows {mg} iters={ITERS} "
            f"variant={variant} ({regs} registers, spill stores {spill_st} B, loads {spill_ld} B) "
            f"max|dx|={err[0]:.3e} max|dz|={err[1]:.3e} max|dy|={err[2]:.3e}; "
            f"over max(1,|plain|): {rel[0]:.3e} {rel[1]:.3e} {rel[2]:.3e} "
            f"(atol {ATOL_XZ}/{ATOL_XZ}/{ATOL_Y})")
        if not finite or rel[0] > ATOL_XZ or rel[1] > ATOL_XZ or rel[2] > ATOL_Y:
            raise RuntimeError(f"admm_chunk kernel disagrees with its plain version ({kind})")
        if kind == "golden":
            continue
        chunk = lambda: K.admm_chunk(*args, **kw)
        ms = graph_ms(chunk, 20)
        plain_ms = cuda_ms(lambda: K.admm_chunk_plain(*args, **kw), 5)
        lib_ms = cuda_ms(bmm_chain_graph(args, ITERS, segs), 20)
        ms2 = graph_ms(chunk, 20)
        eager_ms, wrap_us = cuda_ms(chunk, 50), host_us(chunk, 200)
        bnd, by, nbytes, flops = bound_ms(args, ITERS, segs)
        timings.append(dict(shape=kind, variant=variant, registers=regs, max_abs_err=max(err),
                            ms=ms, ms_repeat=ms2, eager_ms=eager_ms, wrapper_us=wrap_us,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by))
        log(f"[kernel] {kind} chunk: kernel {ms:.4f} ms (repeat {ms2:.4f}; CUDA graph of 20 "
            f"launches), eager back-to-back calls {eager_ms:.4f} ms, wrapper host time "
            f"{wrap_us:.1f} us a call, "
            f"plain {plain_ms:.4f} ms, bmm chain in a CUDA graph {lib_ms:.4f} ms, "
            f"bound {bnd:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), "
            f"share of bound {bnd / ms:.3f}")
    return timings


def _to(obj, dev):
    """Copy a (nested) dataclass of tensors to ``dev``."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kw = {f.name: _to(getattr(obj, f.name), dev)
              for f in dataclasses.fields(obj) if f.init}
        if "device" in kw:
            kw["device"] = dev
        return type(obj)(**kw)
    return obj


def phase_main_path(dev=torch.device("cuda")):
    from gpmpc_tpu_torch.learning import explore_gp_3dof
    from gpmpc_tpu_torch.main_path import fleet_x0, gp_fns, main_path
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    mp = main_path(dev)
    cfg = mp.config
    t0 = time.time()
    gp, mean_fn, var_fn = explore_gp_3dof(
        torch.Generator(device=dev).manual_seed(0),
        torch.Generator(device=dev).manual_seed(1), mp.params, mp.F_true, dt=DT, device=dev)
    torch.cuda.synchronize(dev)
    log(f"[main] GP fitted in {time.time() - t0:.2f} s "
        f"({int(gp.buffer.count)} points, {gp.gp.Z.shape[0]} inducing)")

    state = gp_mpc_init(cfg, fleet_x0(BATCH, dev), mp.x_target, device=dev)
    xs = fleet_x0(BATCH, dev)

    def cycle(state, xs):
        sol, state = gp_mpc_solve(mp.F, mean_fn, var_fn, cfg, state, xs)
        return sol, state, mp.F_true(xs, sol.u0)

    for _ in range(5):  # warm-up: allocator, cuBLAS/cuSOLVER handles, kernel load
        sol, state, xs = cycle(state, xs)
    torch.cuda.synchronize(dev)

    cycles = 20
    K.LAUNCHES = 0  # counts from here on are the main path's
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    for _ in range(cycles):
        sol, state, xs = cycle(state, xs)
    end.record()
    torch.cuda.synchronize(dev)
    host_ms = (time.time() - t0) * 1e3 / cycles
    launches = K.LAUNCHES
    dev_ms = start.elapsed_time(end) / cycles
    for name, t in (("u0", sol.u0), ("X_opt", sol.X_opt), ("state.X_lin", state.X_lin),
                    ("state.y_prev", state.y_prev), ("x", xs)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite {name} on the main path")
    chunks = cfg.scp_iterations * (cfg.base.admm.max_iter // cfg.base.admm.check_interval)
    if launches != cycles * chunks:
        raise RuntimeError(f"admm_chunk launched {launches} times in {cycles} cycles, "
                           f"expected {cycles * chunks}")
    log(f"[main] {cycles} cycles x {BATCH} lanes: {dev_ms:.3f} ms/cycle (CUDA events), "
        f"{host_ms:.3f} ms/cycle (host clock), {BATCH * 1000.0 / host_ms:.1f} solves/s; "
        f"admm_chunk launches {launches} ({chunks}/cycle); "
        f"accepted {float(sol.success.float().mean()):.4f}")

    # the same cycle on the CPU from the same state: the plain path as reference
    lanes = 8
    cpu = torch.device("cpu")
    sub = lambda s: type(s)(**{f: getattr(s, f)[:lanes] for f in
                               ("X_lin", "U_lin", "x_ref", "rho", "y_prev")})
    st_gpu, x_gpu = sub(state), xs[:lanes]
    sol_g, _ = gp_mpc_solve(mp.F, mean_fn, var_fn, cfg, st_gpu, x_gpu)
    mp_c = main_path(cpu)
    mean_c, var_c = gp_fns(_to(gp, cpu))
    sol_c, _ = gp_mpc_solve(mp_c.F, mean_c, var_c, mp_c.config, _to(st_gpu, cpu), x_gpu.cpu())
    du = (sol_g.u0.cpu() - sol_c.u0).abs().max().item()
    dX = (sol_g.X_opt.cpu() - sol_c.X_opt).abs().max().item()
    log(f"[main] card vs CPU, one cycle at {lanes} lanes: max|du0|={du:.3e} "
        f"max|dX_opt|={dX:.3e} (atol 1e-3)")
    if du > 1e-3 or dX > 1e-3:
        raise RuntimeError("the card's cycle disagrees with the CPU reference")
    return dict(launches=launches, ms_per_cycle=dev_ms, host_ms_per_cycle=host_ms,
                solves_per_s=BATCH * 1000.0 / host_ms), (mean_fn, var_fn)


def phase_landing(gp_fns_, dev=torch.device("cuda")):
    from gpmpc_tpu_torch.main_path import fleet_x0, main_path
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve

    mp = main_path(dev)
    mean_fn, var_fn = gp_fns_
    xs = fleet_x0(BATCH, dev)
    state = gp_mpc_init(mp.config, xs, mp.x_target, device=dev)
    landed = torch.zeros(xs.shape[0], dtype=torch.bool, device=dev)
    t0 = time.time()
    steps = 0
    for steps in range(1, 251):
        sol, state = gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs)
        xn = mp.F_true(xs, sol.u0)
        xs = torch.where(landed[:, None], xs, xn)  # freeze at touchdown
        landed = landed | (xs[:, 1] < 0.1)
        if steps % 10 == 0 and bool(landed.all()):
            break
    v = torch.linalg.vector_norm(xs[:, 4:7], dim=1)
    perr = torch.linalg.vector_norm(xs[:, 2:4], dim=1)
    alt = xs[:, 1]
    ok = landed & (v < 2.0) & (perr < 1.0) & (alt < 0.5)  # scripts/demo_landing.py:91-93
    share = float(ok.float().mean())
    log(f"[landing] {xs.shape[0]} lanes, {steps} cycles in {time.time() - t0:.1f} s: "
        f"landed {int(landed.sum())}/{xs.shape[0]}, success share {share:.4f}, "
        f"worst touchdown |v| {float(v.max()):.4f} m/s, mean {float(v.mean()):.4f}, "
        f"worst position error {float(perr.max()):.4f} m, worst altitude {float(alt.max()):.4f} m")
    if share < 1.0:
        raise RuntimeError("the fleet failed the landing criteria")
    return dict(success_share=share, worst_v=float(v.max()), steps=steps)


def main():
    smi = phase_card()
    phase_build()
    timings = phase_kernels()
    main_res, fns = phase_main_path()
    land = phase_landing(fns)
    log(f"[summary] main path {main_res['ms_per_cycle']:.3f} ms/cycle, "
        f"{main_res['solves_per_s']:.1f} solves/s, landing success {land['success_share']:.4f}")
    main_t = timings[0]
    kernels = [{
        "name": "admm_chunk",
        "route": "cuda",
        "source": "gpmpc_tpu_torch/csrc/admm_chunk.cu",
        "replaces": REPLACES,
        "launches": main_res["launches"],
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"],
        "eager_ms": main_t["eager_ms"],
        "wrapper_us": main_t["wrapper_us"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "variant": main_t["variant"],
        "shapes": [{k: t[k] for k in ("shape", "variant", "registers", "ms", "eager_ms",
                                       "wrapper_us", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")}
                   for t in timings],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
