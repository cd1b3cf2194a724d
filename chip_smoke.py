#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Drives the port's paths at their full width (512 lanes, N = 20) through the
entry points a user calls, and checks the hand-written kernel on the way:

1. the card: CUDA with compute capability 9.x, its name and power limit;
2. build every kernel of the paths from ``gpmpc_tpu_torch/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card at every shape
   the paths give it — the main path's (60 rows declared diagonal, 50
   iterations), a dense QP of that size, the sparse-form golden shape at 8
   and 5 lanes, the RTI path's (25 iterations), a condensed QP that keeps
   its state-bound rows (140 dense rows before the 60 diagonal ones) at 25
   and at the calibration path's 50 iterations, the 6-DoF QP with cone
   facets (380 rows), the golden shape at 4 and 512 lanes, and Path D's and
   the 6-DoF online campaign's condensed QPs at 30 and 50 iterations, Path F's
   two QPs, Path G's hull QP and hull projection QP, and the safety filter's
   intervention QP at 1024 and 512 lanes — with the
   variant each launches, its CTAs a lane, its registers and spills, and its
   time beside its bound, the plain version and a cuBLAS chain;
4. the main path: fit the GP on the card, then time GP-MPC cycles + plant
   steps with the launch counters reset just before and read just after,
   and hold one cycle on the card against the same cycle on the CPU;
5. a closed-loop landing of the fleet under the dispersed plant, judged by
   the landing demo's pass criteria;
6. the RTI path: the GP-free RTI cycle on the nominal plant, timed and
   counted the same way, held against the CPU, then a closed-loop landing
   of the fleet along per-lane descent references;
7. the production GP fit: ``pretrain_gp_3dof`` on the card (sparse-form RTI
   episodes through the kernel's cluster variant, FITC fit, Adam tuning),
   then the GP-MPC landing of the fleet with that GP;
8. the calibration path: the bound-riding GP-MPC cycle with the state bounds
   kept in the QP (the shared variant, one launch a cycle), timed, counted
   and held against the CPU, then the 90-step flight under a gust of known
   σ, judged by the calibration campaign's own gate;
9. Path D, the 6-DoF quaternion GP-MPC cycle: ``pretrain_gp_6dof`` on the
   card (six sparse-form 6-DoF RTI episodes, the campaign's count, through
   the cluster variant, two FITC fits, Adam tuning), the 512-lane cycle (the shared variant, one or
   two launches a cycle) timed, counted and held against the CPU, then the
   150-step landing campaign through ``run_campaign``, judged by its success
   share;
10. Path E, the online-learning GP-MPC cycle (a GP per lane, observed every
   cycle, refit every 10 and refreshed every 20 cycles): the 512-lane cycle
   timed as ``bench.py`` times it (windows of 40 cycles replayed from a
   snapshot whose buffers a first window filled, so every window crosses
   both cadences), its launches counted, ten cycles held against the CPU;
   the per-cycle observe alone; then the 3-DoF (130 steps) and 6-DoF (150
   steps, the shared variant at 50 iterations) online campaigns, each judged
   by its success share and the drop of its one-step model error;
11. Path F, fleet GP learning (``run_batched_learning``: every lane flies
   GP-MPC episodes with its own sparse GP, refits at the round barrier and
   retunes by Adam every second round): the 3-DoF fleet (128 lanes, the
   sparse-form QP through the cluster variant) and the 6-DoF fleet (64
   lanes, the condensed QP through the shared variant), 3 rounds of 110
   steps each, judged by the fleet script's gate and printed beside the
   JAX package's TPU artifacts; the episode cycle timed with CUDA events on
   the GPs the campaign's second round flew with, its launches counted; from
   those GPs, 8 lanes' first 10 cycles and their whole round held against
   the CPU, beside the same run through the plain chunk on the card;
12. Path G, fleet LMPC (``scripts/run_fleet_lmpc_tpu.py``): the 3-DoF
   campaign at the artifact's widths (256 lanes, 5 rounds of ≤ 150 steps,
   the interior-point solver, one safe set of 262,144 rows shared by every
   lane), judged by its floors and printed beside the JAX package's TPU
   artifact; 10 teacher-forced solves of 8 lanes on its final set held
   against the CPU; the hull projection of every lane (the ADMM solver,
   the register variant); one round on the ADMM arm (800 iterations in 32
   chunks of 25 on the 62-column hull QP: the shared variant); the 6-DoF
   campaign (its seed an RTI-flown landing through the kernel; 3 rounds);
13. the 3-DoF GP-MPC campaign of ``scripts/run_campaign_tpu.py --controller
   gp_mpc --rt --elide`` at the artifact's 4096 lanes with its own GP on the
   drag + wind plant, reported beside the artifact;
14. the safety layer (``phase_safety``): 10 teacher-forced filtered cycles of
   the rescue composition, 8 lanes, card against CPU; the filter's latency
   per cycle as ``scripts/bench_safety_filter.py`` measures it (512 lanes,
   half diving); the three safety-filtered campaigns, each judged by its own
   gate and printed beside the JAX package's TPU artifact: the rescue
   (``--controller rti --safety-filter --gust -2.0``, 1024 lanes, the filter
   and the unfiltered arm), the GP-MPC campaign behind the velocity-ellipsoid
   filter (1024 lanes, phase 13's GP) and the online GP-MPC learning across
   episodes behind the GP-read funnel filter (512 lanes), each on the
   initial states its artifact flew (``tests/fixtures/safety_x0.npz``). The
   filter's QP is the kernel's ``filter`` shape (n = 4, m = 6), eight
   launches a cycle.

Everything worth reporting is printed before the last two lines: a JSON
object with one entry per kernel, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises (exit code ≠ 0); there
is no CPU fallback. Run: ``python3 chip_smoke.py``.
"""

import dataclasses
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
RTI_CHUNK = 25  # the default check interval: the RTI and pretraining paths' chunk
DT = 0.1
SIXDOF_SUCCESS = 0.98  # the 6-DoF campaign's success share floor
# the online campaigns' floors: success share, and the early/late one-step
# model-error ratio (tests/test_online_gp_mpc.py: late < 0.5·early)
ONLINE_FLOORS = {"3dof": (0.98, 2.0), "6dof": (0.95, 2.0)}
# card vs CPU on Path F's episode cycle: Path E's 1e-3 on u0 and a
# relative 1e-2 on a lane's model error over a round, each widened to
# FLEET_WITNESS_X times what f32 arithmetic alone moves it by, read in the
# same run: the same cycles on the card through the plain chunk, and on the
# CPU under a one-ulp change of the state. The 6-DoF fleet's controller (100
# fixed-ρ ADMM iterations that do not converge, 210 dense state-bound rows)
# moves its own u0 by ~3e-3 under such a change, on the CPU and in the JAX
# package alike (tests/test_torch_fleet.py); the 3-DoF one by ~2e-4
FLEET_U0_ATOL, FLEET_ERR_RTOL, FLEET_WITNESS_X = 1e-3, 1e-2, 2.0
# Path G (fleet LMPC): rounds flown (the 6-DoF campaign flies 3 of the
# artifact's 5, which keeps this script under ~900 s: with 5 it ran 935 s on
# an H100 at 700 W), final-success floors (the artifacts read 1.0), and card
# vs CPU on u0: 5e-3 or twice the CPU's own spread under one-ulp changes of
# the state, read in the same run
LMPC_ROUNDS = {"3dof": 5, "6dof": 3}
LMPC_FLOORS = {"3dof": 0.98, "6dof": 0.97}
LMPC_U0_ATOL, LMPC_WITNESS_X = 5e-3, 2.0
# the safety campaigns' episodes of online learning: the artifact's 6 (the
# first cut if the script outgrows ~900 s is to the script's default of 3)
ONLINE_SAFETY_EPISODES = 6
# card vs CPU on the filter: u within 1e-3 or twice the CPU's own spread
# under one-ulp changes of the state (the witness rule)
SAFETY_U_ATOL, SAFETY_WITNESS_X = 1e-3, 2.0
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
# the shapes at whose real data f32 alone moves the plain chunk's iterates by
# more than ten times those tolerances from a float64 run of it (the LMPC
# hull QP, the hull projection QP): there the kernel is held around the
# float64 run within the tolerance plus WITNESS_X times the plain f32 run's
# own distance from it
WITNESS_SHAPES, WITNESS_X = ("lmpc", "hull"), 2.0

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
    """Kernel vs plain at every shape of the paths; times at all but the
    8-lane golden check. Returns the timings, main first: ``ms`` is the
    kernel's device time from a CUDA-graph replay, ``eager_ms`` the time of
    eager back-to-back calls (it reads the wrapper's host time wherever that
    exceeds the kernel's), ``wrapper_us`` the host time of one wrapper call."""
    from gpmpc_tpu_torch.chunk_bench import (BOUNDED_SEGS, FACETS_SEGS, FLEET6_SEGS, LMPC_SEGS,
                                             bmm_chain_graph,
                                             bound_ms, chunk_inputs, cuda_ms, graph_ms,
                                             host_us, kernel_entry, ptxas_report)
    from gpmpc_tpu_torch.ops.kernels import _build
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    golden = os.path.join(ROOT, "tests", "fixtures", "qp_golden.npz")
    timings = []
    diag = (("diag", N * 3),)
    # (name, inputs, lanes of the golden set, row structure, iterations, timed).
    # The condensed paths declare their 60 identity control rows as "diag"
    # (mpc/rti.py::_condensed_admm_cfg): alone on the main and RTI paths,
    # after the block-lower-triangular state-bound rows where those are kept.
    # The sparse-form golden shape is what the pretraining episodes solve
    # (5 lanes: a count that is a multiple of nothing); bounded50 is the
    # calibration path's chunk, facets the 6-DoF QP with cone facets at its
    # bench's chunk of 30. sixdof and sparse6dof are Path D's two QPs at their
    # real data: the cycle's condensed one (30 iterations a chunk) and the
    # pretraining episodes' sparse one (n = 269, m = 493, every row dense);
    # sixdof50 is the condensed one in the 6-DoF online campaign's chunks of 50.
    # fleet3dof and fleet6dof are Path F's QPs at their real data and widths:
    # the 3-DoF fleet's sparse form (n = 157, m = 269, every row dense) and the
    # 6-DoF fleet's condensed form (n = 45, m = 255, FLEET6_SEGS). lmpc is Path
    # G's ADMM arm: the condensed hull QP (n = 62, m = 168: LMPC_SEGS and 18
    # trailing dense hull rows) of 256 lanes against the seed's safe set;
    # lmpc_rows a random QP of its shape and rows. hull is the hull
    # projection's QP (n = 10, m = 11) of those lanes. bounded1024 is the
    # bounded shape at the rescue campaign's 1024 lanes. filter and filter512
    # are the safety filter's intervention QP (n = 4, m = 6 dense rows) at
    # the rescue and GP-MPC campaigns' 1024 and the online campaign's 512
    # lanes. On lmpc and hull f32
    # alone moves the iterates by tens of times the tolerance (an
    # ill-conditioned M⁻¹ and near-duplicate vertices; WITNESS_SHAPES).
    shapes = (("main", "main", 0, diag, ITERS, True), ("dense", "dense", 0, None, ITERS, True),
              ("golden", "golden", 8, None, ITERS, False),
              ("golden_b5", "golden", 5, None, RTI_CHUNK, False),
              ("rti", "main", 0, diag, RTI_CHUNK, True),
              ("bounded", "bounded", 0, BOUNDED_SEGS, RTI_CHUNK, True),
              ("bounded50", "bounded", 0, BOUNDED_SEGS, ITERS, True),
              ("facets", "facets", 0, FACETS_SEGS, 30, True),
              ("golden_b4", "golden", 4, None, RTI_CHUNK, True),
              ("golden_b512", "golden", BATCH, None, RTI_CHUNK, True),
              ("sixdof", "sixdof", BATCH, BOUNDED_SEGS, 30, True),
              ("sixdof50", "sixdof", BATCH, BOUNDED_SEGS, ITERS, True),
              ("sparse6dof", "sparse6dof", 4, None, RTI_CHUNK, True),
              ("fleet3dof", "fleet3dof", 128, None, RTI_CHUNK, True),
              ("fleet6dof", "fleet6dof", 64, FLEET6_SEGS, RTI_CHUNK, True),
              ("lmpc", "lmpc", 256, LMPC_SEGS, RTI_CHUNK, True),
              ("lmpc_rows", "lmpc_rows", 256, LMPC_SEGS, RTI_CHUNK, False),
              ("hull", "hull", 256, None, RTI_CHUNK, True),
              ("sparse6dof_b5", "sparse6dof", 5, None, RTI_CHUNK, False),
              ("bounded1024", "bounded", 1024, BOUNDED_SEGS, RTI_CHUNK, True),
              ("filter", "filter", 1024, None, RTI_CHUNK, True),
              ("filter512", "filter", BATCH, None, RTI_CHUNK, True))
    for kind, inputs, lanes, segs, iters, timed in shapes:
        args = chunk_inputs(inputs, gen, golden, lanes)
        B, m, n = args[1].shape
        kw = dict(iters=iters, sigma=1e-6, alpha=1.6, row_structure=segs)
        xk, zk, yk = K.admm_chunk(*args, **kw)
        xp, zp, yp = K.admm_chunk_plain(*args, **kw)
        torch.cuda.synchronize()
        err = [(a - b).abs().max().item() for a, b in ((xk, xp), (zk, zp), (yk, yp))]
        scale = [max(1.0, b.abs().max().item()) for b in (xp, zp, yp)]
        rel = [e / s for e, s in zip(err, scale)]
        finite = all(bool(torch.isfinite(t).all()) for t in (xk, zk, yk))
        Ak, d0, mg = K.kernel_rows(args[1], segs)
        if Ak is not args[1]:
            raise RuntimeError(f"the wrapper copied A for the {kind} shape")
        variant, ctas = K.variant(n, m, mg, B), K.cluster_size(n, m, mg, B)
        if variant == "global":
            raise RuntimeError(f"the {kind} shape lands on the global variant: repair the picker")
        regs, spill_st, spill_ld = ptxas_report(_build.build_log("admm_chunk"),
                                                kernel_entry(variant, n, m, mg))
        log(f"[kernel] {kind}: B={B} n={n} m={m} diagonal rows {d0}..{d0 + mg} iters={iters} "
            f"variant={variant} ({ctas or 1} CTAs a lane, {regs} registers, spill stores {spill_st} B, loads {spill_ld} B) "
            f"max|dx|={err[0]:.3e} max|dz|={err[1]:.3e} max|dy|={err[2]:.3e}; "
            f"over max(1,|plain|): {rel[0]:.3e} {rel[1]:.3e} {rel[2]:.3e} "
            f"(atol {ATOL_XZ}/{ATOL_XZ}/{ATOL_Y})")
        # one rule at every shape, for each iterate: where the f32 plain
        # version lies within the tolerance of a float64 run of it, the kernel
        # is held to the plain version at that tolerance; where f32
        # reordering alone moves it further (the 3-DoF fleet's sparse QP: 112
        # equality rows at ρ ×1e3 and O(1) duals, y by ~5e-3 in 25
        # iterations), kernel-vs-plain reads that noise, so the kernel is held
        # around the float64 run as tests/test_torch_cuda.py holds it: within
        # the tolerance plus the plain version's own distance, which may
        # reach ten times the tolerance at most
        ref = K.admm_chunk_plain(*[a.double() for a in args], **kw)
        bad = []
        for name, kt, pt, r, e, a, sc in zip("xzy", (xk, zk, yk), (xp, zp, yp), ref, err,
                                             (ATOL_XZ, ATOL_XZ, ATOL_Y), scale):
            tol, f32 = a * sc, (pt.double() - r).abs().max().item()
            if f32 <= tol:
                bad.append(e > tol)
                continue
            e64 = (kt.double() - r).abs().max().item()
            if kind in WITNESS_SHAPES:
                # f32 itself is the noise: the kernel may lie no farther from
                # the float64 run than the tolerance plus twice the plain f32 one
                lim = tol + WITNESS_X * f32
                bad.append(e64 > lim)
            else:
                lim = tol + f32
                bad.append(f32 > 10 * tol or e64 > lim)
            log(f"[kernel] {kind} {name}: plain f32 {f32:.3e} from the float64 run, above the "
                f"tolerance {tol:.3e}: kernel {e64:.3e} from it, limit {lim:.3e}")
        if not finite or any(bad):
            raise RuntimeError(f"admm_chunk kernel disagrees with its plain version ({kind})")
        if not timed:
            continue
        chunk = lambda: K.admm_chunk(*args, **kw)
        reps = 20 if B * n * m < 1e7 else 4  # the 512-lane golden chunk takes milliseconds
        ms = graph_ms(chunk, reps)
        plain_ms = cuda_ms(lambda: K.admm_chunk_plain(*args, **kw), 5)
        lib_ms = cuda_ms(bmm_chain_graph(args, iters, segs), reps)
        ms2 = graph_ms(chunk, reps)
        eager_ms, wrap_us = cuda_ms(chunk, 50), host_us(chunk, 200)
        bnd, by, nbytes, flops = bound_ms(args, iters, segs)
        timings.append(dict(shape=kind, lanes=B, n=n, m=m, iters=iters, variant=variant,
                            ctas_per_lane=ctas or 1, registers=regs, max_abs_err=max(err),
                            ms=ms, ms_repeat=ms2, eager_ms=eager_ms, wrapper_us=wrap_us,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by))
        log(f"[kernel] {kind} chunk: kernel {ms:.4f} ms (repeat {ms2:.4f}; CUDA graph of {reps} "
            f"launches), eager back-to-back calls {eager_ms:.4f} ms, wrapper host time "
            f"{wrap_us:.1f} us a call, "
            f"plain {plain_ms:.4f} ms, bmm chain in a CUDA graph {lib_ms:.4f} ms, "
            f"bound {bnd:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), "
            f"share of bound {bnd / ms:.3f}")
    return timings


def _to(obj, dev, dtype=None):
    """Copy a (nested) dataclass of tensors to ``dev``, its floating-point
    tensors cast to ``dtype`` if given."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev, dtype) if dtype is not None and obj.is_floating_point() else obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kw = {f.name: _to(getattr(obj, f.name), dev, dtype)
              for f in dataclasses.fields(obj) if f.init}
        if "device" in kw:
            kw["device"] = dev
        return type(obj)(**kw)
    if type(obj) is tuple:
        return tuple(_to(o, dev, dtype) for o in obj)
    return obj


def _first_lanes(obj, lanes):
    """A (nested) dataclass of tensors with a leading lane axis, cut to its
    first ``lanes`` lanes."""
    if isinstance(obj, torch.Tensor):
        return obj[:lanes]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _first_lanes(getattr(obj, f.name), lanes)
                                           for f in dataclasses.fields(obj) if f.init})
    if type(obj) is tuple:
        return tuple(_first_lanes(o, lanes) for o in obj)
    return obj


def _repeat_lanes(obj, r):
    """A (nested) dataclass of tensors with a leading lane axis, its lanes
    repeated ``r`` times (lane i of copy j at j·B + i)."""
    if isinstance(obj, torch.Tensor):
        return obj.repeat(r, *([1] * (obj.dim() - 1)))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _repeat_lanes(getattr(obj, f.name), r)
                                           for f in dataclasses.fields(obj) if f.init})
    if type(obj) is tuple:
        return tuple(_repeat_lanes(o, r) for o in obj)
    return obj


def _time_cycles(cycle, state, xs, cycles, dev, what):
    """Warm up, then time ``cycles`` calls of ``cycle(state, xs) → (sol,
    state, xs)`` with the kernel's launch count set to 0 just before and read
    just after. Returns (sol, state, xs, ms per cycle from CUDA events, ms
    per cycle on the host clock, launches)."""
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    for _ in range(5):  # warm-up: allocator, cuBLAS/cuSOLVER handles, kernel load
        sol, state, xs = cycle(state, xs)
    torch.cuda.synchronize(dev)
    K.LAUNCHES = 0  # counts from here on are this path's
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    for _ in range(cycles):
        sol, state, xs = cycle(state, xs)
    end.record()
    torch.cuda.synchronize(dev)
    host_ms = (time.time() - t0) * 1e3 / cycles
    launches = K.LAUNCHES
    for name, t in (("u0", sol.u0), ("X_opt", sol.X_opt), ("state.X_lin", state.X_lin),
                    ("state.y_prev", state.y_prev), ("x", xs)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite {name} on {what}")
    return sol, state, xs, start.elapsed_time(end) / cycles, host_ms, launches


def phase_main_path(dev=torch.device("cuda")):
    from gpmpc_tpu_torch.learning import explore_gp_3dof
    from gpmpc_tpu_torch.main_path import fleet_x0, gp_fns, main_path
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve

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

    cycles = 20
    sol, state, xs, dev_ms, host_ms, launches = _time_cycles(
        cycle, state, xs, cycles, dev, "the main path")
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
    st_gpu, x_gpu = _first_lanes(state, lanes), xs[:lanes]
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


def _judge(tag, xs, landed, steps, seconds):
    """scripts/demo_landing.py:91-93: every lane landed, |v| < 2 m/s,
    position error < 1 m, altitude < 0.5 m."""
    v = torch.linalg.vector_norm(xs[:, 4:7], dim=1)
    perr = torch.linalg.vector_norm(xs[:, 2:4], dim=1)
    alt = xs[:, 1]
    ok = landed & (v < 2.0) & (perr < 1.0) & (alt < 0.5)
    share = float(ok.float().mean())
    log(f"[{tag}] {xs.shape[0]} lanes, {steps} cycles in {seconds:.1f} s: "
        f"landed {int(landed.sum())}/{xs.shape[0]}, success share {share:.4f}, "
        f"worst touchdown |v| {float(v.max()):.4f} m/s, mean {float(v.mean()):.4f}, "
        f"worst position error {float(perr.max()):.4f} m, worst altitude {float(alt.max()):.4f} m")
    if share < 1.0:
        raise RuntimeError(f"the fleet failed the landing criteria ({tag})")
    return dict(success_share=share, worst_v=float(v.max()), steps=steps)


def phase_landing(gp_fns_, dev=torch.device("cuda"), tag="landing"):
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
    return _judge(tag, xs, landed, steps, time.time() - t0)


def phase_rti(dev=torch.device("cuda")):
    """Path A: the GP-free RTI cycle of the bench's secondary metric."""
    from gpmpc_tpu_torch.main_path import fleet_x0, rti_path
    from gpmpc_tpu_torch.mpc import rti_closed_loop, rti_init, rti_step
    from gpmpc_tpu_torch.reference import cubic_descent_reference, pad_reference

    rp = rti_path(dev)
    cfg = rp.config
    xs = fleet_x0(BATCH, dev)
    state = rti_init(cfg, xs, rp.x_target)

    def cycle(state, xs):
        sol, state = rti_step(rp.F, cfg, state, xs)
        return sol, state, rp.F(xs, sol.u0)

    cycles = 20
    sol, state, xs, dev_ms, host_ms, launches = _time_cycles(
        cycle, state, xs, cycles, dev, "the RTI path")
    # two chunks of 25 a cycle; early exit may skip the second
    if not cycles <= launches <= 2 * cycles:
        raise RuntimeError(f"admm_chunk launched {launches} times in {cycles} RTI cycles, "
                           f"expected {cycles} to {2 * cycles}")
    log(f"[rti] {cycles} cycles x {BATCH} lanes: {dev_ms:.3f} ms/cycle (CUDA events), "
        f"{host_ms:.3f} ms/cycle (host clock), {BATCH * 1000.0 / host_ms:.1f} solves/s; "
        f"admm_chunk launches {launches} ({launches / cycles:.2f}/cycle); "
        f"accepted {float(sol.success.float().mean()):.4f}")

    lanes = 8
    cpu = torch.device("cpu")
    st_gpu = type(state)(**{f: getattr(state, f)[:lanes] for f in
                            ("X_lin", "U_lin", "X_prev", "U_prev", "y_prev", "rho", "x_ref")})
    sol_g, _ = rti_step(rp.F, cfg, st_gpu, xs[:lanes])
    rp_c = rti_path(cpu)
    sol_c, _ = rti_step(rp_c.F, rp_c.config, _to(st_gpu, cpu), xs[:lanes].cpu())
    du = (sol_g.u0.cpu() - sol_c.u0).abs().max().item()
    dX = (sol_g.X_opt.cpu() - sol_c.X_opt).abs().max().item()
    log(f"[rti] card vs CPU, one cycle at {lanes} lanes: max|du0|={du:.3e} "
        f"max|dX_opt|={dX:.3e} (atol 1e-3)")
    if du > 1e-3 or dX > 1e-3:
        raise RuntimeError("the card's RTI cycle disagrees with the CPU reference")

    # closed-loop landing as scripts/demo_landing.py flies it: every lane
    # tracks its own cubic descent reference
    steps = 110
    x0s = fleet_x0(BATCH, dev)
    ref = pad_reference(cubic_descent_reference(x0s, rp.x_target, steps - 10, DT), cfg.N + 20)
    t0 = time.time()
    out = rti_closed_loop(rp.F, cfg, x0s, rp.x_target, steps, X_ref_full=ref)
    torch.cuda.synchronize(dev)
    land = _judge("rti landing", out["x_final"], out["landed"], steps, time.time() - t0)
    return dict(launches=launches, ms_per_cycle=dev_ms, host_ms_per_cycle=host_ms,
                solves_per_s=BATCH * 1000.0 / host_ms, landing=land)


def phase_pretrain(dev=torch.device("cuda")):
    """Path B: the production GP fit on the card, then the GP-MPC landing
    with that GP."""
    from gpmpc_tpu_torch.gp import sparse_lml
    from gpmpc_tpu_torch.main_path import pretrain_path
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    episodes, episode_len = 4, 64
    K.LAUNCHES = 0  # counts from here on are this path's
    t0 = time.time()
    gp, mean_fn, var_fn = pretrain_path(torch.Generator(device=dev).manual_seed(2),
                                        dev, n_episodes=episodes, episode_len=episode_len)
    torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    launches = K.LAUNCHES
    # the episodes' QP is the sparse form, n = 207, m = 354, all rows dense:
    # four chunks of 25 a cycle, every one an adapt chunk (no early exit)
    variant = K.variant(207, 354, 0, episodes)
    if variant != "cluster" or launches != 4 * episode_len:
        raise RuntimeError(f"pretraining launched the {variant} variant {launches} times, "
                           f"expected the cluster one {4 * episode_len} times")
    g = gp.gp
    k0, ln0 = gp.initial_hyperparameters()
    lml = sparse_lml(g.kernels, g.Z, g.X, g.Y, g.mask, g.log_noise, g.method)
    lml0 = sparse_lml(k0, g.Z, g.X, g.Y, g.mask, ln0, g.method)
    log(f"[pretrain] {episodes} episodes x {episode_len} cycles + fit + tuning in {seconds:.2f} s: "
        f"{int(gp.buffer.count)} points, {g.Z.shape[0]} inducing, admm_chunk launches {launches} "
        f"({variant} variant, {K.cluster_size(207, 354, 0, episodes)} CTAs a lane); LML per output untuned {[round(v, 2) for v in lml0.tolist()]} "
        f"tuned {[round(v, 2) for v in lml.tolist()]}")
    if not bool(torch.isfinite(lml).all()) or bool((lml < lml0).any()):
        raise RuntimeError("the tuned marginal likelihood is worse than the untuned one")
    K.LAUNCHES = 0
    land = phase_landing((mean_fn, var_fn), dev, tag="pretrained landing")
    if K.LAUNCHES < land["steps"]:
        raise RuntimeError("the pretrained landing did not go through the kernel")
    return dict(launches=launches, seconds=seconds, landing=land,
                landing_launches=K.LAUNCHES), gp


def phase_calibration(gp, dev=torch.device("cuda")):
    """Path C: the bound-riding GP-MPC cycle of the chance-constraint
    calibration campaign, with the production GP as the campaign flies it."""
    from gpmpc_tpu_torch.main_path import (calibration_cycle, calibration_path, calibration_x0,
                                           fly_calibration, gp_fns, with_gust_variance)
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
    from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg, _n_rows
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    cp = calibration_path(dev)
    cfg = cp.config
    mean_fn, var_raw = gp_fns(gp)
    var_fn = with_gust_variance(var_raw, cp.gust_sigma)
    segs, m = _condensed_admm_cfg(cfg.base).row_structure, _n_rows(cfg.base)
    variant = K.variant(N * 3, m, N * 3, BATCH)
    if segs != (("blt", 5, 28, 12), ("diag", 60)) or m != 200 or variant != "shared":
        raise RuntimeError(f"the calibration QP is {segs}, m = {m}, variant {variant}")
    x0s = calibration_x0(torch.Generator(device=dev).manual_seed(7), BATCH, dev)
    cycle = calibration_cycle(cp, mean_fn, var_fn, x0s,
                              torch.Generator(device=dev).manual_seed(11))

    cycles = 15
    state = gp_mpc_init(cfg, x0s, cp.x_target, device=dev)
    sol, state, xs, dev_ms, host_ms, launches = _time_cycles(
        cycle, state, x0s, cycles, dev, "the calibration path")
    if launches != cycles:
        raise RuntimeError(f"admm_chunk launched {launches} times in {cycles} calibration "
                           f"cycles, expected {cycles}")
    log(f"[calibration] {cycles} cycles x {BATCH} lanes: {dev_ms:.3f} ms/cycle (CUDA events), "
        f"{host_ms:.3f} ms/cycle (host clock), {BATCH * 1000.0 / host_ms:.1f} solves/s; "
        f"admm_chunk launches {launches} (1/cycle, {variant} variant); "
        f"accepted {float(sol.success.float().mean()):.4f}")

    lanes = 8
    cpu = torch.device("cpu")
    st_gpu, x_gpu = _first_lanes(state, lanes), xs[:lanes]
    sol_g, _ = gp_mpc_solve(cp.F, mean_fn, var_fn, cfg, st_gpu, x_gpu)
    cp_c = calibration_path(cpu)
    mean_c, var_c = gp_fns(_to(gp, cpu))
    sol_c, _ = gp_mpc_solve(cp_c.F, mean_c, with_gust_variance(var_c, cp.gust_sigma),
                            cp_c.config, _to(st_gpu, cpu), x_gpu.cpu())
    du = (sol_g.u0.cpu() - sol_c.u0).abs().max().item()
    dX = (sol_g.X_opt.cpu() - sol_c.X_opt).abs().max().item()
    log(f"[calibration] card vs CPU, one cycle at {lanes} lanes: max|du0|={du:.3e} "
        f"max|dX_opt|={dX:.3e} (atol 1e-3)")
    if du > 1e-3 or dX > 1e-3:
        raise RuntimeError("the card's calibration cycle disagrees with the CPU reference")

    K.LAUNCHES = 0
    t0 = time.time()
    obs = fly_calibration(cp, mean_fn, var_fn, x0s, torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize(dev)
    log(f"[calibration] flight of {BATCH} lanes in {time.time() - t0:.1f} s "
        f"({K.LAUNCHES} launches): {json.dumps(obs)}")
    if not obs["finite"]:
        raise RuntimeError("non-finite iterate in the calibration flight")
    if not (obs["calibrated"] and obs["coverage_calibrated"]):
        raise RuntimeError(
            f"the calibration flight misses the campaign's gate at confidence "
            f"{obs['confidence']}: violation upper bound {obs['realized_upper95']:.5f} "
            f"(limit {1 - obs['confidence'] + 0.01:.2f}), one-step coverage "
            f"{obs['one_step_coverage']:.4f} (target {2 * obs['confidence'] - 1:.2f} +- 0.05)")
    return dict(launches=launches, ms_per_cycle=dev_ms, host_ms_per_cycle=host_ms,
                solves_per_s=BATCH * 1000.0 / host_ms, flight=obs, flight_launches=K.LAUNCHES)


def phase_sixdof(dev=torch.device("cuda")):
    """Path D: the 6-DoF GP fit on the card, the 512-lane 6-DoF GP-MPC cycle,
    and the 150-step landing campaign with that GP."""
    from gpmpc_tpu_torch.experiments import OUTCOME_NAMES
    from gpmpc_tpu_torch.gp import sparse_lml
    from gpmpc_tpu_torch.main_path import (SIXDOF_CHUNK, SIXDOF_ITERS, fly_sixdof, gp_fns,
                                           sixdof_fleet_x0, sixdof_flight_x0, sixdof_path,
                                           sixdof_pretrain_path)
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve
    from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg, _n_rows
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    # the GP fit: six 64-step episodes of the sparse-form 6-DoF RTI
    # controller (the campaign's count, run_campaign_tpu.py:301-303; the
    # bench fits four), n = 269, m = 493, no row declared: the cluster variant
    episodes, episode_len = 6, 64
    K.LAUNCHES = 0  # counts from here on are this path's
    t0 = time.time()
    gp, mean_fn, var_fn = sixdof_pretrain_path(torch.Generator(device=dev).manual_seed(2), dev,
                                               n_episodes=episodes, episode_len=episode_len)
    torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    pre_launches = K.LAUNCHES
    variant, ctas = K.variant(269, 493, 0, episodes), K.cluster_size(269, 493, 0, episodes)
    if variant != "cluster" or not episode_len <= pre_launches <= 4 * episode_len:
        raise RuntimeError(f"the 6-DoF pretraining launched the {variant} variant {pre_launches} "
                           f"times, expected the cluster one {episode_len} to {4 * episode_len} times")
    (kt0, lnt0), (kr0, lnr0) = gp.initial_hyperparameters()
    lml, lml0 = [], []
    for g, k0, ln0 in ((gp.trans_gp, kt0, lnt0), (gp.rot_gp, kr0, lnr0)):
        lml += sparse_lml(g.kernels, g.Z, g.X, g.Y, g.mask, g.log_noise, g.method).tolist()
        lml0 += sparse_lml(k0, g.Z, g.X, g.Y, g.mask, ln0, g.method).tolist()
    log(f"[sixdof] pretrain_gp_6dof: {episodes} episodes x {episode_len} cycles + 2 fits + tuning "
        f"in {seconds:.2f} s: {int(gp.buffer_count)} points, {gp.trans_gp.Z.shape[0]} inducing, "
        f"admm_chunk launches {pre_launches} ({variant} variant, {ctas} CTAs a lane); LML per "
        f"output [d_v; d_w] untuned {[round(v, 2) for v in lml0]} tuned {[round(v, 2) for v in lml]}")
    if not all(np.isfinite(lml)) or any(a < b for a, b in zip(lml, lml0)):
        raise RuntimeError("a tuned 6-DoF marginal likelihood is non-finite or worse than untuned")

    # the timed cycle: bench.py's 6-DoF fleet and configuration
    sp = sixdof_path(dev)
    cfg = sp.config
    segs, m = _condensed_admm_cfg(cfg.base).row_structure, _n_rows(cfg.base)
    cyc_variant = K.variant(N * 3, m, N * 3, BATCH)
    if segs != (("blt", 5, 28, 12), ("diag", 60)) or m != 200 or cyc_variant != "shared":
        raise RuntimeError(f"the 6-DoF QP is {segs}, m = {m}, variant {cyc_variant}")
    xs = sixdof_fleet_x0(torch.Generator(device=dev).manual_seed(7), BATCH, dev)
    state = gp_mpc_init(cfg, xs, sp.x_target, device=dev)

    def cycle(state, xs):
        sol, state = gp_mpc_solve(sp.F, mean_fn, var_fn, cfg, state, xs)
        return sol, state, sp.F_true(xs, sol.u0)

    cycles = 20
    sol, state, xs, dev_ms, host_ms, launches = _time_cycles(
        cycle, state, xs, cycles, dev, "the 6-DoF path")
    chunks = SIXDOF_ITERS // SIXDOF_CHUNK
    if not cycles <= launches <= chunks * cycles:  # the second chunk is skipped when all converge
        raise RuntimeError(f"admm_chunk launched {launches} times in {cycles} 6-DoF cycles, "
                           f"expected {cycles} to {chunks * cycles}")
    log(f"[sixdof] {cycles} cycles x {BATCH} lanes: {dev_ms:.3f} ms/cycle (CUDA events), "
        f"{host_ms:.3f} ms/cycle (host clock), {BATCH * 1000.0 / host_ms:.1f} solves/s; "
        f"admm_chunk launches {launches} ({launches / cycles:.2f}/cycle, {cyc_variant} variant); "
        f"accepted {float(sol.success.float().mean()):.4f}")

    lanes = 8
    cpu = torch.device("cpu")
    st_gpu, x_gpu = _first_lanes(state, lanes), xs[:lanes]
    sol_g, _ = gp_mpc_solve(sp.F, mean_fn, var_fn, cfg, st_gpu, x_gpu)
    sp_c = sixdof_path(cpu)
    mean_c, var_c = gp_fns(_to(gp, cpu))
    sol_c, _ = gp_mpc_solve(sp_c.F, mean_c, var_c, sp_c.config, _to(st_gpu, cpu), x_gpu.cpu())
    du = (sol_g.u0.cpu() - sol_c.u0).abs().max().item()
    dX = (sol_g.X_opt.cpu() - sol_c.X_opt).abs().max().item()
    log(f"[sixdof] card vs CPU, one cycle at {lanes} lanes: max|du0|={du:.3e} "
        f"max|dX_opt|={dX:.3e} (atol 1e-3)")
    if du > 1e-3 or dX > 1e-3:
        raise RuntimeError("the card's 6-DoF cycle disagrees with the CPU reference")

    # the landing campaign as scripts/run_campaign_tpu.py --model 6dof
    # --controller gp_mpc --rt flies it, with the bench's elided rows
    x0s = sixdof_flight_x0(torch.Generator(device=dev).manual_seed(0), BATCH, dev)
    K.LAUNCHES = 0
    t0 = time.time()
    res, stats = fly_sixdof(sp, mean_fn, var_fn, x0s)
    torch.cuda.synchronize(dev)
    flight_s, flight_launches = time.time() - t0, K.LAUNCHES
    ok = res["outcome"] == 0
    v, err = res["landing_speed"], res["landing_error"]
    counts = {k: int(c) for k, c in stats["outcome_counts"].items()}
    flight = dict(success_share=float(stats["success_rate"]),
                  landing_speed_mean=float(stats["landing_speed_mean"]),
                  landing_speed_worst=float(v[ok].max()) if bool(ok.any()) else float("nan"),
                  landing_error_mean=float(stats["landing_error_mean"]),
                  fuel_used_mean=float(stats["fuel_used_mean"]),
                  steps_mean=float(stats["steps_mean"]), outcome_counts=counts,
                  seconds=flight_s, launches=flight_launches)
    log(f"[sixdof] campaign of {BATCH} lanes, up to 150 steps, in {flight_s:.1f} s "
        f"({flight_launches} launches): {json.dumps(flight)}; the JAX package's artifact "
        f"(TPU v5e, campaign_gpmpc6dof_*): touchdown error 0.0102 m")
    bad = (~ok).nonzero()[:, 0][:8].tolist()
    for i in bad:  # the lanes that did not land, for a rehearsal in both packages
        xf = res["x_final"][i]
        log(f"[sixdof] lane {i}: {OUTCOME_NAMES[int(res['outcome'][i])]} after "
            f"{int(res['steps'][i])} steps, x0 {[round(v, 6) for v in x0s[i].tolist()]}, "
            f"touchdown |v| {float(v[i]):.4f} m/s, error {float(err[i]):.4f} m, "
            f"|w| {float(xf[11:].norm()):.4f} rad/s, q {[round(v, 4) for v in xf[7:11].tolist()]}")
    if not all(np.isfinite([flight["landing_speed_mean"], flight["landing_error_mean"]])):
        raise RuntimeError("non-finite 6-DoF campaign statistics")
    if flight["success_share"] < SIXDOF_SUCCESS:
        raise RuntimeError(f"the 6-DoF campaign's success share {flight['success_share']:.4f} "
                           f"is under {SIXDOF_SUCCESS} (failing lanes above)")
    return dict(pretrain_s=seconds, pretrain_launches=pre_launches, lml=lml, launches=launches,
                ms_per_cycle=dev_ms, host_ms_per_cycle=host_ms,
                solves_per_s=BATCH * 1000.0 / host_ms, du0=du, flight=flight)


def _online_window(cstep, F_true, st, xs, k0, cycles):
    """``cycles`` online cycles + plant steps from cycle index k0."""
    for k in range(k0, k0 + cycles):
        u0, st = cstep(st, xs, k)
        xs = F_true(xs, u0)
    return st, xs


def phase_online(dev=torch.device("cuda")):
    """Path E: the online-learning GP-MPC cycle timed as bench.py times it,
    the per-cycle observe alone, and the 3-DoF and 6-DoF online campaigns."""
    from gpmpc_tpu_torch.experiments import OUTCOME_NAMES
    from gpmpc_tpu_torch.gp import (OnlineGPUpdater, OnlineUpdateConfig, ResidualCollector,
                                    Simple3DoFFeatureExtractor)
    from gpmpc_tpu_torch.learning.online_gp_mpc import _refit_recent
    from gpmpc_tpu_torch.main_path import (fleet_x0, fly_online, online_flight_path,
                                           online_flight_x0, online_path)
    from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg, _n_rows
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    # the timed cycle (bench.py:277-322): a first window fills the buffers,
    # then windows of 40 cycles replay that snapshot (k = 40..79: refits at
    # k = 49, 69 and refreshes at k = 59, 79 in each)
    op = online_path(dev)
    cinit, cstep = op.controller()
    x0s = fleet_x0(BATCH, dev)
    window, windows = 40, 3
    t0 = time.time()
    st, xs = _online_window(cstep, op.F_true, cinit(x0s), x0s, 0, window)
    torch.cuda.synchronize(dev)
    warm_s = time.time() - t0
    K.LAUNCHES = 0  # counts from here on are this path's
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    for _ in range(windows):
        st_w, xs_w = _online_window(cstep, op.F_true, st, xs, window, window)
    end.record()
    torch.cuda.synchronize(dev)
    cycles = windows * window
    host_ms = (time.time() - t0) * 1e3 / cycles
    dev_ms = start.elapsed_time(end) / cycles
    launches = K.LAUNCHES
    variant = K.variant(N * 3, N * 3, N * 3, BATCH)
    if launches != cycles:
        raise RuntimeError(f"admm_chunk launched {launches} times in {cycles} online cycles, "
                           f"expected {cycles}")
    for name, t in (("x", xs_w), ("state.mpc.X_lin", st_w.mpc.X_lin), ("gp.c", st_w.gp.gp.c)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite {name} on the online path")
    n_refits, gp_points = int(st_w.n_refits[0]), float(st_w.gp.buffer_count.float().mean())
    if n_refits != 8 or not bool((st_w.n_refits == n_refits).all()):
        raise RuntimeError(f"the online cycle refit {n_refits} times in 80 cycles, expected 8")
    log(f"[online] first window of {window} cycles in {warm_s:.1f} s; {windows} windows of "
        f"{window} cycles x {BATCH} lanes: {dev_ms:.3f} ms/cycle (CUDA events), {host_ms:.3f} "
        f"ms/cycle (host clock), {BATCH * 1000.0 / host_ms:.1f} solves/s; admm_chunk launches "
        f"{launches} ({launches / cycles:.2f}/cycle, {variant} variant); at cycle 80: n_refits "
        f"{n_refits}, gp_points mean {gp_points:.2f}, n_accepted mean "
        f"{float(st_w.n_accepted.float().mean()):.2f}")

    # ten cycles of the first lanes from the snapshot, on the card and on the
    # CPU (its plain chunk), both on the card's flown transitions (the state
    # it measures and the control it flew). The last cycle (k = 49) refits on
    # the latest 32 points, a refit so ill-conditioned in f32 (c and Luu⁻¹
    # reach 1e2-1e3) that two f32 runs need not agree on its u0 to 1e-3: that
    # cycle is held by its refitted posterior (1% of its scale), and its u0
    # is shown beside the spread of the CPU's own u0 when its buffered
    # features change by a relative 1e-7 (about one ulp)
    lanes, cpu = 8, torch.device("cpu")
    sg, xg = _first_lanes(st, lanes), xs[:lanes]
    sc = _to(sg, cpu)
    _, cstep_c = online_path(cpu).controller()
    dus = []
    for k in range(window, window + 10):
        sc_pre = sc
        ug, sg = cstep(sg, xg, k)
        uc, sc = cstep_c(sc, xg.cpu(), k)
        dus.append((ug.cpu() - uc).abs().max().item())
        sc = dataclasses.replace(sc, u_prev=ug.cpu())
        x_pre, xg = xg.cpu(), op.F_true(xg, ug)
    gen, spread = torch.Generator().manual_seed(0), []
    for _ in range(3):
        buf = sc_pre.gp.buffer
        X = buf.X * (1.0 + 1e-7 * torch.randn(buf.X.shape, generator=gen))
        nudged = dataclasses.replace(sc_pre, gp=dataclasses.replace(
            sc_pre.gp, buffer=dataclasses.replace(buf, X=X)))
        spread.append((cstep_c(nudged, x_pre, window + 9)[0] - uc).abs().max().item())
    m_g = sg.gp.predict_gated(xg, ug)[0].cpu()
    m_c = sc.gp.predict_gated(xg.cpu(), ug.cpu())[0]
    dmean = ((m_g - m_c).abs().max() / m_c.abs().max()).item()
    # the same refit in float64 on the CPU's buffers: how far f32 lands
    m_64 = _refit_recent(_to(sc.gp, cpu, torch.float64)).predict_gated(
        xg.cpu().double(), ug.cpu().double())[0]
    dmean64 = ((m_c - m_64).abs().max() / m_64.abs().max()).item()
    du = max(dus[:-1])
    same = bool(torch.equal(sg.gp.buffer.count.cpu(), sc.gp.buffer.count))
    log(f"[online] card vs CPU, 10 cycles at {lanes} lanes from cycle {window}: max|du0| by cycle "
        f"{[f'{d:.2e}' for d in dus]} (atol 1e-3 but at the refit, k = {window + 9}, where the "
        f"CPU's own u0 moves by {[f'{d:.2e}' for d in spread]} under a 1e-7 relative change of "
        f"its buffered features); refitted posterior means apart by {dmean:.2e} of their scale "
        f"(limit 1e-2), the CPU's f32 one {dmean64:.2e} from the same refit in float64; buffer "
        f"counts equal: {same}")
    if du > 1e-3 or dmean > 1e-2 or not same:
        raise RuntimeError("the card's online cycles disagree with the CPU reference")

    # the per-cycle observe alone (bench.py:244-275): residual, features,
    # novelty-gated insert and cadence flags, 512 updaters of capacity 256
    coll, ex = ResidualCollector(dt=DT), Simple3DoFFeatureExtractor()
    u = torch.tensor([2.0, 0.0, 0.0], device=dev).expand(BATCH, 3)
    steps = 50

    def observe_window(upd, xs):
        for _ in range(steps):
            r = coll.residual(op.F, xs, u, op.F_true(xs, u))
            upd, _, _ = upd.observe(ex.extract(xs, u), r)
            xs = xs + 0.01  # drift the queries so inserts stay novel
        return upd

    upd = observe_window(OnlineGPUpdater.create(OnlineUpdateConfig(capacity=256), ex.n_features,
                                                3, device=dev, lanes=BATCH), x0s)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(windows):
        upd_w = observe_window(upd, x0s + 0.1)  # replay from the part-filled snapshot
    end.record()
    torch.cuda.synchronize(dev)
    obs_ms = start.elapsed_time(end) / (windows * steps)
    obs_us_lane = obs_ms * 1e3 / BATCH
    log(f"[online] observe alone, {BATCH} updaters of capacity 256: {obs_ms:.4f} ms/cycle "
        f"(CUDA events), {obs_us_lane:.4f} us a lane; buffer counts after a window "
        f"{int(upd_w.buffer.count.min())}-{int(upd_w.buffer.count.max())}")

    # the online campaigns (run_campaign_tpu.py --controller online_gp_mpc --elide)
    flights = {}
    for model in ("3dof", "6dof"):
        fp = online_flight_path(model, dev)
        base = fp.config.mpc.base
        segs, m = _condensed_admm_cfg(base).row_structure, _n_rows(base)
        fvariant = K.variant(N * 3, m, N * 3, BATCH)
        if fvariant != {"3dof": "register", "6dof": "shared"}[model]:
            raise RuntimeError(f"the {model} online QP ({segs}, m = {m}) picks the {fvariant} variant")
        x0f = online_flight_x0(model, torch.Generator(device=dev).manual_seed(0), BATCH, dev)
        K.LAUNCHES = 0
        t0 = time.time()
        res, stats, trace = fly_online(fp, x0f)
        torch.cuda.synchronize(dev)
        flight_s, flight_launches = time.time() - t0, K.LAUNCHES
        loop_cycles = int(res["steps"].max())
        chunks = base.admm.max_iter // base.admm.check_interval
        if not loop_cycles <= flight_launches <= chunks * loop_cycles:
            raise RuntimeError(f"the {model} online campaign launched the kernel {flight_launches} "
                               f"times in {loop_cycles} cycles, expected {loop_cycles} to "
                               f"{chunks * loop_cycles}")
        ok = res["outcome"] == 0
        v = res["landing_speed"]
        flight = dict(success_share=float(stats["success_rate"]),
                      landing_speed_mean=float(stats["landing_speed_mean"]),
                      landing_speed_worst=float(v[ok].max()) if bool(ok.any()) else float("nan"),
                      landing_error_mean=float(stats["landing_error_mean"]),
                      fuel_used_mean=float(stats["fuel_used_mean"]),
                      steps_mean=float(stats["steps_mean"]),
                      outcome_counts={k: int(c) for k, c in stats["outcome_counts"].items()},
                      rows=[list(sg_) for sg_ in segs], m=m, variant=fvariant,
                      seconds=flight_s, cycles=loop_cycles, launches=flight_launches,
                      **{k: trace[k] for k in trace if k != "err_curve_by5"})
        log(f"[online] {model} campaign of {BATCH} lanes, up to {fp.sim.max_steps} steps, in "
            f"{flight_s:.1f} s: {json.dumps(flight)}")
        log(f"[online] {model} model error every 5 cycles: "
            f"{[None if e is None else round(e, 5) for e in trace['err_curve_by5']]}")
        for i in (~ok).nonzero()[:, 0][:8].tolist():
            log(f"[online] {model} lane {i}: {OUTCOME_NAMES[int(res['outcome'][i])]} after "
                f"{int(res['steps'][i])} steps, x0 {[round(a, 6) for a in x0f[i].tolist()]}, "
                f"touchdown |v| {float(v[i]):.4f} m/s, error {float(res['landing_error'][i]):.4f} m")
        floor_s, floor_r = ONLINE_FLOORS[model]
        if not all(np.isfinite([flight["landing_speed_mean"], flight["model_err_reduction_x"]])):
            raise RuntimeError(f"non-finite {model} online campaign statistics")
        if flight["success_share"] < floor_s or flight["model_err_reduction_x"] < floor_r:
            raise RuntimeError(
                f"the {model} online campaign misses its floor: success share "
                f"{flight['success_share']:.4f} (floor {floor_s}), model-error reduction "
                f"{flight['model_err_reduction_x']:.3f}x (floor {floor_r}x)")
        flights[model] = flight
    return dict(launches=launches, ms_per_cycle=dev_ms, host_ms_per_cycle=host_ms,
                solves_per_s=BATCH * 1000.0 / host_ms, n_refits=n_refits, gp_points=gp_points,
                du0=du, du0_refit=dus[-1], du0_refit_cpu_spread=max(spread),
                refit_mean_rel=dmean, refit_mean_rel_f64=dmean64, observe_us_per_lane=obs_us_lane, flights=flights)


def fleet_artifact(model):
    """The JAX package's published fleet campaign (a TPU v5e record)."""
    name = {"3dof": "campaign_fleet_gplearn_3dof_128.json",
            "6dof": "campaign_fleet_gplearn_6dof_64.json"}[model]
    with open(os.path.join(ROOT, "artifacts", name)) as f:
        art = json.load(f)
    keys = ("model_err_by_round", "model_err_final_over_first", "lanes_improved",
            "landed_by_round", "success_by_round", "touchdown_speed_median_by_round", "wall_s")
    return {k: art[k] for k in keys}


def _fleet_vs_cpu(fp, gps, use_gp, x0s, lanes, gen):
    """The first 10 cycles of a round flown on the card from ``lanes`` lanes'
    GPs, teacher-forced from the card's kernel run, each cycle also run on
    the card through the plain chunk and on the CPU, and on the CPU under
    four relative 1e-7 (about one ulp) changes of the state; then the whole
    round of those lanes on the card (kernel and plain) and on the CPU
    (as flown, and from three such changes of the initial states). The
    changed copies fly side by side as extra lanes of one CPU batch. Returns
    the readings: per cycle kernel−CPU, plain−CPU, kernel−plain and the
    CPU's own spread of u0; per lane the model error's relative distances."""
    from gpmpc_tpu_torch.learning.batched_learner import (_gated_fns, fleet_cycle,
                                                          fleet_episode, fleet_reference)
    from gpmpc_tpu_torch.main_path import fleet_learning_path
    from gpmpc_tpu_torch.mpc import gp_mpc_init

    dev, cpu = x0s.device, torch.device("cpu")
    fp_c = fleet_learning_path(fp.model, cpu)
    base = fp.mpc.base
    mpc_off = fp.mpc.replace(base=base.replace(admm=dataclasses.replace(base.admm,
                                                                         use_pallas="off")))
    x0g, use_g = x0s[:lanes], use_gp[:lanes]
    gps_g = _first_lanes(gps, lanes)
    gps_c, x0c, use_c = _to(gps_g, cpu), x0g.cpu(), use_g.cpu()
    n_x = x0s.shape[-1]
    xr_g = fleet_reference(x0g, fp.x_target, fp.config, base.N)
    own_r = 4  # changed copies of the state per cycle
    cyc = {"kernel": fleet_cycle(fp.F, fp.plant, fp.mpc, *_gated_fns(gps_g, use_g, n_x), xr_g),
           "plain": fleet_cycle(fp.F, fp.plant, mpc_off, *_gated_fns(gps_g, use_g, n_x), xr_g),
           "cpu": fleet_cycle(fp_c.F, fp_c.plant, fp_c.mpc, *_gated_fns(gps_c, use_c, n_x),
                              xr_g.cpu()),
           "own": fleet_cycle(fp_c.F, fp_c.plant, fp_c.mpc,
                              *_gated_fns(_repeat_lanes(gps_c, own_r), use_c.repeat(own_r), n_x),
                              xr_g.cpu().repeat(own_r, 1, 1))}
    ulp = lambda x: x * (1 + 1e-7 * torch.randn(x.shape, generator=gen))
    sg, xg = gp_mpc_init(fp.mpc, x0g, fp.x_target, device=dev), x0g
    du = {k: [] for k in ("kernel_cpu", "plain_cpu", "kernel_plain", "cpu_own")}
    for k in range(10):
        sc, xc = _to(sg, cpu), xg.cpu()
        sol_p = cyc["plain"](sg, xg, k)[0]
        sol_g, sg_next, xn = cyc["kernel"](sg, xg, k)
        uc = cyc["cpu"](sc, xc, k)[0].u0
        uo = cyc["own"](_repeat_lanes(sc, own_r), ulp(xc.repeat(own_r, 1)), k)[0].u0
        du["kernel_cpu"].append((sol_g.u0.cpu() - uc).abs().max().item())
        du["plain_cpu"].append((sol_p.u0.cpu() - uc).abs().max().item())
        du["kernel_plain"].append((sol_g.u0 - sol_p.u0).abs().max().item())
        du["cpu_own"].append((uo - uc.repeat(own_r, 1)).abs().max().item())
        sg, xg = sg_next, xn

    def episode(f, mpc, g, use, x0):
        return fleet_episode(f.F, f.plant, mpc, g, use, x0, f.x_target, f.config)

    ep_c = episode(fp_c, fp_c.mpc, gps_c, use_c, x0c)
    rel = lambda e, r=1: ((e["model_err"].cpu() - ep_c["model_err"].repeat(r)).abs()
                          / ep_c["model_err"].repeat(r).abs()).max().item()
    ep_g, ep_p = episode(fp, fp.mpc, gps_g, use_g, x0g), episode(fp, mpc_off, gps_g, use_g, x0g)
    ep_o = episode(fp_c, fp_c.mpc, _repeat_lanes(gps_c, 3), use_c.repeat(3), ulp(x0c.repeat(3, 1)))
    return dict(
        du0=du, cpu=ep_c, kernel=ep_g,
        err_rel={"kernel_cpu": rel(ep_g), "plain_cpu": rel(ep_p), "cpu_own": rel(ep_o, 3)},
        err_mean_rel=abs(float(ep_g["model_err"].mean()) / float(ep_c["model_err"].mean()) - 1),
        landed_equal=all(bool(torch.equal(e["landed"].cpu(), ep_c["landed"]))
                         for e in (ep_g, ep_p)),
        speed_abs=(ep_g["speed"].cpu() - ep_c["speed"]).abs().max().item())


def phase_fleet(dev=torch.device("cuda")):
    """Path F: the 3-DoF and 6-DoF fleet-learning campaigns, the episode
    cycle timed on the GPs their second round flew with, and 10 cycles and
    a round of 8 lanes held against the CPU."""
    return {model: _fleet_model(model, expect, dev)
            for model, expect in (("3dof", "cluster"), ("6dof", "shared"))}


def _fleet_model(model, expect, dev):
    from gpmpc_tpu_torch.learning.batched_learner import _gated_fns, fleet_cycle, fleet_reference
    from gpmpc_tpu_torch.main_path import (FLEET_LANES, fleet_learning_path, fleet_learning_x0,
                                           fly_fleet)
    from gpmpc_tpu_torch.mpc import gp_mpc_init
    from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg, _n_rows
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    fp = fleet_learning_path(model, dev)
    base, B = fp.mpc.base, FLEET_LANES[model]
    n = base.N * base.n_u + (0 if base.condensed else (base.N + 1) * base.n_x)
    m = _n_rows(base)
    segs = _condensed_admm_cfg(base).row_structure if base.condensed else None
    mg = sum(sg[1] for sg in segs if sg[0] == "diag") if segs else 0
    variant = K.variant(n, m, mg, B)
    log(f"[fleet] {model}: {B} lanes, QP n = {n}, m = {m}, rows {segs}, "
        f"{base.admm.max_iter} iterations in chunks of {base.admm.check_interval}: "
        f"{variant} variant, {K.cluster_size(n, m, mg, B)} CTAs a lane")
    if variant != expect:
        raise RuntimeError(f"the {model} fleet's QP picks the {variant} variant, "
                           f"expected {expect}")
    x0s = fleet_learning_x0(model, torch.Generator(device=dev).manual_seed(0), B, dev)

    # the campaign: 3 rounds of 110 steps, refit barrier, retune every 2
    K.LAUNCHES = 0
    t0 = time.time()
    out, summ = fly_fleet(fp, x0s, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize(dev)
    wall_s, launches = time.time() - t0, K.LAUNCHES
    for name in ("model_err", "touchdown_speed"):
        if not bool(torch.isfinite(out[name]).all()):
            raise RuntimeError(f"non-finite {name} in the {model} fleet")
    log(f"[fleet] {model} campaign, {B} lanes x 3 rounds, in {wall_s:.1f} s "
        f"({launches} launches): {json.dumps(summ)}")
    log(f"[fleet] {model} the JAX package's artifact (a TPU v5e record, the reference's, "
        f"not this card's): {json.dumps(fleet_artifact(model))}")
    if not summ["gate"]:
        raise RuntimeError(
            f"the {model} fleet misses its gate: model error final/first "
            f"{summ['model_err_final_over_first']:.4f} (limit 0.5), landed in the last "
            f"round {summ['landed_by_round'][-1]} (floor {int(0.95 * B)}), every GP "
            f"fitted {summ['gp_fitted_all']}")
    if launches <= 0:
        raise RuntimeError(f"the {model} fleet did not go through the kernel")

    # the episode cycle on the GPs the campaign's second round flew with
    gps, use_gp = out["gps_by_round"][1], out["use_gp_by_round"][1]
    cycle = fleet_cycle(fp.F, fp.plant, fp.mpc, *_gated_fns(gps, use_gp, x0s.shape[-1]),
                        fleet_reference(x0s, fp.x_target, fp.config, base.N))
    step = [0]

    def timed(state, xs):
        step[0] += 1
        return cycle(state, xs, step[0] - 1)

    cycles = 20
    _, _, _, dev_ms, host_ms, cyc_launches = _time_cycles(
        timed, gp_mpc_init(fp.mpc, x0s, fp.x_target, device=dev), x0s, cycles, dev,
        f"the {model} fleet's cycle")
    log(f"[fleet] {model} episode cycle on round 1's GPs ({int(use_gp.sum())}/{B} active), "
        f"{cycles} cycles x {B} lanes: {dev_ms:.3f} ms/cycle (CUDA events), {host_ms:.3f} "
        f"ms/cycle (host clock); admm_chunk launches {cyc_launches} "
        f"({cyc_launches / cycles:.2f}/cycle, {variant} variant)")

    # card vs CPU from the same per-lane GPs: u0 at FLEET_U0_ATOL, the round's
    # per-lane model error at FLEET_ERR_RTOL, each widened to FLEET_WITNESS_X
    # times the largest witness of f32 arithmetic alone (the card's plain
    # chunk, the CPU under a one-ulp change of the state)
    lanes = 8
    v = _fleet_vs_cpu(fp, gps, use_gp, x0s, lanes, torch.Generator().manual_seed(0))
    du, er = v["du0"], v["err_rel"]
    u_lim = max(FLEET_U0_ATOL, FLEET_WITNESS_X * max(du["plain_cpu"] + du["cpu_own"]))
    e_lim = max(FLEET_ERR_RTOL, FLEET_WITNESS_X * max(er["plain_cpu"], er["cpu_own"]))
    fmt = lambda xs: [f"{d:.2e}" for d in xs]
    log(f"[fleet] {model} card vs CPU, 10 cycles of round 1 at {lanes} lanes, max|du0| by cycle: "
        f"kernel-CPU {fmt(du['kernel_cpu'])} (limit {u_lim:.2e}); witnesses: the card's plain "
        f"chunk-CPU {fmt(du['plain_cpu'])}, the CPU under a 1e-7 relative change of the state "
        f"(max of 4) {fmt(du['cpu_own'])}; kernel-plain on the card {fmt(du['kernel_plain'])}")
    log(f"[fleet] {model} round 1 of {lanes} lanes on the card and on the CPU: landed equal "
        f"{v['landed_equal']} ({int(v['cpu']['landed'].sum())}/{lanes}), a lane's model error "
        f"kernel-CPU up to {er['kernel_cpu']:.2e} of its value (limit {e_lim:.2e}); witnesses: "
        f"plain-CPU {er['plain_cpu']:.2e}, the CPU under a 1e-7 relative change of the initial "
        f"states (max of 3) {er['cpu_own']:.2e}; the lanes' mean kernel-CPU "
        f"{v['err_mean_rel']:.2e}; touchdown speed {v['speed_abs']:.2e} m/s (atol 0.05)")
    if max(du["kernel_cpu"]) > u_lim:
        raise RuntimeError(f"the card's {model} fleet cycles disagree with the CPU reference")
    if not v["landed_equal"] or er["kernel_cpu"] > e_lim or v["speed_abs"] > 0.05:
        raise RuntimeError(f"the card's {model} fleet episode disagrees with the CPU reference")
    return dict(summary=summ, wall_s=wall_s, launches=launches, ms_per_cycle=dev_ms,
                host_ms_per_cycle=host_ms, launches_per_cycle=cyc_launches / cycles,
                du0=du, du0_limit=u_lim, episode_model_err_rel=er, episode_model_err_limit=e_lim,
                episode_speed_abs=v["speed_abs"], variant=variant)


def lmpc_artifact(model):
    """The JAX package's published fleet-LMPC campaign (a TPU v5e record)."""
    name = {"3dof": "campaign_fleet_lmpc_tpu_256.json",
            "6dof": "campaign_fleet_lmpc_6dof_tpu_256.json"}[model]
    with open(os.path.join(ROOT, "artifacts", name)) as f:
        art = json.load(f)
    keys = ("final_success_rate", "probe_improves_on_seed", "probe_value_monotone_within_1pct",
            "seed_cost", "probe_lane_costs", "probe_plan_values",
            "touchdown_speed_median_by_round", "wall_s")
    out = {k: art[k] for k in keys}
    out["qp_success_rate_by_round"] = [r["qp_success_rate"] for r in art["per_round"]]
    out["success_by_round"] = [r["success_rate"] for r in art["per_round"]]
    return out


def _lmpc_flight(model, lp, x0s, rounds, floor):
    """One fleet-LMPC campaign, judged by its floors: final success share ≥
    ``floor``, every round ≥ 0.95 of the lanes landed, the probe's realized
    cost under the seed's (3-DoF)."""
    from gpmpc_tpu_torch.main_path import fly_lmpc_fleet
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    K.LAUNCHES = 0
    t0 = time.time()
    res, ss = fly_lmpc_fleet(lp, x0s, rounds=rounds)
    torch.cuda.synchronize()
    wall_s, launches = time.time() - t0, K.LAUNCHES
    B = x0s.shape[0]
    summ = {k: res[k] for k in ("final_success_rate", "probe_improves_on_seed",
                                "probe_value_monotone_within_1pct", "seed_cost",
                                "probe_lane_costs", "probe_plan_values",
                                "touchdown_speed_median_by_round")}
    summ.update(
        success_by_round=[r["success_rate"] for r in res["per_round"]],
        landed_by_round=[r["landed"] for r in res["per_round"]],
        qp_success_rate_by_round=[r["qp_success_rate"] for r in res["per_round"]],
        seconds_by_round=[r["wall_s"] for r in res["per_round"]],
        cycles_by_round=[r["cycles"] for r in res["per_round"]],
        ms_per_step_by_round=[round(r["ms_per_step"], 3) for r in res["per_round"]],
        knn_bucket_by_round=[r["knn_bucket"] for r in res["per_round"]],
        safe_set_states=res["per_round"][-1]["safe_set_states"],
        wall_s=wall_s, launches=launches)
    log(f"[lmpc] {model} campaign, {B} lanes x {rounds} rounds of <= {res['max_steps']} steps, "
        f"solver {res['solver']}, in {wall_s:.1f} s ({launches} chunk launches): {json.dumps(summ)}")
    log(f"[lmpc] {model} the JAX package's artifact (a TPU v5e record, the reference's, "
        f"not this card's): {json.dumps(lmpc_artifact(model))}")
    bad = []
    if res["final_success_rate"] < floor:
        bad.append(f"final success {res['final_success_rate']} under {floor}")
    if min(summ["landed_by_round"]) < 0.95 * B:
        bad.append(f"landed by round {summ['landed_by_round']} under {0.95 * B}")
    if model == "3dof" and not res["probe_improves_on_seed"]:
        bad.append("the probe's cost does not improve on the seed's")
    if bad:
        raise RuntimeError(f"the {model} fleet-LMPC campaign misses its floors: {bad}")
    return summ, res, ss


def phase_lmpc(dev=torch.device("cuda")):
    """Path G, fleet LMPC (``scripts/run_fleet_lmpc_tpu.py``): the 3-DoF and
    6-DoF campaigns on the interior-point solver, a round on the ADMM arm
    (the chunk kernel on the 62-column hull QP), 10 teacher-forced solves of
    8 lanes held against the CPU, and the hull projection of every lane."""
    from gpmpc_tpu_torch.lmpc import lmpc_init, lmpc_solve
    from gpmpc_tpu_torch.main_path import (LMPC_LANES, fly_lmpc_fleet, lmpc_fleet_path,
                                           lmpc_fleet_x0)
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
    from gpmpc_tpu_torch.ops.qp import ADMMConfig
    from gpmpc_tpu_torch.terminal import knn_bucket, knn_query, project_onto_hull, trim

    B = LMPC_LANES
    out = {}
    lp3 = lmpc_fleet_path("3dof", dev)
    x0s = lmpc_fleet_x0(lp3, torch.Generator(device=dev).manual_seed(0), B)
    out["3dof"], res3, ss3 = _lmpc_flight("3dof", lp3, x0s, LMPC_ROUNDS["3dof"],
                                          LMPC_FLOORS["3dof"])
    if out["3dof"]["launches"] != 0:
        raise RuntimeError("the interior-point arm launched the ADMM chunk")

    # card vs CPU: 10 solves of 8 lanes on the final set, teacher forced from
    # the card's flight; u0 within LMPC_U0_ATOL or twice the CPU's own spread
    # under a 1e-7 relative change of the state (4 draws a solve), read here
    view = trim(ss3, knn_bucket(int(ss3.written), ss3.capacity))
    cpu, lanes, own_r = torch.device("cpu"), 8, 4
    lp_c = lmpc_fleet_path("3dof", cpu)
    view_c = _to(view, cpu)
    gen = torch.Generator().manual_seed(0)
    xg = x0s[:lanes]
    sg = lmpc_init(lp3.config, xg, lp3.x_target)
    du, spread = [], []
    for _ in range(10):
        sol_g, sg_next = lmpc_solve(lp3.F, lp3.config, view, sg, xg)
        sc, xc = _to(sg, cpu), xg.cpu()
        uc = lmpc_solve(lp_c.F, lp_c.config, view_c, sc, xc)[0].u0
        xo = xc.repeat(own_r, 1) * (1 + 1e-7 * torch.randn(own_r * lanes, xc.shape[1], generator=gen))
        uo = lmpc_solve(lp_c.F, lp_c.config, view_c, _repeat_lanes(sc, own_r), xo)[0].u0
        du.append((sol_g.u0.cpu() - uc).abs().max().item())
        spread.append((uo - uc.repeat(own_r, 1)).abs().max().item())
        xg, sg = lp3.F(xg, sol_g.u0), sg_next
    u_lim = max(LMPC_U0_ATOL, LMPC_WITNESS_X * max(spread))
    fmt = lambda xs: [f"{d:.2e}" for d in xs]
    log(f"[lmpc] card vs CPU, 10 solves of {lanes} lanes on the final set (bucket "
        f"{view.capacity}), teacher forced: max|du0| by solve {fmt(du)} (limit {u_lim:.2e}); "
        f"the CPU under a 1e-7 relative change of the state (max of {own_r}) {fmt(spread)}")
    if max(du) > u_lim:
        raise RuntimeError("the card's LMPC solves disagree with the CPU reference")
    out["card_vs_cpu"] = dict(du0=du, cpu_own=spread, limit=u_lim)

    # the hull projection of every lane onto its 10 nearest stored states,
    # 0.3 m off its initial state: the ADMM solver on the card (kernel) vs
    # the CPU (plain chunk)
    pts = x0s.clone()
    pts[:, 2] += 0.3
    res = knn_query(view, pts, 10)
    K.LAUNCHES = 0
    hp = project_onto_hull(res.states, pts, res.valid)
    torch.cuda.synchronize()
    hull_launches = K.LAUNCHES
    # the projected point is unique where λ is not: held at
    # tests/test_terminal.py's 2e-3, widened to twice the largest witness of
    # f32 alone read here (the card's plain chunk vs the CPU, and the CPU
    # under a 1e-7 relative change of the points: near-duplicate vertices
    # make the f32 projection ill-conditioned)
    V, pv, vv = res.states.cpu(), pts.cpu(), res.valid.cpu()
    hp_c = project_onto_hull(V, pv, vv)
    hp_p = project_onto_hull(res.states, pts, res.valid,
                             admm=ADMMConfig(max_iter=150, polish=True, use_pallas="off"))
    hp_o = project_onto_hull(V, pv * (1 + 1e-7 * torch.randn(pv.shape, generator=gen)), vv)
    d = lambda h: (h.point.cpu() - hp_c.point).abs().max().item()
    dpt, wit = d(hp), {"plain_cpu": d(hp_p), "cpu_own": d(hp_o)}
    lim = max(2e-3, LMPC_WITNESS_X * max(wit.values()))
    lam_sum = [(h.lam.sum(-1) - 1).abs().max().item() for h in (hp, hp_c)]
    log(f"[lmpc] hull projection of {B} lanes (K = 10, n = 10, m = 11, "
        f"{K.variant(10, 11, 0, B)} variant): {hull_launches} launches, inside "
        f"{int(hp.inside.sum())}/{B}, distance median {float(hp.distance.median()):.4f}; card vs "
        f"CPU max|dpoint| {dpt:.2e} (limit {lim:.2e}; witnesses: the card's plain chunk vs CPU "
        f"{wit['plain_cpu']:.2e}, the CPU under a one-ulp change {wit['cpu_own']:.2e}); "
        f"max|sum lambda - 1| card {lam_sum[0]:.2e}, CPU {lam_sum[1]:.2e}")
    if hull_launches <= 0 or dpt > lim:
        raise RuntimeError("the hull projection disagrees with the CPU or missed the kernel")
    out["hull"] = dict(launches=hull_launches, dpoint=dpt, limit=lim, witnesses=wit,
                       lam_sum_err=lam_sum, inside=int(hp.inside.sum()))

    # one round on the ADMM arm (800 iterations in 32 chunks of 25, polish)
    # against the seed set: the chunk kernel on the 62-column hull QP
    lpa = lmpc_fleet_path("3dof", dev, solver="admm")
    variant = K.variant(62, 168, 45, B)
    if variant == "global":
        raise RuntimeError("the LMPC hull QP lands on the global variant")
    K.LAUNCHES = 0
    t0 = time.time()
    resa, _ = fly_lmpc_fleet(lpa, x0s, rounds=1)
    torch.cuda.synchronize()
    ra = resa["per_round"][0]
    out["admm"] = dict(success_rate=ra["success_rate"], qp_success_rate=ra["qp_success_rate"],
                       landed=ra["landed"], cycles=ra["cycles"], seconds=time.time() - t0,
                       ms_per_step=ra["ms_per_step"], launches=K.LAUNCHES, variant=variant,
                       ctas_per_lane=K.cluster_size(62, 168, 45, B) or 1)
    log(f"[lmpc] ADMM arm, one round of {B} lanes against the seed set: {json.dumps(out['admm'])}")
    if out["admm"]["launches"] <= 0:
        raise RuntimeError("the ADMM arm did not go through the kernel")

    # the 6-DoF campaign: the seed is one RTI-flown landing (the chunk kernel)
    K.LAUNCHES = 0
    t0 = time.time()
    lp6 = lmpc_fleet_path("6dof", dev)
    torch.cuda.synchronize()
    seed_s, seed_launches = time.time() - t0, K.LAUNCHES
    log(f"[lmpc] 6dof seed flight in {seed_s:.1f} s, {lp6.seed[0].shape[0]} live steps, "
        f"cost {float(lp6.seed[2].sum()):.1f}, {seed_launches} chunk launches")
    if seed_launches <= 0:
        raise RuntimeError("the 6-DoF seed flight did not go through the kernel")
    x06 = lmpc_fleet_x0(lp6, torch.Generator(device=dev).manual_seed(0), B)
    out["6dof"], _, _ = _lmpc_flight("6dof", lp6, x06, LMPC_ROUNDS["6dof"], LMPC_FLOORS["6dof"])
    out["6dof"].update(seed_s=seed_s, seed_launches=seed_launches)
    return out


def phase_gpmpc_campaign(dev=torch.device("cuda")):
    """``run_campaign_tpu.py --model 3dof --controller gp_mpc --rt --elide``
    at the artifact's 4096 lanes: the campaign's GP on the drag + wind
    plant, then the 130-step campaign; reported beside the artifact, no
    gate. Returns (the report, the GP's (mean_fn, var_fn))."""
    from gpmpc_tpu_torch.experiments import SimulationConfig, sample_initial_conditions
    from gpmpc_tpu_torch.main_path import (GPMPC_CAMPAIGN_LANES, fly_gpmpc_campaign,
                                           gpmpc_campaign_gp)
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    t0 = time.time()
    _, mean_fn, var_fn = gpmpc_campaign_gp(torch.Generator(device=dev).manual_seed(42), dev)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    x0s = sample_initial_conditions(
        torch.Generator(device=dev).manual_seed(0),
        SimulationConfig(max_steps=130, altitude_mean=30.0, altitude_std=2.0),
        GPMPC_CAMPAIGN_LANES, n_x=7, device=dev)
    K.LAUNCHES = 0
    t0 = time.time()
    _, stats = fly_gpmpc_campaign(mean_fn, var_fn, x0s)
    torch.cuda.synchronize()
    with open(os.path.join(ROOT, "artifacts", "campaign_gpmpc3dof_4096_rt.json")) as f:
        art = json.load(f)
    out = dict(lanes=GPMPC_CAMPAIGN_LANES, fit_s=fit_s, seconds=time.time() - t0,
               launches=K.LAUNCHES, success_share=float(stats["success_rate"]),
               landing_speed_mean=float(stats["landing_speed_mean"]),
               landing_error_mean=float(stats["landing_error_mean"]),
               fuel_used_mean=float(stats["fuel_used_mean"]),
               outcome_counts={k: int(c) for k, c in stats["outcome_counts"].items()})
    log(f"[gpmpc campaign] 3-DoF GP-MPC campaign (--rt --elide) of {GPMPC_CAMPAIGN_LANES} lanes, "
        f"130 steps: {json.dumps(out)}; the JAX package's artifact (TPU v5e): success "
        f"{art['success_rate']}, {art['landing_speed_mean']:.4f} m/s, "
        f"{art['landing_error_mean']:.4f} m")
    return out, (mean_fn, var_fn)


def _artifact(name, keys):
    with open(os.path.join(ROOT, "artifacts", name)) as f:
        art = json.load(f)
    sf = art.get("safety_filter", {})
    return {k: art[k] if k in art else sf[k] for k in keys}


def _reset_launches():
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    K.LAUNCHES = 0
    K.LAUNCHES_BY_SHAPE.clear()


def _launches():
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    return K.LAUNCHES, {f"n{n}_m{m}": c for (n, m), c in sorted(K.LAUNCHES_BY_SHAPE.items())}


def _safety_vs_cpu(dev, lanes=8, cycles=10, own_r=4):
    """The rescue composition's filtered cycle on ``lanes`` lanes flying into
    the downdraft, teacher forced: every cycle the CPU runs the card's
    controller state and measured state (the RTI step, then the filter), and
    again under ``own_r`` relative 1e-7 changes of the state. Returns the
    per-cycle max |Δu| card−CPU on the lanes clear of the threshold
    (|V − α| > 1e-4·α), the CPU's own spread, and whether ``intervened``
    agreed on those lanes."""
    from gpmpc_tpu_torch.main_path import safety_rescue_path
    from gpmpc_tpu_torch.safety import filter_control

    cpu = torch.device("cpu")
    sg_path, sc_path = safety_rescue_path(dev), safety_rescue_path(cpu)
    x = torch.tensor([2.0, 3.0, 0.2, -0.1, -2.5, 0.05, 0.0], device=dev).repeat(lanes, 1)
    x[:, 1] += torch.linspace(0.0, 7.0, lanes, device=dev)
    x[:, 4] -= torch.linspace(0.0, 1.5, lanes, device=dev)
    (cinit, cstep), (_, cstep_c) = sg_path.controller, sc_path.controller
    filt = lambda p, xx, uu: filter_control(p.F_filter, p.backup, p.invariant, p.filter_config,
                                            xx, uu)
    gen = torch.Generator().manual_seed(0)
    alpha = sg_path.invariant.alpha
    st = cinit(x)
    du, spread, same, n_int = [], [], True, 0
    for k in range(cycles):
        sc, xc = _to(st, cpu), x.cpu()
        u_g, st_next = cstep(st, x, k)
        rg = filt(sg_path, x, u_g)
        rc = filt(sc_path, xc, cstep_c(sc, xc, k)[0])
        xo = xc.repeat(own_r, 1) * (1 + 1e-7 * torch.randn(own_r * lanes, 7, generator=gen))
        ro = filt(sc_path, xo, cstep_c(_repeat_lanes(sc, own_r), xo, k)[0])
        clear = (rc.lyapunov_value - alpha).abs() > 1e-4 * alpha
        du.append((rg.u.cpu() - rc.u)[clear].abs().max().item() if bool(clear.any()) else 0.0)
        spread.append((ro.u - rc.u.repeat(own_r, 1)).abs().max().item())
        same = same and bool(torch.equal(rg.intervened.cpu()[clear], rc.intervened[clear]))
        n_int += int(rg.intervened.sum())
        x, st = sg_path.plant(x, rg.u), st_next
    return du, spread, same, n_int


def _filter_latency(dev, batch=BATCH, cycles=10, windows=4):
    """``scripts/bench_safety_filter.py``: the velocity-ellipsoid filter
    (check + intervention QP) on ``batch`` lanes, half of them diving out of
    the envelope, timed in windows of ``cycles`` cycles with CUDA events
    (the state nudged by each cycle's output so every cycle depends on the
    last). Returns (ms per cycle, intervention rate, launches per cycle)."""
    from gpmpc_tpu_torch.dynamics import Rocket3DoFParams, rocket3dof as r3
    from gpmpc_tpu_torch.main_path import velocity_ellipsoid_filter
    from gpmpc_tpu_torch.safety import filter_control

    p = Rocket3DoFParams(device=dev)
    F = lambda x, u: r3.step(p, x, u, DT)
    inv, backup, cfg = velocity_ellipsoid_filter(dev)
    xs = torch.tensor([2.0, 20.0, 0.3, -0.2, -1.5, 0.1, 0.0], device=dev).repeat(batch, 1)
    xs[1::2, 4] = -4.5
    u_nom = torch.tensor([2.0, 0.0, 0.0], device=dev).repeat(batch, 1)

    def window(xs):
        rates = []
        for _ in range(cycles):
            res = filter_control(F, backup, inv, cfg, xs, u_nom)
            xs = xs + 1e-9 * res.u.mean()
            rates.append(res.intervened.float().mean())
        return xs, torch.stack(rates).mean()

    xs, _ = window(xs)  # warm-up
    torch.cuda.synchronize(dev)
    _reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(windows):
        xs, rate = window(xs)
    end.record()
    torch.cuda.synchronize(dev)
    launches, _ = _launches()
    return start.elapsed_time(end) / (windows * cycles), float(rate), launches / (windows * cycles)


def _safety_x0(name, dev):
    """The initial states the JAX package's safety artifacts flew
    (``tests/fixtures/make_safety_x0.py``): "campaign" (1024 lanes) or
    "online" (512), so that every lane's numbers compare like for like."""
    with np.load(os.path.join(ROOT, "tests", "fixtures", "safety_x0.npz")) as f:
        return torch.tensor(f[name], device=dev)


def phase_safety(gp_fns_, dev=torch.device("cuda")):
    """The safety layer: the filter card vs CPU, its latency, and the three
    safety-filtered campaigns, each judged by its own gate, on the initial
    states of the artifacts they are printed beside."""
    from gpmpc_tpu_torch.main_path import (ONLINE_SAFETY_LANES, SAFETY_GPMPC_COMMIT, SAFETY_LANES,
                                           fly_online_safety, fly_safety, online_safety_path,
                                           safety_gpmpc_path, safety_rescue_path)
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K

    out = {}
    fv = K.variant(4, 6, 0, SAFETY_LANES)
    if fv == "global":
        raise RuntimeError("the filter's QP lands on the global variant: repair the picker")

    # card vs CPU, teacher forced, by the witness rule
    du, spread, same, n_int = _safety_vs_cpu(dev)
    lim = max(SAFETY_U_ATOL, SAFETY_WITNESS_X * max(spread))
    fmt = lambda xs: [f"{d:.2e}" for d in xs]
    log(f"[safety] card vs CPU, 10 teacher-forced filtered cycles of the rescue composition, 8 "
        f"lanes ({n_int} interventions): max|du| by cycle {fmt(du)} (limit {lim:.2e}); the CPU "
        f"under a 1e-7 relative change of the state (max of 4) {fmt(spread)}; intervened equal "
        f"on the lanes clear of the threshold: {same}")
    if max(du) > lim or not same or n_int == 0:
        raise RuntimeError("the card's filtered cycles disagree with the CPU reference")
    out["card_vs_cpu"] = dict(du=du, cpu_own=spread, limit=lim, interventions=n_int)

    # the filter's latency per cycle (scripts/bench_safety_filter.py)
    ms, rate, lpc = _filter_latency(dev)
    log(f"[safety] filter latency, {BATCH} lanes (half diving), windows of 10 cycles: {ms:.3f} "
        f"ms/cycle (CUDA events), {ms * 1e3 / BATCH:.3f} us a lane, intervention rate {rate:.2f}, "
        f"{lpc:.2f} kernel launches a cycle ({fv} variant); the reference's budget: 5 ms a "
        f"cycle, no gate")
    out["latency"] = dict(ms_per_cycle=ms, intervention_rate=rate, launches_per_cycle=lpc)

    # the rescue: RTI into the downdraft, with and without the funnel filter
    sp = safety_rescue_path(dev)
    x0s = _safety_x0("campaign", dev)[:SAFETY_LANES]
    _reset_launches()
    res = fly_safety(sp, x0s)
    res["launches"], res["launches_by_shape"] = _launches()
    art = _artifact("campaign_rti3dof_safety_gust_1024.json",
                    ("success_rate", "success_rate_unfiltered", "success_rate_delta",
                     "crash_count_filtered", "crash_count_unfiltered", "intervention_rate",
                     "interventions_per_episode_mean"))
    log(f"[safety] rescue campaign (--controller rti --safety-filter --gust -2.0), "
        f"{SAFETY_LANES} lanes, 150 steps: {json.dumps(res)}")
    log(f"[safety] rescue, the JAX package's artifact (a TPU v5e record, not this card's; its "
        f"--gust is not recorded, -2.0 per tests/test_scripts.py): {json.dumps(art)}")
    if res["launches_by_shape"].get("n4_m6", 0) <= 0 or res["launches_by_shape"].get(
            "n60_m200", 0) <= 0:
        raise RuntimeError("the rescue campaign did not go through the kernel at both shapes")
    if not (res["success_rate_delta"] >= 0.5
            and res["crash_count_filtered"] < res["crash_count_unfiltered"]):
        raise RuntimeError(f"the rescue misses its gate: success delta "
                           f"{res['success_rate_delta']:.4f} (floor 0.5), crashes "
                           f"{res['crash_count_filtered']} filtered vs "
                           f"{res['crash_count_unfiltered']} unfiltered")
    out["rescue"] = res

    # the GP-MPC campaign behind the velocity-ellipsoid filter of ab18305
    mean_fn, var_fn = gp_fns_
    sg = safety_gpmpc_path(mean_fn, var_fn, dev)
    x0g = _safety_x0("campaign", dev)[:SAFETY_LANES]
    _reset_launches()
    resg = fly_safety(sg, x0g)
    resg["launches"], resg["launches_by_shape"] = _launches()
    artg = _artifact("campaign_gpmpc3dof_safety_1024.json",
                     ("success_rate", "success_rate_unfiltered", "intervention_rate",
                      "interventions_per_episode_mean", "landing_speed_mean",
                      "landing_error_mean"))
    log(f"[safety] GP-MPC campaign (--controller gp_mpc --safety-filter, the velocity-ellipsoid "
        f"filter the artifact flew at {SAFETY_GPMPC_COMMIT}), {SAFETY_LANES} lanes, 130 steps: "
        f"{json.dumps(resg)}")
    log(f"[safety] GP-MPC, the JAX package's artifact (a TPU v5e record): {json.dumps(artg)}")
    if resg["launches_by_shape"].get("n4_m6", 0) <= 0:
        raise RuntimeError("the GP-MPC safety campaign's filter did not go through the kernel")
    if resg["success_rate"] < 0.98:
        raise RuntimeError(f"the GP-MPC safety campaign's success {resg['success_rate']:.4f} "
                           f"is under 0.98")
    out["gpmpc"] = resg

    # the online GP-MPC learning across episodes behind the GP-read filter
    op = online_safety_path(dev)
    x0o = _safety_x0("online", dev)[:ONLINE_SAFETY_LANES]
    _reset_launches()
    t0 = time.time()
    reso = fly_online_safety(op, x0o, episodes=ONLINE_SAFETY_EPISODES)
    reso["seconds"] = time.time() - t0
    reso["launches"], reso["launches_by_shape"] = _launches()
    arto = _artifact("campaign_online_safety_tpu_512.json",
                     ("interventions_by_episode", "model_err_by_episode", "success_by_episode",
                      "success_mcnemar_z_vs_ep1", "final_success_rate", "per_episode"))
    arto["landed_by_episode"] = [e["landed_rate"] for e in arto.pop("per_episode")]
    by_ep = lambda key: [r[key] for r in reso["per_episode"]]
    log(f"[safety] online safety, landed by episode {by_ep('landed_rate')}, lanes not finite "
        f"by episode {by_ep('nonfinite_lanes')}")
    log(f"[safety] online safety campaign (run_online_safety_tpu.py --filter-model gp), "
        f"{ONLINE_SAFETY_LANES} lanes x {ONLINE_SAFETY_EPISODES} episodes of 110 steps: "
        f"{json.dumps(reso)}")
    log(f"[safety] online safety, the JAX package's artifact (a TPU v5e record, 6 episodes): "
        f"{json.dumps(arto)}")
    if reso["launches_by_shape"].get("n4_m6", 0) <= 0:
        raise RuntimeError("the online safety campaign's filter did not go through the kernel")
    if not reso["gate"]:
        raise RuntimeError(
            f"the online safety campaign misses the script's gate: interventions "
            f"{reso['interventions_by_episode']} (must fall), final success "
            f"{reso['final_success_rate']:.4f} (> 0.95), McNemar z "
            f"{reso['success_mcnemar_z_vs_ep1']} (each < 2.0)")
    out["online"] = reso
    return out


def main():
    smi = phase_card()
    phase_build()
    timings = phase_kernels()
    main_res, fns = phase_main_path()
    land = phase_landing(fns)
    rti_res = phase_rti()
    pre_res, production_gp = phase_pretrain()
    cal_res = phase_calibration(production_gp)
    six_res = phase_sixdof()
    onl_res = phase_online()
    flt_res = phase_fleet()
    lmpc_res = phase_lmpc()
    camp_res, camp_gp = phase_gpmpc_campaign()
    saf_res = phase_safety(camp_gp)
    log(f"[summary] main path {main_res['ms_per_cycle']:.3f} ms/cycle, "
        f"{main_res['solves_per_s']:.1f} solves/s, landing success {land['success_share']:.4f}; "
        f"RTI path {rti_res['ms_per_cycle']:.3f} ms/cycle, landing success "
        f"{rti_res['landing']['success_share']:.4f}; pretraining {pre_res['seconds']:.2f} s, "
        f"landing success with its GP {pre_res['landing']['success_share']:.4f}; "
        f"calibration path {cal_res['ms_per_cycle']:.3f} ms/cycle, violation upper bound "
        f"{cal_res['flight']['realized_upper95']:.5f}, one-step coverage "
        f"{cal_res['flight']['one_step_coverage']:.4f}, landed {cal_res['flight']['landed_rate']:.4f}; "
        f"6-DoF path {six_res['ms_per_cycle']:.3f} ms/cycle, pretraining {six_res['pretrain_s']:.2f} s, "
        f"campaign success {six_res['flight']['success_share']:.4f}, touchdown "
        f"{six_res['flight']['landing_speed_mean']:.4f} m/s, error "
        f"{six_res['flight']['landing_error_mean']:.4f} m; online path "
        f"{onl_res['ms_per_cycle']:.3f} ms/cycle, observe {onl_res['observe_us_per_lane']:.4f} us "
        f"a lane, 3-DoF online campaign success {onl_res['flights']['3dof']['success_share']:.4f}, "
        f"model error drop {onl_res['flights']['3dof']['model_err_reduction_x']:.2f}x, 6-DoF "
        f"{onl_res['flights']['6dof']['success_share']:.4f}, "
        f"{onl_res['flights']['6dof']['model_err_reduction_x']:.2f}x; fleet learning 3-DoF "
        f"{flt_res['3dof']['ms_per_cycle']:.3f} ms/cycle, final/first model error "
        f"{flt_res['3dof']['summary']['model_err_final_over_first']:.4f}, 6-DoF "
        f"{flt_res['6dof']['ms_per_cycle']:.3f} ms/cycle, "
        f"{flt_res['6dof']['summary']['model_err_final_over_first']:.4f}; fleet LMPC 3-DoF "
        f"final success {lmpc_res['3dof']['final_success_rate']}, probe improves on the seed "
        f"{lmpc_res['3dof']['probe_improves_on_seed']}, "
        f"{max(lmpc_res['3dof']['ms_per_step_by_round']):.1f} ms a step at most, 6-DoF "
        f"{lmpc_res['6dof']['final_success_rate']}, ADMM arm "
        f"{lmpc_res['admm']['success_rate']}; 3-DoF GP-MPC campaign success "
        f"{camp_res['success_share']:.4f}, {camp_res['landing_speed_mean']:.4f} m/s, "
        f"{camp_res['landing_error_mean']:.4f} m; safety: filter {saf_res['latency']['ms_per_cycle']:.3f} "
        f"ms/cycle at {BATCH} lanes, rescue success {saf_res['rescue']['success_rate']:.4f} vs "
        f"{saf_res['rescue']['success_rate_unfiltered']:.4f} unfiltered, GP-MPC behind the filter "
        f"{saf_res['gpmpc']['success_rate']:.4f} (intervention rate "
        f"{saf_res['gpmpc']['intervention_rate']:.4f}), online interventions by episode "
        f"{[round(v, 3) for v in saf_res['online']['interventions_by_episode']]}")
    main_t = timings[0]
    kernels = [{
        "name": "admm_chunk",
        "route": "cuda",
        "source": "gpmpc_tpu_torch/csrc/admm_chunk.cu",
        "replaces": REPLACES,
        "launches": main_res["launches"],
        "launches_by_path": {"main": main_res["launches"], "rti": rti_res["launches"],
                             "pretrain": pre_res["launches"],
                             "pretrained_landing": pre_res["landing_launches"],
                             "calibration": cal_res["launches"],
                             "calibration_flight": cal_res["flight_launches"],
                             "sixdof": six_res["launches"],
                             "sixdof_pretrain": six_res["pretrain_launches"],
                             "sixdof_flight": six_res["flight"]["launches"],
                             "online": onl_res["launches"],
                             "online_flight": onl_res["flights"]["3dof"]["launches"],
                             "online6dof_flight": onl_res["flights"]["6dof"]["launches"],
                             "fleet": flt_res["3dof"]["launches"],
                             "fleet6dof": flt_res["6dof"]["launches"],
                             "lmpc": lmpc_res["3dof"]["launches"],
                             "lmpc_admm": lmpc_res["admm"]["launches"],
                             "lmpc6dof_seed": lmpc_res["6dof"]["seed_launches"],
                             "hull_projection": lmpc_res["hull"]["launches"],
                             "gpmpc_campaign": camp_res["launches"],
                             "safety_rescue": saf_res["rescue"]["launches"],
                             "safety_gpmpc": saf_res["gpmpc"]["launches"],
                             "safety_online": saf_res["online"]["launches"],
                             "safety_filter_shape": {
                                 k: saf_res[k]["launches_by_shape"].get("n4_m6", 0)
                                 for k in ("rescue", "gpmpc", "online")}},
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"],
        "eager_ms": main_t["eager_ms"],
        "wrapper_us": main_t["wrapper_us"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "variant": main_t["variant"],
        "shapes": [{k: t[k] for k in ("shape", "lanes", "n", "m", "iters", "variant",
                                       "ctas_per_lane", "registers", "max_abs_err", "ms", "eager_ms",
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
