"""Where a path's cycle time goes, on the card.

Runs one of the cycles of ``gpmpc_tpu_torch/main_path.py``:

- ``--path main``: the 3-DoF GP-MPC cycle (fit the exploration GP, then
  cycles of ``gp_mpc_solve`` + the dispersed plant step), 512 lanes;
- ``--path rti``: the GP-free RTI cycle (``rti_step`` + the nominal plant
  step), 512 lanes;
- ``--path rti_warm`` and ``--path rti_cholesky``: the sparse-form RTI
  cycle of ``bench_variants.py``'s ``"sparse_warm"`` with the KKT inverse
  carried across cycles (``admm.factor`` is then the Newton–Schulz
  refresh), and the same cycle factoring by Cholesky every cycle, 512 lanes
  tracking their cubic references;
- ``--path pretrain``: the cycle of the production GP fit's episodes (the
  default sparse-form RTI controller tracking a cubic descent reference on
  the dispersed plant), 4 lanes, and the wall time of the whole
  ``pretrain_gp_3dof`` call;
- ``--path calibration``: the bound-riding GP-MPC cycle of the calibration
  campaign (state bounds kept in the QP, production GP, gust on the plant),
  512 lanes;
- ``--path sixdof``: Path D, the 6-DoF GP-MPC cycle (fit its GP with
  ``pretrain_gp_6dof``, then cycles of ``gp_mpc_solve`` + the dispersed
  plant step), 512 lanes;
- ``--path pretrain6dof``: the cycle of the 6-DoF GP fit's episodes (the
  sparse-form ``rti_config_6dof(N=15)`` controller tracking a cubic descent
  reference on the dispersed plant), 4 lanes, and the wall time of the whole
  ``pretrain_gp_6dof`` call;
- ``--path online``: Path E, the online-learning GP-MPC cycle (each lane's
  own GP observed every cycle, refit every 10 and refreshed every 20 cycles,
  then ``gp_mpc_solve`` + the drag plant step), 512 lanes from an empty GP;
- ``--path online6dof``: the same controller on the 6-DoF model as the
  6-DoF online campaign flies it (100 iterations in chunks of 50, Path D's
  plant), 512 lanes of the campaign's fleet;
- ``--path fleet`` and ``--path fleet6dof``: Path F, the episode cycle of
  fleet GP learning (``run_batched_learning``'s GP-MPC controller with each
  lane's own GP, fitted by a first round of 110 steps, + the true plant),
  128 and 64 lanes, and the wall times of the round's refit barrier (every
  lane's k-means and FITC fit) and of its per-lane Adam retune;
- ``--path lmpc`` and ``--path lmpc6dof``: Path G, one fleet-LMPC step
  (``lmpc_solve`` with the interior-point solver + the plant step), 256
  lanes of the campaign's fleet from their initial states, against the safe
  set that two rounds of the campaign grew (the seed and 512 trajectories,
  read through the round's KNN bucket), and the wall time of those rounds;
- ``--path safety``: the rescue campaign's filtered cycle (the condensed RTI
  controller with its state bounds, the funnel filter over emergency
  braking with the downdraft-padded model, + the gusted plant step), 1024
  lanes of the campaign's fleet;

warms it up and reports:

- ms per cycle from CUDA events, without the profiler;
- a ``torch.profiler`` trace of a few cycles: for each stage span of the
  cycle (``gpmpc.*``, ``rti.*``, ``admm.*``, ``online.observe`` and
  ``online.refit`` on the online paths, ``fleet.cycle`` on the fleet
  paths, ``lmpc.*`` on the LMPC paths, ``safety.check``, ``safety.grad``,
  ``safety.qp`` and ``safety.select`` inside the filter on the safety path) its host time, and for the
  whole window the device's busy share (the union of the device ops'
  intervals over wall time, so that ops overlapping on streams count once),
  the kernel launches per cycle and the kernels that take the most device
  time.

Usage: ``python -m gpmpc_tpu_torch.profile_cycle [--path main] [--batch B]
[--cycles 20] [--prof-cycles P] [--out build/profile_cycle.json]``: the
profiled window is 5 cycles, 20 on the online paths so that it holds one
refit and one refresh. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from dataclasses import replace
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from .learning import explore_gp_3dof, run_batched_learning
from .learning.batched_learner import _gated_fns, _tune_lane, fleet_cycle, fleet_reference
from .lmpc import lmpc_init, lmpc_solve
from .experiments import sample_initial_conditions
from .main_path import (BATCH, DT, FLEET_LANES, LMPC_LANES, N, SAFETY_LANES, calibration_cycle,
                        calibration_path, calibration_x0, fleet_learning_path,
                        fleet_learning_x0, fleet_x0, fly_lmpc_fleet, lmpc_fleet_path,
                        lmpc_fleet_x0,
                        main_path, online_flight_path, online_path, pretrain_path, rti_path,
                        rti_warm_path,
                        filtered_controller, safety_rescue_path, sixdof_fleet_x0,
                        sixdof_flight_x0, sixdof_path, sixdof_pretrain_path, with_gust_variance)
from .mpc import (RTIConfig, gp_mpc_init, gp_mpc_solve, make_rti_controller, rti_config_6dof,
                  rti_init, rti_step)
from .reference import cubic_descent_reference, pad_reference
from .terminal import knn_bucket, trim
from .utils.profiler import SPAN_PREFIXES, span

PATHS = {"main": BATCH, "rti": BATCH, "rti_warm": BATCH, "rti_cholesky": BATCH,
         "pretrain": 4, "calibration": BATCH,
         "sixdof": BATCH, "pretrain6dof": 4, "online": BATCH,
         "online6dof": BATCH, "fleet": FLEET_LANES["3dof"],
         "fleet6dof": FLEET_LANES["6dof"], "lmpc": LMPC_LANES,
         "lmpc6dof": LMPC_LANES, "safety": SAFETY_LANES}  # path → default lanes


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _cycle_of(path: str, batch: int, dev):
    """(cycle, state, xs) of a path: ``cycle(state, xs) → (state, xs)``."""
    xs = fleet_x0(batch, dev)
    if path == "main":
        mp = main_path(dev)
        _, mean_fn, var_fn = explore_gp_3dof(
            torch.Generator(device=dev).manual_seed(0),
            torch.Generator(device=dev).manual_seed(1), mp.params, mp.F_true, dt=DT, device=dev)

        def cycle(state, xs):
            sol, state = gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs)
            return state, mp.F_true(xs, sol.u0)

        return cycle, gp_mpc_init(mp.config, xs, mp.x_target, device=dev), xs
    if path == "rti":
        rp = rti_path(dev)

        def cycle(state, xs):
            sol, state = rti_step(rp.F, rp.config, state, xs)
            return state, rp.F(xs, sol.u0)

        return cycle, rti_init(rp.config, xs, rp.x_target), xs
    if path in ("rti_warm", "rti_cholesky"):
        wp = rti_warm_path(dev, warm_kkt=path == "rti_warm")
        ref = pad_reference(cubic_descent_reference(xs, wp.x_target, 100, DT), wp.config.N + 20)
        last = ref.shape[1] - wp.config.N - 1
        step = [0]

        def cycle(state, xs):
            k = min(step[0], last)
            step[0] += 1
            state = state.replace(x_ref=ref[:, k:k + wp.config.N + 1])
            sol, state = rti_step(wp.F, wp.config, state, xs)
            return state, wp.F(xs, sol.u0)

        return cycle, rti_init(wp.config, xs, wp.x_target, step_fn=wp.F), xs
    if path == "calibration":
        cp = calibration_path(dev)
        _, mean_fn, var_raw = pretrain_path(torch.Generator(device=dev).manual_seed(2), dev)
        var_fn = with_gust_variance(var_raw, cp.gust_sigma)
        xs = calibration_x0(torch.Generator(device=dev).manual_seed(7), batch, dev)
        solve_and_step = calibration_cycle(cp, mean_fn, var_fn, xs,
                                           torch.Generator(device=dev).manual_seed(11))
        cycle = lambda state, xs: solve_and_step(state, xs)[1:]
        return cycle, gp_mpc_init(cp.config, xs, cp.x_target, device=dev), xs
    if path == "sixdof":
        sp = sixdof_path(dev)
        _, mean_fn, var_fn = sixdof_pretrain_path(torch.Generator(device=dev).manual_seed(2), dev)
        xs = sixdof_fleet_x0(torch.Generator(device=dev).manual_seed(7), batch, dev)

        def cycle(state, xs):
            sol, state = gp_mpc_solve(sp.F, mean_fn, var_fn, sp.config, state, xs)
            return state, sp.F_true(xs, sol.u0)

        return cycle, gp_mpc_init(sp.config, xs, sp.x_target, device=dev), xs
    if path in ("fleet", "fleet6dof"):
        return _fleet_cycle("6dof" if path == "fleet6dof" else "3dof", batch, dev)
    if path in ("lmpc", "lmpc6dof"):
        return _lmpc_cycle("6dof" if path == "lmpc6dof" else "3dof", batch, dev)
    # the rest are controllers of the campaign protocol, stepped with the index
    if path in ("online", "online6dof"):
        if path == "online":
            op = online_path(dev)
        else:
            op = online_flight_path("6dof", dev)
            xs = sixdof_flight_x0(torch.Generator(device=dev).manual_seed(7), batch, dev)
        cinit, cstep = op.controller()
        F_true = op.F_true
    elif path == "safety":
        sp = safety_rescue_path(dev)
        xs = sample_initial_conditions(torch.Generator(device=dev).manual_seed(0), sp.sim, batch,
                                       device=dev)
        cinit, cstep = filtered_controller(sp)
        F_true = sp.plant
    else:
        # the controller collect_residuals_3dof (or _6dof) flies, on the dispersed plant
        if path == "pretrain6dof":
            sp = sixdof_path(dev)
            F, F_true, xT = sp.F, sp.F_true, sp.x_target
            cfg, horizon = rti_config_6dof(sp.params, N=15, dt=DT), 65
            xs = sixdof_flight_x0(torch.Generator(device=dev).manual_seed(7), batch, dev)
        else:
            mp = main_path(dev)
            F, F_true, xT = mp.F, mp.F_true, mp.x_target
            cfg, horizon = RTIConfig(N=N, dt=DT, device=dev), 100
        cinit, cstep = make_rti_controller(
            F, cfg, xT, reference_fn=lambda x0: cubic_descent_reference(x0, xT, 80, DT),
            ref_horizon=horizon)
    step = [0]

    def cycle(cstate, xs):
        u0, cstate = cstep(cstate, xs, step[0])
        step[0] += 1
        return cstate, F_true(xs, u0)

    return cycle, cinit(xs), xs


def _wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _fleet_cycle(model: str, batch: int, dev):
    """Path F's episode cycle with the GPs that a first round fitted; the
    cycle carries ``barrier()``, which times that round's refit barrier and
    its per-lane retune."""
    fp = fleet_learning_path(model, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = fleet_learning_x0(model, gen, batch, dev)
    out, round_s = _wall_s(lambda: run_batched_learning(
        gen, fp.params, fp.plant, xs, replace(fp.config, n_rounds=1), fp.mpc, fp.x_target,
        device=dev))
    gps, fitted = out["gps"], out["gp_fitted"]
    fleet = fleet_cycle(fp.F, fp.plant, fp.mpc, *_gated_fns(gps, fitted, xs.shape[1]),
                        fleet_reference(xs, fp.x_target, fp.config, fp.mpc.base.N))
    step = [0]

    def cycle(state, xs):
        k = min(step[0], fp.config.max_steps - 1)  # past the episode, hold its last window
        step[0] += 1
        with span("fleet.cycle"):
            _, state, xs = fleet(state, xs, k)
            return state, xs

    def barrier():
        _, fit_s = _wall_s(lambda: gps.fit(gen))
        _, tune_s = _wall_s(lambda: _tune_lane(gps, fp.config.tune_steps))
        return {"first_round_s": round_s, "refit_barrier_s": fit_s, "tune_s": tune_s,
                "gp_fitted": int(fitted.sum())}

    cycle.barrier = barrier
    return cycle, gp_mpc_init(fp.mpc, xs, fp.x_target, device=dev), xs


def _lmpc_cycle(model: str, batch: int, dev):
    """Path G's fleet step against the safe set two campaign rounds grew;
    the cycle carries ``barrier()``, which reports those rounds."""
    lp = lmpc_fleet_path(model, dev)
    xs = lmpc_fleet_x0(lp, torch.Generator(device=dev).manual_seed(0), batch)
    (res, ss), rounds_s = _wall_s(lambda: fly_lmpc_fleet(lp, xs, rounds=2))
    bucket = knn_bucket(int(ss.written), ss.capacity)
    view = trim(ss, bucket)

    def cycle(state, xs):
        sol, state = lmpc_solve(lp.F, lp.config, view, state, xs)
        return state, lp.F(xs, sol.u0)

    def barrier():
        return {"two_rounds_s": rounds_s, "safe_set_states": int(ss.count),
                "knn_bucket": bucket, "success_by_round":
                [r["success_rate"] for r in res["per_round"]],
                "ms_per_step_by_round": [r["ms_per_step"] for r in res["per_round"]]}

    cycle.barrier = barrier
    return cycle, lmpc_init(lp.config, xs, lp.x_target), xs


def _union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def run(path: str, batch: int, cycles: int, prof_cycles: int) -> dict:
    """Warm up 5 cycles, time ``cycles`` with CUDA events, then profile
    ``prof_cycles``."""
    dev = torch.device("cuda")
    cycle, state, xs = _cycle_of(path, batch, dev)
    for _ in range(5):
        state, xs = cycle(state, xs)
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(cycles):
        state, xs = cycle(state, xs)
    end.record()
    torch.cuda.synchronize()
    ms_cycle = start.elapsed_time(end) / cycles

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(prof_cycles):
            state, xs = cycle(state, xs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # the spans appear twice in the trace: as host ranges (CPU) and as device
    # ranges (the first to the last device op issued inside them); every
    # other device event is a kernel or a copy
    spans = {}
    intervals = []
    per_op = {}
    for evt in prof.events():
        dur = float(evt.time_range.elapsed_us())
        on_device = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.name.startswith(SPAN_PREFIXES):
            sp = spans.setdefault(evt.name, {"host_ms_per_cycle": 0.0,
                                             "device_range_ms_per_cycle": 0.0})
            key = "device_range_ms_per_cycle" if on_device else "host_ms_per_cycle"
            sp[key] += dur / 1e3 / prof_cycles
        elif on_device:
            intervals.append((float(evt.time_range.start), float(evt.time_range.end)))
            k = per_op.setdefault(evt.name, [0, 0.0])
            k[0] += 1
            k[1] += dur
    busy_us = _union_us(intervals)
    n_ops = len(intervals)
    top = [{"name": name[:120], "launches_per_cycle": count / prof_cycles,
            "device_ms_per_cycle": us / 1e3 / prof_cycles}
           for name, (count, us) in sorted(per_op.items(), key=lambda kv: -kv[1][1])[:15]]
    res = {}
    fits = {"pretrain": ("pretrain_gp_3dof_s", pretrain_path),
            "pretrain6dof": ("pretrain_gp_6dof_s", sixdof_pretrain_path)}
    if path in fits:
        name, fit = fits[path]
        _, res[name] = _wall_s(lambda: fit(torch.Generator(device=dev).manual_seed(2), dev))
    if hasattr(cycle, "barrier"):
        res["lmpc" if path.startswith("lmpc") else "fleet"] = cycle.barrier()
    return {
        **res,
        "card": _card(),
        "path": path,
        "batch": batch,
        "ms_per_cycle": ms_cycle,
        "solves_per_s": batch * 1000.0 / ms_cycle,
        "profiled_cycles": prof_cycles,
        "profiled_wall_ms_per_cycle": wall_us / 1e3 / prof_cycles,
        "device_busy_ms_per_cycle": busy_us / 1e3 / prof_cycles,
        "device_busy_share": busy_us / wall_us if wall_us else None,
        "device_ops_per_cycle": n_ops / prof_cycles,
        "spans": spans,
        "top_device_ops": top,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="main")
    ap.add_argument("--batch", type=int, default=None, help="lanes (default: the path's)")
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--prof-cycles", type=int, default=None,
                    help="cycles in the profiled window (default 5; 20 on the online paths)")
    ap.add_argument("--out", default="build/profile_cycle.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_cycle needs a CUDA device")
    prof_cycles = args.prof_cycles or (20 if args.path.startswith("online") else 5)
    res = run(args.path, args.batch or PATHS[args.path], args.cycles, prof_cycles)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    for name in ("pretrain_gp_3dof_s", "pretrain_gp_6dof_s"):
        if name in res:
            print(f"{name[:-2]}: {res[name]:.3f} s")
    for name in ("fleet", "lmpc"):
        if name in res:
            print(f"{name}: " + json.dumps(res[name]))
    print(f"{res['card']} | path {res['path']} batch {res['batch']}: {res['ms_per_cycle']:.3f} ms/cycle "
          f"(CUDA events), {res['solves_per_s']:.1f} solves/s")
    print(f"profiled {res['profiled_cycles']} cycles: wall {res['profiled_wall_ms_per_cycle']:.3f} "
          f"ms/cycle, device busy {res['device_busy_ms_per_cycle']:.3f} ms/cycle "
          f"(share {res['device_busy_share']:.3f}), {res['device_ops_per_cycle']:.0f} device ops/cycle")
    for k, v in sorted(res["spans"].items(), key=lambda kv: -kv[1]["host_ms_per_cycle"]):
        print(f"  span {k:26s} host {v['host_ms_per_cycle']:8.3f} ms/cycle, "
              f"device range {v['device_range_ms_per_cycle']:8.3f} ms/cycle")
    for k in res["top_device_ops"]:
        print(f"  op {k['device_ms_per_cycle']:8.4f} ms/cycle x{k['launches_per_cycle']:6.1f}  {k['name']}")
    print(json.dumps({"ms_per_cycle": res["ms_per_cycle"], "device_busy_share": res["device_busy_share"]}))


if __name__ == "__main__":
    main()
