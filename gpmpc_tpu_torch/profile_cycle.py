"""Where the main-path cycle's time goes, on the card.

Runs the 3-DoF GP-MPC cycle of ``gpmpc_tpu_torch/main_path.py`` (fit the GP,
warm up, then time cycles of ``gp_mpc_solve`` + the plant step) and reports:

- ms per cycle from CUDA events, without the profiler;
- a ``torch.profiler`` trace of a few cycles: for each stage span of the
  cycle (``gpmpc.*``, ``admm.*``) its host time, and for the whole window
  the device's busy share (sum of kernel times over wall time), the kernel
  launches per cycle and the kernels that take the most device time.

Usage: ``python -m gpmpc_tpu_torch.profile_cycle [--batch 512] [--cycles 20]
[--out build/profile_cycle.json]``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from .learning import explore_gp_3dof
from .main_path import BATCH, DT, fleet_x0, main_path
from .mpc import gp_mpc_init, gp_mpc_solve

SPAN_PREFIXES = ("gpmpc.", "admm.")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run(batch: int, cycles: int, prof_cycles: int) -> dict:
    dev = torch.device("cuda")
    mp = main_path(dev)
    gp, mean_fn, var_fn = explore_gp_3dof(
        torch.Generator(device=dev).manual_seed(0),
        torch.Generator(device=dev).manual_seed(1), mp.params, mp.F_true, dt=DT, device=dev)
    state = gp_mpc_init(mp.config, fleet_x0(batch, dev), mp.x_target, device=dev)
    xs = fleet_x0(batch, dev)

    def cycle(state, xs):
        sol, state = gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, xs)
        return state, mp.F_true(xs, sol.u0)

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
    busy_us = 0.0
    n_ops = 0
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
            busy_us += dur
            n_ops += 1
            k = per_op.setdefault(evt.name, [0, 0.0])
            k[0] += 1
            k[1] += dur
    top = [{"name": name[:120], "launches_per_cycle": count / prof_cycles,
            "device_ms_per_cycle": us / 1e3 / prof_cycles}
           for name, (count, us) in sorted(per_op.items(), key=lambda kv: -kv[1][1])[:15]]
    return {
        "card": _card(),
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
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--prof-cycles", type=int, default=5)
    ap.add_argument("--out", default="build/profile_cycle.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_cycle needs a CUDA device")
    res = run(args.batch, args.cycles, args.prof_cycles)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"{res['card']} | batch {res['batch']}: {res['ms_per_cycle']:.3f} ms/cycle "
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
