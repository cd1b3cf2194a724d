"""The readings that a cell's limits are set from, many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--control] [--lanes] [--out chiprun_out/readings.jsonl]

For each seed: the cell's set-up and window, as ``portbench/run.py`` drives
them, then the numbers compared of the program against the float64
reference (the lower reading) and, with ``--control``, of the control — the
reference computed in TF32, put in the program's place (the upper reading).
With ``--lanes`` (the GP-MPC cells) each sampled answer's gaps beside the
primal residuals that decide its branch: the program's, read by replaying
its solve on the recorded inputs, the float64 and float32 references', and
the float32 reference's after a one-ulp change of x₀. One JSON line a seed.
The benchmark's own runs never run any of this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_residuals(cell, outcome):
    """The program's primal residual and status on the sampled lanes, from a
    replay of each sampled cycle on its recorded inputs, and the largest
    |Δu0| between the replay and the recorded run (0 where it reproduces)."""
    import torch

    from gpmpc_tpu_torch.mpc import gp_mpc as G

    from portbench.drivers.common import gpmpc_path

    mp, mean_fn, var_fn, _, _ = gpmpc_path(cell)
    inner, seen = G.solve, []

    def recorded(*args, **kw):
        sol = inner(*args, **kw)
        seen.append(sol)
        return sol

    G.solve = recorded
    rp, status, du0 = [], [], 0.0
    try:
        for r in outcome.records:
            i = r["lanes"]
            seen.clear()
            sol, _ = G.gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, r["state"], r["x"])
            rp.append(seen[-1].pri_res[i])
            status.append(seen[-1].status[i])
            du0 = max(du0, float((sol.u0[i] - r["u0"][i]).abs().max()))
    finally:
        G.solve = inner
    return torch.cat(rp), torch.cat(status), du0


def lane_readings(cell, outcome) -> dict:
    """Every sampled answer's gaps and the residuals that decide its branch."""
    import torch

    from portbench.checks import gpmpc_cycle as chk
    from portbench.reference.prec import F32, F64

    c = cell.config
    inp = chk.inputs(outcome)
    ref = chk.with_witness(c, outcome, inp,
                           chk.reference(F64, c, chk.reference_gp(F64, c, outcome), inp))
    g = chk.lane_gaps(c, inp, chk.program(outcome), ref)
    nudged = dict(inp, x=torch.nextafter(inp["x"], torch.full_like(inp["x"], float("inf"))))
    w1 = chk.reference(F32, c, chk.reference_gp(F32, c, outcome), nudged)
    rp, status, du0 = program_residuals(cell, outcome)
    out = {k: v.tolist() for k, v in g.items()}
    out.update(rp64=ref["pri_res"].tolist(), ok64=ref["ok"].tolist(),
               rp32=ref["witness_pri_res"].tolist(), ok32=ref["witness_ok"].tolist(),
               rp32_ulp=w1["pri_res"].tolist(), rp_program=rp.tolist(),
               status_program=status.tolist(), replay_du0=du0, tol=c["accept_pri_tol"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true", help="read the TF32 control too")
    ap.add_argument("--lanes", action="store_true", help="each sampled answer's readings")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from portbench import run

    run.use_checkout_caches()

    import importlib

    import torch

    from portbench.reference.prec import F64, TF32

    device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        _, cell, outcome, _, _ = run.drive(args.workload, seed, args.seconds, False,
                                           args.rehearse, device, time.perf_counter())
        t0 = time.perf_counter()
        correct, _, _, compared, parts = run.judge(cell, outcome)
        line = {"workload": args.workload, "seed": seed, "units": outcome.units,
                "e2e": outcome.e2e, "correct": correct,
                "program": {k: v["value"] for k, v in compared.items()},
                "program_parts": parts, "reference_s": time.perf_counter() - t0}
        if args.control:
            check = importlib.import_module(f"portbench.checks.{cell.config['check']}")
            t0 = time.perf_counter()
            ctl = check.control(cell.config, outcome, F64, TF32)
            line.update(control=ctl["numbers"], control_parts=ctl.get("parts"),
                        control_s=time.perf_counter() - t0)
        if args.lanes:
            line["lanes"] = lane_readings(cell, outcome)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del outcome
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
