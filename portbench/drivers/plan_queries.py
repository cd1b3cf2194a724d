"""Single-vehicle planning queries back to back: ``scvx_free_time`` for one
seeded initial state over the candidate durations, its chosen plan read to
the host; a window runs whole queries until ``--seconds`` have passed."""

from __future__ import annotations

import time

from ..core import draws
from ..core.cell import Cell, Outcome
from .common import scvx_path


def run(cell: Cell) -> Outcome:
    from gpmpc_tpu_torch.reference import scvx_free_time

    t = cell.traffic
    lp, dts = scvx_path(cell, t["dts"])
    Qn = t["queries"]
    gen = draws.generator(cell.seed, cell.device)
    x0s = draws.states(gen, t["state_dist"], Qn)
    warm = draws.states(gen, t["state_dist"], 1)
    # one SCP iteration at the cell's lane count warms every shape of a query
    scvx_free_time(lp.step_dt, lp.config.replace(iterations=1), warm, lp.x_target,
                   dts).U.cpu()

    checked = t["check"]["queries"]
    records = []
    tracer = cell.tracer
    cell.mark_setup_end()
    t0 = time.perf_counter()
    n = 0
    while True:
        tracer.before_unit()
        sol = scvx_free_time(lp.step_dt, lp.config, x0s[n % Qn][None], lp.x_target, dts)
        sol.U.cpu()
        tracer.after_unit(trajectories=1)
        records.append({"x0": x0s[n % Qn][None], "picked": [0] if n < checked else [],
                        "dts": dts, "solution": sol})
        n += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    elapsed = time.perf_counter() - t0
    tracer.stop()
    return Outcome(e2e={"plans_per_s": n / elapsed}, units=n, records=records)
