"""Trajectory-library builds back to back: each build takes new seeded
initial states × the candidate durations through ``scvx_free_time`` inside
``generate_trajectory_library`` (``main_path.fly_scvx_library``), then
answers the nearest and best-within-radius queries of new seeded states. A
window runs whole builds until ``--seconds`` have passed."""

from __future__ import annotations

import time

from ..core import draws
from ..core.cell import Cell, Outcome
from .common import scvx_path


def run(cell: Cell) -> Outcome:
    from gpmpc_tpu_torch.main_path import fly_scvx_library

    t = cell.traffic
    lp, dts = scvx_path(cell, t["dts"])
    S, Qn, builds = t["states"], t["queries"], t["builds"]
    gen = draws.generator(cell.seed, cell.device)
    x0s = draws.states(gen, t["state_dist"], builds * S).reshape(builds, S, 7)
    qs = draws.states(gen, t["state_dist"], builds * Qn).reshape(builds, Qn, 7)
    warm = draws.states(gen, t["state_dist"], S)
    # one SCP iteration at the cell's lane count warms every shape of a build
    wp = lp._replace(config=lp.config.replace(iterations=1))
    out = fly_scvx_library(wp, warm, qs[0])
    out["best_within_radius"].cpu()

    cg = draws.check_generator(cell.seed)
    picked = draws.sample(cg, t["check"]["states"], 0, S)
    records = []
    tracer = cell.tracer
    cell.mark_setup_end()
    t0 = time.perf_counter()
    b = 0
    while True:
        tracer.before_unit()
        out = fly_scvx_library(lp, x0s[b % builds], qs[b % builds])
        out["nearest"].cpu()
        out["best_within_radius"].cpu()
        tracer.after_unit(trajectories=S)
        if b == 0:
            records.append({"x0": x0s[0], "queries": qs[0], "picked": picked, "dts": dts,
                            "solution": out["solution"], "library": out["library"],
                            "nearest": out["nearest"], "best": out["best_within_radius"],
                            "radius": t["radius"]})
        b += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    elapsed = time.perf_counter() - t0
    tracer.stop()
    return Outcome(e2e={"trajectories_per_s": S * b / elapsed}, units=b, records=records)
