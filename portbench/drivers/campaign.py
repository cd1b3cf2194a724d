"""Monte-Carlo campaigns back to back: ``run_campaign`` flies the GP-MPC
controller over every lane from new seeded states, until no lane runs or
``max_steps``; no host read is made beyond the campaign's own. A window runs
whole campaigns until ``--seconds`` have passed."""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core import draws
from ..core.cell import Cell, Outcome
from .common import gpmpc_path


def run(cell: Cell) -> Outcome:
    from gpmpc_tpu_torch.experiments import SimulationConfig, run_campaign
    from gpmpc_tpu_torch.mpc import make_gp_mpc_controller

    t, dev = cell.traffic, cell.device
    mp, mean_fn, var_fn, gen, inputs = gpmpc_path(cell)
    L, campaigns = t["lanes"], t["campaigns"]
    x0s = draws.states(gen, t["state_dist"], campaigns * L).reshape(campaigns, L, 7)
    warm = draws.states(gen, t["state_dist"], L)
    cinit, cstep = make_gp_mpc_controller(mp.F, mean_fn, var_fn, mp.config, mp.x_target)
    dist = t["state_dist"]
    sim = SimulationConfig(max_steps=t["max_steps"], altitude_mean=dist["altitude"][0],
                           altitude_std=dist["altitude"][1])
    warm_sim = dataclasses.replace(sim, max_steps=t["warmup_steps"])
    run_campaign(cinit, cstep, mp.F_true, warm, warm_sim)["outcome"].cpu()

    cg = draws.check_generator(cell.seed)
    ck = t["check"]
    sampled = [0] + draws.sample(cg, ck["cycles"], ck["first_cycle"], ck["last_cycle"])
    lanes = {k: torch.tensor(draws.sample(cg, ck["lanes"], 0, L), device=dev) for k in sampled}
    records = []
    tracer = cell.tracer
    steps = [0]
    first = [True]

    def stepper(cstate, x, k):
        if first[0] and records and records[-1]["cycle"] == k - 1:
            records[-1]["x_next"] = x  # the plant step's answer, as the campaign flies on
        tracer.before_unit()
        u0, new_state = cstep(cstate, x, k)
        tracer.after_unit()
        if first[0] and k in lanes:
            records.append({"cycle": k, "start": k == 0, "lanes": lanes[k], "state": cstate,
                            "x": x, "u0": u0, "new_state": new_state})
        steps[0] += 1
        return u0, new_state

    cell.mark_setup_end()
    t0 = time.perf_counter()
    c = 0
    while True:
        res = run_campaign(cinit, stepper, mp.F_true, x0s[c % campaigns], sim)
        res["outcome"].cpu()
        first[0] = False
        c += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    elapsed = time.perf_counter() - t0
    tracer.stop()
    return Outcome(e2e={"lane_cycles_per_s": L * steps[0] / elapsed}, units=steps[0],
                   records=records, inputs=inputs)
