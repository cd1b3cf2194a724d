"""The real-time lockstep loop: every cycle solves every lane, reads each
lane's u0 to the host (the actuation), then steps the plant on the device;
landed lanes freeze; the fleet restarts from new seeded states every
``episode_cycles`` cycles. Each cycle is timed on the host clock from the
start of the solve until u0 is in host memory; cycles under the profiler
are left out of the percentile."""

from __future__ import annotations

import time

import torch

from ..core import draws
from ..core.cell import Cell, Outcome
from ..core.stats import percentile
from .common import gpmpc_path


def run(cell: Cell) -> Outcome:
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve

    t, dev = cell.traffic, cell.device
    mp, mean_fn, var_fn, gen, inputs = gpmpc_path(cell)
    L, E, episodes = t["lanes"], t["episode_cycles"], t["episodes"]
    x0s = draws.states(gen, t["state_dist"], episodes * L).reshape(episodes, L, 7)
    warm = draws.states(gen, t["state_dist"], L)
    cfg, floor = mp.config, t["landing_altitude"]

    def solve(state, x):
        return gp_mpc_solve(mp.F, mean_fn, var_fn, cfg, state, x)

    def plant(x, u0, landed):
        xn = torch.where(landed[:, None], x, mp.F_true(x, u0))
        return xn, landed | (xn[:, 1] < floor)

    state, x = gp_mpc_init(cfg, warm, mp.x_target, device=dev), warm
    landed = torch.zeros(L, dtype=torch.bool, device=dev)
    for _ in range(t["warmup_cycles"]):
        sol, state = solve(state, x)
        sol.u0.cpu()
        x, landed = plant(x, sol.u0, landed)

    cg = draws.check_generator(cell.seed)
    ck = t["check"]
    sampled = [0] + draws.sample(cg, ck["cycles"], ck["first_cycle"], ck["last_cycle"])
    lanes = {k: torch.tensor(draws.sample(cg, ck["lanes"], 0, L), device=dev) for k in sampled}
    records = []

    cell.mark_setup_end()
    tracer = cell.tracer
    cycle_s = []
    t0 = time.perf_counter()
    n = 0
    while True:
        k = n % E
        if k == 0:
            x = x0s[(n // E) % episodes]
            state = gp_mpc_init(cfg, x, mp.x_target, device=dev)
            landed = torch.zeros(L, dtype=torch.bool, device=dev)
        tracer.before_unit()
        profiled = tracer.active
        ts = time.perf_counter()
        sol, new_state = solve(state, x)
        sol.u0.cpu()
        if not profiled:
            cycle_s.append(time.perf_counter() - ts)
        x_next, landed_next = plant(x, sol.u0, landed)
        tracer.after_unit()
        if n in lanes:
            records.append({"cycle": n, "start": k == 0, "lanes": lanes[n], "state": state,
                            "x": x, "u0": sol.u0, "new_state": new_state, "Sigmas": sol.Sigmas,
                            "landed": landed, "x_next": x_next})
        state, x, landed = new_state, x_next, landed_next
        n += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    elapsed = time.perf_counter() - t0
    tracer.stop()
    return Outcome(e2e={"cycle_ms_p95": 1e3 * percentile(cycle_s, 95),
                        "lane_cycles_per_s": L * n / elapsed},
                   units=n, records=records, inputs=inputs)
