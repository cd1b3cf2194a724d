"""The safety-filtered rescue campaign: ``run_campaign`` flies the condensed
RTI controller behind the predictive safety filter
(``main_path.filtered_controller(safety_rescue_path(...))``) over every
lane on the downdraft plant (``SafetyPath.plant``), from new seeded states
each campaign, until no lane runs or ``max_steps``; landed lanes freeze.
A unit is one filtered control step of every lane. A window runs whole
campaigns until ``--seconds`` have passed.

The path is the program's own, every setting the configuration file states
checked against it: the RTI's and the filter's settings as their closures
hold them, the ADMM settings of both QPs as the program's solve record
gives them for the warm-up campaign's first step, and the step functions
on a probe state.

On the sampled cycles of the first campaign the record keeps, by
reference, the filtered controller's carry before and after the step, its
control, the plant's answer, and what the program's solve record
(``utils.profiler.solve_record``, open for that step alone) holds: the RTI
feedback's per-lane iterations and ADMM settings, and each SCP iteration
of the filter's V, ∂V/∂u, linearization point, QP solution, QP status and
ADMM settings."""

from __future__ import annotations

import dataclasses
import inspect
import time

import torch

from ..core import draws
from ..core.cell import Cell, Outcome
from .common import _expect


def _admm_settings(cfg, polish_keys: bool):
    keys = ["max_iter", "check_interval", "early_exit", "scaling", "rho", "sigma", "alpha",
            "eps_abs", "eps_rel", "eps_infeas", "adaptive_rho", "infeas_certs", "polish",
            "matvec_dtype", "tail_f32_iters"]
    if polish_keys:
        keys += ["rho_adapt_chunks", "polish_delta", "polish_refine_iters"]
    return {k: getattr(cfg, k) for k in keys}


def _want_admm(a: dict, polish_keys: bool, precision: str) -> dict:
    out = {"max_iter": a["iterations"], "check_interval": a["chunk"], "early_exit": True,
           "scaling": a["scaling"], "rho": a["rho"], "sigma": a["sigma"], "alpha": a["alpha"],
           "eps_abs": a["eps"], "eps_rel": a["eps"], "eps_infeas": a["eps_infeas"],
           "adaptive_rho": a["adaptive_rho"], "infeas_certs": a["infeas_certs"],
           "polish": a["polish"], "matvec_dtype": "f32" if precision == "float32" else precision,
           "tail_f32_iters": 0}
    if polish_keys:
        out.update(rho_adapt_chunks=a["rho_adapt_chunks"], polish_delta=a["polish_delta"],
                   polish_refine_iters=a["polish_refine_iters"])
    return out


def check_path(c: dict, sp, fstep) -> None:
    """Every setting of the configuration file against the program's path
    (the solvers' settings are checked by :func:`check_solves`)."""
    from gpmpc_tpu_torch.dynamics import Rocket3DoFParams
    from gpmpc_tpu_torch.dynamics import rocket3dof as r3
    from gpmpc_tpu_torch.mpc.rti import _condensed_admm_cfg, _n_rows
    from gpmpc_tpu_torch.reference import cubic_descent_reference
    from gpmpc_tpu_torch.safety import DescentFunnelSet, EmergencyBrakingController

    rti = inspect.getclosurevars(sp.controller[1]).nonlocals
    fil = inspect.getclosurevars(fstep).nonlocals
    base, r = rti["config"], c["rti"]
    _expect("horizon", base.N, c["N"])
    _expect("time step", base.dt, c["dt"])
    _expect("state and control sizes", (base.n_x, base.n_u), (c["n_x"], c["n_u"]))
    _expect("RTI form", (base.condensed, base.reanchor, base.warm_start_duals, base.warm_kkt,
                         base.solver), (r["condensed"], r["reanchor"], r["warm_start_duals"],
                                        False, "admm"))
    _expect("extra rows", (base.Gx, base.Gu, base.stage_rows_fn), (None, None, None))
    _expect("state-bound rows", base.x_bound_mask, r["x_bound_mask"])
    _expect("declared rows", _condensed_admm_cfg(base).row_structure,
            tuple(tuple(s) for s in r["row_structure"]))
    _expect("QP size", (base.N * base.n_u, _n_rows(base)), (r["qp_n"], r["qp_m"]))
    Q = torch.diag(torch.tensor(r["Q_diag"]))
    _expect("weights", (base.Q.cpu().tolist(), base.Qf.cpu().tolist(), base.R.cpu().tolist()),
            (Q.tolist(), (r["Qf_scale"] * Q).tolist(), (r["R"] * torch.eye(3)).tolist()))
    _expect("control box", (base.u_min.tolist(), base.u_max.tolist()), (r["u_min"], r["u_max"]))
    _expect("state box", (base.x_min.tolist(), base.x_max.tolist()), (r["x_min"], r["x_max"]))
    _expect("acceptance tolerance", base.accept_pri_tol, r["accept_pri_tol"])
    _expect("precision", torch.backends.cuda.matmul.allow_tf32, c["tf32"])
    ref = c["descent_reference"]
    _expect("reference horizon", rti["ref_horizon"], ref["ref_horizon"])
    _expect("campaign steps", sp.sim.max_steps, c["campaign"]["max_steps"])
    f, fc = fil["config"], c["filter"]
    _expect("filter", (f.N, f.dt, f.alpha_margin, f.scp_iterations, f.soft, f.slack_weight,
                       f.u_min.tolist(), f.u_max.tolist(), f.after_max, f.max_consecutive),
            (fc["N"], c["dt"], fc["alpha_margin"], fc["scp_iterations"], fc["soft"],
             fc["slack_weight"], fc["u_min"], fc["u_max"], fc["after_max"],
             fc["max_consecutive"]))
    _expect("early half", fil["half_step"], fc["half_step"])
    _expect("filter model", fil["step_fn"] is sp.F_filter and fil["step_fn_from_inner"] is None,
            True)
    inv, fu = fil["invariant"], c["funnel"]
    _expect("invariant set", (type(inv), inv.slope, inv.v_free),
            (DescentFunnelSet, fu["slope"], fu["v_free"]))
    bk, b = fil["backup"], c["backup"]
    _expect("backup", (type(bk), bk.T_max, bk.g_I.tolist()),
            (EmergencyBrakingController, b["T_max"], b["g_I"]))
    # the steps as closures, on a probe state in the downdraft
    v = c["vehicle"]
    dev = base.device
    p = Rocket3DoFParams(I_sp=v["I_sp"], g0=v["g0"], T_max=v["T_max"], m_dry=v["m_dry"],
                         gravity=tuple(v["gravity"]), integrator=v["integrator"],
                         rho=v["drag"], device=dev)
    x = torch.tensor([[1.9, 5.5, 0.4, -0.3, -2.2, 0.15, -0.1]], device=dev)
    u = torch.tensor([[2.3, 0.1, -0.05]], device=dev)
    nominal = r3.step(p, x, u, c["dt"])
    gust = c["gust"]["scale"] * torch.sigmoid(c["gust"]["centre"] - x[:, 1])
    padded = nominal + c["dt"] * torch.nn.functional.pad(gust[:, None], (4, 2))
    _expect("RTI model", torch.equal(rti["step_fn"](x, u), nominal), True)
    _expect("plant", torch.equal(sp.plant(x, u), padded), True)
    _expect("filter model on the probe", torch.equal(
        sp.F_filter(x, u), padded if "filter_model" in c["gust"]["on"] else nominal), True)
    xT = torch.tensor(r["x_target"], device=dev)
    _expect("descent reference", torch.equal(
        rti["reference_fn"](x), cubic_descent_reference(x, xT, ref["steps"], c["dt"])), True)


def check_solves(c: dict, rec: dict) -> None:
    """The ADMM settings of the RTI's QP and of the filter's as the
    program's solve record gives them for one filtered step."""
    _expect("RTI feedbacks recorded in a step", len(rec["rti"]), 1)
    for e in rec["rti"]:
        _expect("RTI ADMM settings", _admm_settings(e["admm"], False),
                _want_admm(c["rti_admm"], False, c["precision"]))
    for e in rec["filter"]:
        _expect("filter ADMM settings", _admm_settings(e["admm"], True),
                _want_admm(c["filter_admm"], True, c["precision"]))


def run(cell: Cell) -> Outcome:
    from gpmpc_tpu_torch import main_path as paths
    from gpmpc_tpu_torch.experiments import run_campaign
    from gpmpc_tpu_torch.safety import filtered_controller_info
    from gpmpc_tpu_torch.utils.profiler import solve_record

    t, c, dev = cell.traffic, cell.config, cell.device
    sp = getattr(paths, c["program_path"])(dev)
    finit, fstep = paths.filtered_controller(sp)
    check_path(c, sp, fstep)
    gen = draws.generator(cell.seed, dev)
    L, campaigns = t["lanes"], t["campaigns"]
    x0s = draws.states(gen, t["state_dist"], campaigns * L).reshape(campaigns, L, 7)
    warm = draws.states(gen, t["state_dist"], L)
    sim = dataclasses.replace(sp.sim, max_steps=t["max_steps"])

    warm_rec = []

    def warm_step(cstate, x, k):
        if k:
            return fstep(cstate, x, k)
        with solve_record() as rec:
            warm_rec.append(rec)
            return fstep(cstate, x, k)

    warm_sim = dataclasses.replace(sim, max_steps=t["warmup_steps"])
    run_campaign(finit, warm_step, sp.plant, warm, warm_sim,
                 cstate_info=filtered_controller_info)["outcome"].cpu()
    check_solves(c, warm_rec[0])

    cg = draws.check_generator(cell.seed)
    ck = t["check"]
    sampled = [0] + draws.sample(cg, ck["cycles"], ck["first_cycle"], ck["last_cycle"])
    lanes = {k: torch.tensor(draws.sample(cg, ck["lanes"], 0, L), device=dev) for k in sampled}
    records = []
    tracer = cell.tracer
    steps = [0]
    first = [True]
    pending = [None]

    def stepper(cstate, x, k):
        rec = first[0] and k in lanes
        tracer.before_unit()
        if rec:
            with solve_record() as solves:
                u, new_state = fstep(cstate, x, k)
        else:
            u, new_state = fstep(cstate, x, k)
        tracer.after_unit()
        if rec:
            pending[0] = {"cycle": k, "lanes": lanes[k], "state": cstate, "x": x, "u": u,
                          "new_state": new_state, "rti": solves["rti"],
                          "filter": solves["filter"]}
            records.append(pending[0])
        steps[0] += 1
        return u, new_state

    def plant(x, u):
        x_next = sp.plant(x, u)
        if pending[0] is not None:
            pending[0]["x_next"] = x_next
            pending[0] = None
        return x_next

    cell.mark_setup_end()
    t0 = time.perf_counter()
    n = 0
    first_campaign = None
    while True:
        res = run_campaign(finit, stepper, plant, x0s[n % campaigns], sim,
                           cstate_info=filtered_controller_info)
        res["outcome"].cpu()
        if first[0]:
            first_campaign = res
        first[0] = False
        n += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    elapsed = time.perf_counter() - t0
    tracer.stop()
    return Outcome(e2e={"lane_cycles_per_s": L * steps[0] / elapsed}, units=steps[0],
                   records=records,
                   inputs={"x_start": x0s[0], "first_campaign": first_campaign,
                           "campaigns": n})
