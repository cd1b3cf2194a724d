"""The check of the rescue cell: sampled cycles of the first campaign, the
filter judged on every lane and the RTI step on sampled lanes, each against
the plain reference (``reference/safety3dof.py``) from the same inputs.

The reference follows the program's carry, as the GP-MPC checks do: the
RTI step takes the program's plan, duals and ρ, except at the campaign's
start, where it makes the carry itself from x₀, and it works out each
lane's reference window itself from the campaign's first state and the
cycle's step; the filter takes the program's x and the control u_nom that
the program's RTI step handed it, and each SCP iteration after the first
takes the program's linearization point (the warm start of the program's
next QP), which is itself judged against the reference's own choice. The
plant step is judged on the program's control. Three numbers are
compared, each the largest over the sampled answers and each relative, a
difference over 1 + |ref|:

- ``answer_gap``: on the sampled RTI lanes the plan (u0, X_opt, U_opt);
  on every lane the filtered control, the plant step, and the hit counters
  (a wrong hit reads 1);
- ``duals_gap``: on the sampled RTI lanes the carried duals by their action
  Aᵀy, over 1 + the lane's largest |Aᵀy| (the 140 state-bound rows act on
  60 controls: y is determined only up to Aᵀ's null space), and ρ;
- ``filter_gap``: on every lane, for each SCP iteration, V(x_N) and ∂V/∂u
  at its linearization point, the QP's status (a status the band does not
  allow reads 1), its solution where both solved it (an unconverged
  iterate is no answer: the filter discards it), and the points the
  iteration starts from and hands on, each as the program's solve record
  (``utils.profiler.solve_record``) gives it. An SCP iteration the program
  did not run reads as infinite.

A lane whose state is not finite reads as infinite, and a non-finite
answer gives a non-finite gap: either fails the cell, since the program
flies no lane to a non-finite state.

Five decisions may fall either way where the float64 reference lies near
their edge. At each, either branch is allowed inside a band sized by the
float32 witness (the reference computed in float32 on the same inputs):
where the witness decides otherwise, or where the deciding quantity lies
within ``WITNESS`` times the witness's departure from float64 of its
threshold, and never nearer than the decision's floor:

- the RTI early exit: the test after 25 iterations, by its margin (≤ 1
  passes; ``STOP_FLOOR``); the program's schedule, read from its
  solution's iteration count, is taken where the band allows it;
- the RTI acceptance: the primal residual against ``accept_pri_tol``
  (``RESIDUAL_FLOOR``, a share of the tolerance), for the schedule taken;
- ``safe``: V(x_N(u_nom)) against α (``SAFE_FLOOR``);
- the filter QP's SOLVED, for each SCP iteration: the termination test's
  margin at its final point (``QP_FLOOR``);
- the in-flight hit: the altitude against the threshold (``ALT_FLOOR``).

``parts`` reports the sampled cycles, how many lanes were unsafe and how
many took each branch, the share of the sampled in-flight lanes that the
program's filter found unsafe, and the first campaign's filtered success
and intervention rate.
"""

from __future__ import annotations

import torch

from ..reference import safety3dof as ref3
from ..reference.prec import F32, Prec

ANSWER, DUALS, FILTER = "answer_gap", "duals_gap", "filter_gap"
WITNESS = 4.0
STOP_FLOOR = 0.05
RESIDUAL_FLOOR = 0.05
SAFE_FLOOR = 1e-5
QP_FLOOR = 0.05
ALT_FLOOR = 1e-6


def _rel(a, b):
    """|a − b| over 1 + |b|, the largest of each lane."""
    a, b = a.double(), b.double()
    return ((a - b).abs() / (1.0 + b.abs())).reshape(a.shape[0], -1).amax(1)


def _rel_lane(a, b):
    """|a − b| over 1 + the lane's largest |b|, the largest of the lane."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return (a - b).abs().amax(1) / (1.0 + b.abs().amax(1))


def _band(q64, q32, thr, floor):
    """Whether a decision q ≤ thr may fall either way: q64 within
    max(floor, WITNESS·|q32 − q64|) of thr, or q32 decides otherwise."""
    q64, q32 = q64.double(), q32.double()
    near = (q64 - thr).abs() <= torch.clamp(WITNESS * (q32 - q64).abs(), min=floor)
    return near | ((q64 <= thr) != (q32 <= thr))


def _inner(cstate):
    """(RTIState, counters (n_int, n_early, consec)) of a filtered carry."""
    (rti, _), n_int, n_early, consec, _ = cstate
    return rti, (n_int, n_early, consec)


# -- the program's answers --------------------------------------------------------

def program(r: dict) -> dict:
    """The program's answers of a sampled cycle: the filter's on every lane
    and the RTI step's on the sampled lanes."""
    _, cnt0 = _inner(r["state"])
    new, cnt1 = _inner(r["new_state"])
    its = [{"V": e["V"].double(), "g": e["dVdu"].double(), "x": e["x"], "ok": e["ok"],
            "u_lin": e["u_lin"].double()} for e in r["filter"]]
    i = r["lanes"]
    rti = {"X_opt": new.X_lin[i], "U_opt": new.U_lin[i], "y": new.y_prev[i],
           "rho": new.rho[i], "x_ref": new.x_ref[i],
           "iterations": r["rti"][-1]["iterations"][i]}
    return {"u_nom": new.U_lin[:, 0], "its": its, "u": r["u"], "x_next": r["x_next"],
            "counts": tuple(b - a for a, b in zip(cnt0[:2], cnt1[:2])) + (cnt1[2],),
            "consec0": cnt0[2], "rti": rti}


# -- the reference on the program's inputs ----------------------------------------

def rti_inputs(P: Prec, c: dict, r: dict, x_start) -> tuple:
    """The sampled lanes' carry (the reference's own at the campaign's
    start), state, first state and step."""
    i = r["lanes"]
    x = r["x"][i].to(P.dtype)
    if r["cycle"] == 0:
        st = ref3.rti_init(P, c, x)
    else:
        s, _ = _inner(r["state"])
        st = {"X_lin": s.X_lin[i], "U_lin": s.U_lin[i], "X_prev": s.X_prev[i],
              "U_prev": s.U_prev[i], "y": s.y_prev[i], "rho": s.rho[i]}
        st = {k: v.to(P.dtype) for k, v in st.items()}
    k = torch.full((i.shape[0],), int(r["cycle"]), device=x.device)
    return st, x, x_start[i].to(P.dtype), k


def reference(P: Prec, c: dict, r: dict, x_start, u_nom, follow) -> dict:
    """The reference's RTI step on the sampled lanes and filter on every
    lane, from the program's inputs."""
    return {"rti": ref3.rti_cycle(P, c, *rti_inputs(P, c, r, x_start)),
            "filter": ref3.filter_cycle(P, c, r["x"], u_nom, follow=follow)}


# -- the gaps --------------------------------------------------------------------------

def rti_gaps(c: dict, ans: dict, ref: dict, wit: dict):
    """(answer gaps, duals gaps, parts, counts) of the sampled RTI lanes."""
    tol = c["rti"]["accept_pri_tol"]
    stop_either = _band(ref["margin25"], wit["margin25"], 1.0, STOP_FLOOR) \
        | (ref["conv25"] != wit["conv25"])
    ran50 = ~ref["conv25"]
    use50 = torch.where(stop_either, ans["iterations"] > c["rti_admm"]["chunk"], ran50)
    action = lambda y: (ref["A"].double().transpose(1, 2) @ y.double()[..., None])[..., 0]
    per_tag = {}
    for tag in ("v25", "v50"):
        v, w = ref[tag], wit[tag]
        either = _band(v["pri_res"], w["pri_res"].double(), tol, RESIDUAL_FLOOR * tol) \
            | (v["ok"] != w["ok"])
        plan = lambda br: torch.maximum(_rel(ans["X_opt"], v[br + "X_opt"]),
                                        _rel(ans["U_opt"], v[br + "U_opt"]))
        duals = lambda br: torch.maximum(_rel_lane(action(ans["y"]), action(v[br + "y"])),
                                         _rel(ans["rho"][:, None], v["rho"][:, None]))
        taken, other = plan(""), plan("alt_")
        switch = either & (other < taken)
        per_tag[tag] = {"answer": torch.where(switch, other, taken),
                        "duals": torch.where(switch, duals("alt_"), duals("")),
                        "either": either, "switch": switch, "ok": v["ok"],
                        "u0": _rel(ans["U_opt"][:, 0], v["U_opt"][:, 0])}
    pick = lambda key: torch.where(use50, per_tag["v50"][key], per_tag["v25"][key])
    counts = {"rti_lanes": int(use50.numel()), "rti_either_stop": int(stop_either.sum()),
              "rti_ran50": int(use50.sum()), "rti_ran50_reference": int(ran50.sum()),
              "rti_either_accept": int(pick("either").sum()),
              "rti_switched": int(pick("switch").sum()), "rti_rejected": int((~pick("ok")).sum())}
    parts = {"rti_u0": pick("u0"), "rti_plan": pick("answer"), "rti_duals": pick("duals"),
             "rti_window": _rel(ans["x_ref"], ref["x_ref"])}
    return pick("answer"), pick("duals"), parts, counts


def filter_gaps(c: dict, k: int, x, ans: dict, ref: dict, wit: dict):
    """(answer gaps, filter gaps, parts, counts) of every lane's filter."""
    f = c["filter"]
    B = x.shape[0]
    inf = torch.full((B,), float("inf"), dtype=torch.float64, device=x.device)
    its_r, its_w, its_p = ref["its"], wit["its"], ans["its"]
    fgap = torch.zeros(B, dtype=torch.float64, device=x.device)
    parts = {}
    qp_either = []
    zero = torch.zeros_like(fgap)
    for i, (r, w) in enumerate(zip(its_r, its_w)):
        either = _band(r["margin"], w["margin"], 1.0, QP_FLOOR) | (r["ok"] != w["ok"])
        qp_either.append(either)
        if i >= len(its_p):
            fgap = inf
            continue
        p = its_p[i]
        V, g = _rel(p["V"][:, None], r["V"][:, None]), _rel(p["g"], r["g"])
        # the QP's status, and its solution where both solved it: an
        # unconverged iterate is no answer (the filter discards it)
        status = ((p["ok"] != r["ok"]) & ~either).double()
        sx = torch.where(p["ok"] & r["ok"], _rel(p["x"], r["x"]), zero)
        # the point the iteration starts from and the one it hands on, by
        # the program's own status
        start = _rel(p["u_lin"], ans["u_nom"]) if i == 0 else zero
        if i + 1 < len(its_p):
            nxt = torch.where(p["ok"][:, None], p["x"][:, :3].double(), p["u_lin"])
            carry = torch.maximum(start, _rel(its_p[i + 1]["u_lin"], nxt))
        else:
            carry = start
        fgap = torch.maximum(fgap, torch.stack([V, g, status, sx, carry]).amax(0))
        for name, v in (("V", V), ("dVdu", g), ("status", status), ("qp_x", sx),
                        ("carry", carry)):
            parts[f"filter_{name}{i}"] = v
    safe = ref["safe"]
    safe_either = _band(ref["V_nom"], wit["V_nom"], ref3.alpha(c), SAFE_FLOOR * (1 + ref3.alpha(c)))
    ok, ok_either = ref["qp_ok"], qp_either[-1]
    allowed = {"u_nom": safe | safe_either,
               "u_qp": (~safe | safe_either) & (ok | ok_either),
               "u_backup": (~safe | safe_either) & (~ok | ok_either)}
    # where only the band lets the last QP count as solved, its solution
    # is the program's own
    last = len(its_r) - 1
    u_qp = ref["u_qp"]
    if last < len(its_p):
        u_qp = torch.where(ok[:, None], u_qp, its_p[last]["x"][:, :3].to(u_qp.dtype))
    cands = {"u_nom": ref["u_nom"], "u_qp": u_qp, "u_backup": ref["u_backup"]}
    u = ans["u"]
    ugap = torch.stack([torch.where(allowed[key], _rel(u, cands[key]), inf)
                        for key in ("u_nom", "u_qp", "u_backup")]).amin(0)
    plant = _rel(ans["x_next"], ref3.plant_step(c, x.double(), u.double()))
    alt = x[:, 1].double()
    thr = f["in_flight_altitude"]
    flight = alt > thr
    flight_either = (alt - thr).abs() <= ALT_FLOOR
    d_int, d_early, consec = (t.double() for t in ans["counts"])
    consec0 = ans["consec0"].double()
    early = float(k < f["half_step"])

    def counter_gap(hit):
        h = hit.double()
        return torch.stack([(d_int - h).abs(), (d_early - early * h).abs(),
                            (consec - torch.where(hit, consec0 + 1, 0.0)).abs()]).amax(0)

    hit = ~safe & flight
    hit_either = (safe_either & flight) | (~safe & flight_either) | (safe_either & flight_either)
    cgap = torch.where(hit_either, torch.minimum(counter_gap(hit), counter_gap(~hit)),
                       counter_gap(hit))
    answer = torch.stack([ugap, plant, cgap]).amax(0)
    parts.update(filter_u=ugap, plant=plant, counters=cgap)
    counts = {"filter_lanes": B, "unsafe": int((~safe).sum()),
              "either_safe": int(safe_either.sum()),
              "qp_not_solved": [int((~r["ok"]).sum()) for r in its_r],
              "either_qp": [int(e.sum()) for e in qp_either],
              "backup_taken": int((~safe & ~ok).sum()), "in_flight": int(flight.sum()),
              "hits": int(hit.sum()), "either_hit": int(hit_either.sum()),
              "program_hits": int(d_int.sum())}
    return answer, fgap, parts, counts


def _merge_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        if isinstance(v, list):
            old = total.get(k, [0] * len(v))
            total[k] = [a + b for a, b in zip(old + [0] * (len(v) - len(old)), v)]
        else:
            total[k] = total.get(k, 0) + v


def gaps(c: dict, outcome, answers: list, P: Prec):
    """The gaps of every answer by number, over ``answers`` (one a sampled
    record), the parts' largest values and the branch counts."""
    x_start = outcome.inputs["x_start"]
    per = {ANSWER: [], DUALS: [], FILTER: []}
    parts_max, counts = {}, {"cycles": []}
    for r, ans in zip(outcome.records, answers):
        follow = [None] + [p["u_lin"] for p in ans["its"][1:]]
        ref = reference(P, c, r, x_start, ans["u_nom"], follow)
        wit = reference(F32, c, r, x_start, ans["u_nom"], follow)
        a_rti, d_rti, p_rti, c_rti = rti_gaps(c, ans["rti"], ref["rti"], wit["rti"])
        a_f, f_f, p_f, c_f = filter_gaps(c, int(r["cycle"]), r["x"], ans, ref["filter"],
                                         wit["filter"])
        # a lane whose state is not finite reads as infinite
        bad = ~torch.isfinite(r["x"]).all(1)
        a_f, f_f = (torch.where(bad, float("inf"), v) for v in (a_f, f_f))
        a_rti, d_rti = (torch.where(bad[r["lanes"]], float("inf"), v) for v in (a_rti, d_rti))
        per[ANSWER] += [a_f, a_rti]
        per[DUALS].append(d_rti)
        per[FILTER].append(f_f)
        for k, v in {**p_rti, **p_f}.items():
            parts_max[k] = max(parts_max.get(k, 0.0), float(v.max()))
        counts["cycles"].append(int(r["cycle"]))
        _merge_counts(counts, {**c_rti, **c_f})
    per = {k: torch.cat(v) for k, v in per.items()}
    return per, parts_max, counts


def first_campaign(outcome) -> dict:
    """The first campaign's filtered success and intervention rate."""
    res = outcome.inputs.get("first_campaign")
    if res is None:
        return {}
    n_int = res["n_interventions"].double()
    return {"success_rate": float((res["outcome"] == 0).double().mean()),
            "intervention_rate": float((n_int > 0).double().mean()),
            "interventions_per_episode": float(n_int.mean()),
            "steps_max": int(res["steps"].max()), "campaigns": outcome.inputs.get("campaigns")}


def _verdict(per: dict, parts: dict) -> dict:
    return {"numbers": {k: float(v.max()) for k, v in per.items()}, "per_answer": per,
            "parts": parts}


def judge(c: dict, outcome, P: Prec) -> dict:
    """The numbers compared, over the program's sampled answers."""
    answers = [program(r) for r in outcome.records]
    per, parts, counts = gaps(c, outcome, answers, P)
    # the share of the sampled in-flight lanes that the program's filter
    # found unsafe: the traffic's, reported and not judged
    share = 100.0 * counts["program_hits"] / max(counts["in_flight"], 1)
    parts.update(counts, intervention_share=share, first_campaign=first_campaign(outcome))
    return _verdict(per, parts)


def reference_answers(c: dict, r: dict, x_start, prec: Prec) -> dict:
    """The reference's answers of a sampled record, computed in ``prec``
    from ``c``, in the form :func:`program` gives the program's: its RTI
    step on its own schedule and acceptance, its filter on its own carry
    from the program's u_nom."""
    prog = program(r)
    rti = ref3.rti_cycle(prec, c, *rti_inputs(prec, c, r, x_start))
    use50 = ~rti["conv25"]
    pick = lambda key: torch.where(use50.reshape(-1, *([1] * (rti["v25"][key].dim() - 1))),
                                   rti["v50"][key], rti["v25"][key])
    it = torch.where(use50, c["rti_admm"]["iterations"], c["rti_admm"]["chunk"])
    fl = ref3.filter_cycle(prec, c, r["x"], prog["u_nom"])
    its = [{"V": i["V"].double(), "g": i["g"].double(), "x": i["x"], "ok": i["ok"],
            "u_lin": i["u_lin"]} for i in fl["its"]]
    u = ref3.filtered_control(fl)
    hit = ~fl["safe"] & (r["x"][:, 1] > c["filter"]["in_flight_altitude"])
    consec0 = prog["consec0"]
    early = int(r["cycle"]) < c["filter"]["half_step"]
    return {"u_nom": prog["u_nom"], "its": its, "u": u,
            "x_next": ref3.plant_step(c, r["x"].to(prec.dtype), u),
            "counts": (hit.long(), hit.long() * early,
                       torch.where(hit, consec0 + 1, torch.zeros_like(consec0))),
            "consec0": consec0, "rti": {"X_opt": pick("X_opt"), "U_opt": pick("U_opt"),
                                        "y": pick("y"), "rho": pick("rho"),
                                        "x_ref": rti["x_ref"], "iterations": it}}


def control(c: dict, outcome, P: Prec, control_prec: Prec) -> dict:
    """The control: the reference in ``control_prec`` in the program's
    place, judged as the program is."""
    x_start = outcome.inputs["x_start"]
    answers = [reference_answers(c, r, x_start, control_prec) for r in outcome.records]
    per, parts, _ = gaps(c, outcome, answers, P)
    return _verdict(per, parts)
