"""The check of the 6-DoF GP-MPC cell: sampled cycles of sampled lanes, each
judged against the plain reference's cycle from the same inputs and the
same GP weights. The weights were made by the reference itself in set-up
(``reference/gp6dof.py::make_weights``) from the states and controls the
program flew, and loaded into the program's GP; the program factors them
and computes every posterior from them, the reference likewise.

As in the 3-DoF check (``gpmpc_cycle.py``), the reference follows the
program's carry (X_lin, U_lin, y, ρ), except at an episode's start, where it
makes the carry itself from x₀; it works out each lane's reference window
itself from the episode's first state and the cycle's step. The plant step
is judged on the program's u0. Three numbers are compared, each the
largest over the sampled answers:

- ``answer_gap``: |Δu0|, |Δ shifted plan|, |Δ shifted controls| and
  |Δ plant step|, each over 1 + |ref|;
- ``duals_gap``: the carried duals by their action on the controls,
  |Δ(Aᵀy)| over 1 + the lane's largest |Aᵀy| (``_rel_lane``, A the
  reference's constraint rows), and |Δρ| over 1 + ρ. The 140 bound rows of
  q and ω act on 60 controls, and the rows of q_w sit at their bound of 1
  while a lane flies upright: y is determined only up to Aᵀ's null space,
  and in float32 it drifts along it (on the card the program's y, and the
  reference's computed in float32, lay up to 28 and 80 times the lane's
  largest dual from the float64 y where Aᵀy agreed to 1e-3);
- ``sigma_gap``: |ΔΣ| over the lane's largest |Σ|.

Two decisions of the cycle may fall either way in float32 where the float64
reference lies near their edge, and either branch is then allowed (each
band twice the largest departure of the program from float64 read on the
card, PERF.md §2):

- the early stop. The solver tests every lane after its first 30
  iterations, freezes those that pass and runs 30 more on the others,
  unless every lane of the batch passed. The record carries how many chunks
  the program launched; with two, a lane may have stopped after 30 where
  the test's margin (``gpmpc6dof.py::_margin``, ≤ 1 passes) lies within
  ``STOP_BAND`` of 1 on a log scale, or where the reference computed in
  float32 decides the test otherwise. A CPU run launches no kernel (0
  recorded): either schedule is then taken for every lane;
- the acceptance of the solve (primal residual ≤ 0.01 or SOLVED), for each
  of those schedules: where the float64 residual lies within
  ``RESIDUAL_BAND`` of the tolerance (a share of it), or where the
  reference computed in float32 decides it otherwise.

The witness of those float32 decisions is the reference's cycle in float32
with its GP in float64, the configured precisions.
"""

from __future__ import annotations

import torch

from ..reference import gp6dof, gpmpc6dof
from ..reference.prec import F32, F64, Prec
from .gpmpc_cycle import ANSWER, SIGMA, _rel, _verdict

DUALS = "duals_gap"

# how far the float64 residual may lie from the acceptance tolerance, as a
# share of it, and still take either branch: the program's residual lay up
# to 0.295 of the tolerance from the float64 one (14 seeds, 2,352 lanes)
RESIDUAL_BAND = 0.6
# how far the early stop's margin may lie from 1, as |log margin|, and still
# stop either way: the program stopped otherwise than float64 at up to 0.241
STOP_BAND = 0.5
SCHEDULES = ("v30", "v60")


def _rel_lane(a, b):
    """|a − b| over 1 + the lane's largest |b|, the largest of the lane."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return (a - b).abs().amax(1) / (1.0 + b.abs().amax(1))


def _action(A, y):
    """Aᵀy of every lane, in float64."""
    return (A.double().transpose(1, 2) @ y.double()[..., None])[..., 0]


def inputs(outcome) -> dict:
    """The sampled lanes' inputs, stacked over the sampled cycles."""
    cols = {k: [] for k in ("start", "cycle", "k", "chunks", "x", "x_start", "X_lin", "U_lin",
                            "x_ref", "rho", "y", "frozen")}
    for r in outcome.records:
        i, s = r["lanes"], r["state"]
        full = lambda v: torch.full((i.shape[0],), v, device=i.device)
        cols["start"].append(full(bool(r["start"])))
        for key in ("cycle", "k", "chunks"):
            cols[key].append(full(int(r[key])))
        cols["x"].append(r["x"][i])
        cols["x_start"].append(r["x_start"][i])
        for key, v in (("X_lin", s.X_lin), ("U_lin", s.U_lin), ("x_ref", s.x_ref),
                       ("rho", s.rho), ("y", s.y_prev)):
            cols[key].append(v[i])
        cols["frozen"].append(r["landed"][i])
    return {k: torch.cat(v) for k, v in cols.items()}


def program(outcome) -> dict:
    """The program's answers on the sampled lanes."""
    out = {k: [] for k in ("u0", "X_shift", "U_shift", "y", "rho", "Sigmas", "x_next")}
    for r in outcome.records:
        i, new = r["lanes"], r["new_state"]
        for key, v in (("u0", r["u0"]), ("X_shift", new.X_lin), ("U_shift", new.U_lin),
                       ("y", new.y_prev), ("rho", new.rho), ("Sigmas", r["Sigmas"]),
                       ("x_next", r["x_next"])):
            out[key].append(v[i])
    return {k: torch.cat(v) for k, v in out.items()}


def reference_gp(P: Prec, outcome) -> gp6dof.GP:
    """The reference's GP factored in P from the weights it made."""
    w = outcome.inputs["gp"]
    return gp6dof.from_weights(P, w, w["trans"]["X"].device)


def reference(P: Prec, c: dict, gp, inp: dict) -> dict:
    """The reference cycle on the inputs; the start lanes from its own carry."""
    x = inp["x"].to(P.dtype)
    own = gpmpc6dof.init_state(P, c, x)
    st = {k: torch.where(inp["start"].reshape(-1, *([1] * (own[k].dim() - 1))), own[k],
                         inp[k].to(P.dtype))
          for k in ("X_lin", "U_lin", "rho", "y")}
    return gpmpc6dof.cycle(P, c, gp, st, x, inp["x_start"].to(P.dtype), inp["k"])


def with_witness(c: dict, outcome, inp: dict, ref: dict) -> dict:
    """``ref`` with the decisions of the reference computed in the configured
    precisions (the cycle in float32, the GP in float64), the witness of how
    the program's arithmetic decides them."""
    w = reference(F32, c, reference_gp(F64, outcome), inp)
    out = dict(ref, witness_conv30=w["conv30"])
    for tag in SCHEDULES:
        out[tag] = dict(ref[tag], witness_ok=w[tag]["ok"])
    return out


def plant_answer(c: dict, inp: dict, u0: torch.Tensor, dtype) -> torch.Tensor:
    x = inp["x"].to(dtype)
    return torch.where(inp["frozen"][:, None], x, gpmpc6dof.plant_step(c, x, u0.to(dtype)))


def gaps(c: dict, inp: dict, ans: dict, ref: dict):
    """Every sampled answer's gaps by number, the parts' largest values and
    the counts of lanes whose decisions may fall either way. Of the
    schedules a lane may have run, the one whose answer lies nearest is
    taken, and its duals are compared."""
    tol = c["accept_pri_tol"]
    plant = _rel(ans["x_next"], plant_answer(c, inp, ans["u0"], torch.float64))
    solve = lambda v, br: torch.stack([_rel(ans["u0"], v[br + "u0"]),
                                       _rel(ans["X_shift"], v[br + "X_shift"]),
                                       _rel(ans["U_shift"], v[br + "U_shift"])]).amax(0)
    g = {}
    action = _action(ref["A"], ans["y"])
    for tag in SCHEDULES:
        v = ref[tag]
        duals = torch.maximum(_rel_lane(action, _action(ref["A"], v["y"])),
                              _rel(ans["rho"][:, None], v["rho"][:, None]))
        either = (((v["pri_res"] - tol).abs() <= RESIDUAL_BAND * tol)
                  | (v["ok"] != v["witness_ok"]))
        taken = solve(v, "")
        branch = torch.where(either, torch.minimum(taken, solve(v, "alt_")), taken)
        g[tag] = {"answer": torch.maximum(branch, plant), "taken": taken, "duals": duals,
                  "either": either, "ok": v["ok"]}
    two, uncounted = inp["chunks"] == 2, inp["chunks"] == 0
    ran60 = (two | uncounted) & ~ref["conv30"]  # the reference's own schedule
    stop_either = uncounted | (two & ((ref["margin30"].log().abs() <= STOP_BAND)
                                      | (ref["conv30"] != ref["witness_conv30"])))
    own = lambda key: torch.where(ran60, g["v60"][key], g["v30"][key])
    other = lambda key: torch.where(ran60, g["v30"][key], g["v60"][key])
    switch = stop_either & (other("answer") < own("answer"))
    pick = lambda key: torch.where(switch, other(key), own(key))
    S, Sr = ans["Sigmas"].double(), ref["Sigmas"].double()
    sigma = (S - Sr).abs().flatten(1).amax(1) / Sr.abs().flatten(1).amax(1)
    per = {ANSWER: pick("answer"), DUALS: pick("duals"), SIGMA: sigma}
    u0 = torch.where(ran60, _rel(ans["u0"], ref["v60"]["u0"]), _rel(ans["u0"], ref["v30"]["u0"]))
    parts = {"u0": u0, "plan": own("taken"), "plant": plant, "duals_own": own("duals"),
             "window": _rel(inp["x_ref"], ref["x_ref"])}
    counts = {"either_branch_lanes": int(own("either").sum()),
              "either_stop_lanes": int(stop_either.sum()), "switched_lanes": int(switch.sum()),
              "ran60_lanes": int(ran60.sum()), "rejected_lanes": int((~own("ok")).sum()),
              "chunks": sorted(set(inp["chunks"].tolist()))}
    return per, {k: float(v.max()) for k, v in parts.items()}, counts


def judge(c: dict, outcome, P: Prec) -> dict:
    """The numbers compared, over the program's sampled answers."""
    inp = inputs(outcome)
    gp = reference_gp(P, outcome)
    ref = with_witness(c, outcome, inp, reference(P, c, gp, inp))
    per, parts, counts = gaps(c, inp, program(outcome), ref)
    worst = per[ANSWER].argsort(descending=True)[:3]
    parts.update(counts, gp_jitter_retried=gp.retried,
                 worst=[{"gap": float(per[ANSWER][j]), "cycle": int(inp["cycle"][j]),
                         "chunks": int(inp["chunks"][j]), "margin30": float(ref["margin30"][j]),
                         "pri_res": [float(ref[t]["pri_res"][j]) for t in SCHEDULES],
                         "x": inp["x"][j].tolist()} for j in worst.tolist()])
    return _verdict(per, parts)


def control(c: dict, outcome, P: Prec, control_prec: Prec, gp_prec: Prec = None) -> dict:
    """The control: the reference in ``control_prec`` (its GP in
    ``gp_prec``, by default the same) in the program's place, on the
    program's schedule, judged as the program is."""
    inp = inputs(outcome)
    gp = reference_gp(gp_prec or control_prec, outcome)
    out = reference(control_prec, c, gp, inp)
    v = {tag: out[tag] for tag in SCHEDULES}
    ran60 = (inp["chunks"] != 1) & ~out["conv30"]
    pick = lambda key: torch.where(ran60.reshape(-1, *([1] * (v["v30"][key].dim() - 1))),
                                   v["v60"][key], v["v30"][key])
    ans = {k: pick(k) for k in ("u0", "X_shift", "U_shift", "y", "rho")}
    ans.update(Sigmas=out["Sigmas"],
               x_next=plant_answer(c, inp, ans["u0"], control_prec.dtype))
    ref = with_witness(c, outcome, inp, reference(P, c, reference_gp(P, outcome), inp))
    per, parts, _ = gaps(c, inp, ans, ref)
    return _verdict(per, parts)
