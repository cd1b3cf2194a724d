"""The check of the GP-MPC cells: sampled cycles of sampled lanes, each judged
against the plain reference's cycle from the same inputs.

A cycle's inputs are the measured state x₀ and the carried plan, duals and
ρ. At the start of an episode the reference makes the carry itself from
x₀; later, it takes the program's carry (the reference can only follow the
closed loop step by step: a one-ulp change moves a closed loop far). Both
stages that this skips are checked apart: the start, and the carry that
each sampled cycle leaves (the shifted plan), which the reference works out
from its own solve. The plant step is judged on the program's u0.

Two numbers are compared, each the largest over the sampled answers:
``answer_gap`` of |Δu0|, |Δ shifted plan|, |Δ shifted controls|, |Δ carried
duals y and ρ| and |Δ plant step|, each over 1 + |ref|; and, where the cell
keeps the covariances (the real-time loop), ``sigma_gap``: |ΔΣ| over the
lane's largest |Σ|, the covariance that sets the chance back-offs. They are
apart because the f32 posterior variance (1 − ‖v‖² + ‖w‖², a difference of
near equals) makes Σ the noisier of the two.

A solve is accepted where its primal residual is at most the tolerance.
After its fixed 50 iterations the residual is not converged, and float32
moves it: with A diagonal, as here, each iteration's residual is (1 − α)
times the last one plus the duals' step over ρ, so a solve whose duals lie
off the reference's by δ has its residual moved by a multiple of δ, above a
floor of rounding. A lane may take either branch where the float64 reference's
residual lies within ``RESIDUAL_FLOOR`` of the tolerance plus
``RESIDUAL_PER_DUAL`` times the lane's own gap of the carried duals, or
where the reference computed in float32, the configuration's precision,
decides it otherwise. The duals are carried on either branch and compared
on every lane.
"""

from __future__ import annotations

import torch

from ..reference import gp3dof, gpmpc3dof
from ..reference import dynamics3dof as dyn
from ..reference.prec import F32, Prec

ANSWER, SIGMA = "answer_gap", "sigma_gap"
# how far a lane's residual may lie from the tolerance and still take either
# branch: a floor (a share of the tolerance) plus a multiple of the lane's
# duals' gap, each twice what bounds every shift of the program's residual
# from the float64 reference's that was read on the card (PERF.md §2)
RESIDUAL_FLOOR, RESIDUAL_PER_DUAL = 0.02, 8.0


def inputs(outcome) -> dict:
    """The sampled lanes' inputs, stacked over the sampled cycles."""
    cols = {k: [] for k in ("start", "x", "X_lin", "U_lin", "x_ref", "rho", "y", "frozen",
                            "has_next", "cycle")}
    for r in outcome.records:
        i, s = r["lanes"], r["state"]
        n = i.shape[0]
        cols["start"].append(torch.full((n,), bool(r["start"]), device=i.device))
        cols["cycle"].append(torch.full((n,), int(r["cycle"]), device=i.device))
        cols["x"].append(r["x"][i])
        for k, v in (("X_lin", s.X_lin), ("U_lin", s.U_lin), ("x_ref", s.x_ref),
                     ("rho", s.rho), ("y", s.y_prev)):
            cols[k].append(v[i])
        if "x_next" in r:
            frozen = (r["landed"][i] if "landed" in r
                      else (r["x_next"][i] == r["x"][i]).all(-1))
            cols["frozen"].append(frozen)
            cols["has_next"].append(torch.ones(n, dtype=torch.bool, device=i.device))
        else:
            cols["frozen"].append(torch.zeros(n, dtype=torch.bool, device=i.device))
            cols["has_next"].append(torch.zeros(n, dtype=torch.bool, device=i.device))
    return {k: torch.cat(v) for k, v in cols.items()}


def program(outcome) -> dict:
    """The program's answers on the sampled lanes."""
    out = {"u0": [], "X_shift": [], "U_shift": [], "y": [], "rho": [], "Sigmas": [],
           "x_next": []}
    for r in outcome.records:
        i, new = r["lanes"], r["new_state"]
        out["u0"].append(r["u0"][i])
        out["X_shift"].append(new.X_lin[i])
        out["U_shift"].append(new.U_lin[i])
        out["y"].append(new.y_prev[i])
        out["rho"].append(new.rho[i])
        if "Sigmas" in r:
            out["Sigmas"].append(r["Sigmas"][i])
        out["x_next"].append(r["x_next"][i] if "x_next" in r else r["x"][i])
    return {k: torch.cat(v) if v else None for k, v in out.items()}


def reference_gp(P: Prec, c: dict, outcome) -> gp3dof.GP:
    """The reference's own fit from the seed's exploration draws."""
    inp = outcome.inputs
    X, U, res = gp3dof.explore(P, inp["excitation"], dyn.Rocket(), dyn.Rocket(**c["plant"]),
                               c["dt"])
    return gp3dof.fit(P, X, U, res, inp["init_idx"])


def reference(P: Prec, c: dict, gp, inp: dict) -> dict:
    """The reference cycle on the inputs; the start lanes from its own carry."""
    x = inp["x"].to(P.dtype)
    own = gpmpc3dof.init_state(P, c, x)
    st = {k: torch.where(inp["start"].reshape(-1, *([1] * (own[k].dim() - 1))), own[k],
                         inp[k].to(P.dtype))
          for k in ("X_lin", "U_lin", "x_ref", "rho", "y")}
    return gpmpc3dof.cycle(P, c, gp, st, x)


def plant_answer(c: dict, inp: dict, u0: torch.Tensor, dtype) -> torch.Tensor:
    x = inp["x"].to(dtype)
    xn = gpmpc3dof.plant_step(c, x, u0.to(dtype))
    return torch.where(inp["frozen"][:, None], x, xn)


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs() / (1.0 + b.abs())).flatten(1).amax(1)


def lane_gaps(c: dict, inp: dict, ans: dict, ref: dict) -> dict:
    """Every sampled answer's gaps: to the reference's accepting or rejecting
    branch as it decided (``taken``) and to the other one (``other``), of the
    carried duals, of the plant step, and of Σ where the cell keeps it."""
    def branch(tag):
        return torch.stack([_rel(ans["u0"], ref[tag + "u0"]),
                            _rel(ans["X_shift"], ref[tag + "X_shift"]),
                            _rel(ans["U_shift"], ref[tag + "U_shift"])]).amax(0)

    plant = _rel(ans["x_next"], plant_answer(c, inp, ans["u0"], torch.float64))
    out = {"taken": branch(""), "other": branch("alt_"),
           "duals": torch.maximum(_rel(ans["y"], ref["y"]),
                                  _rel(ans["rho"][:, None], ref["rho"][:, None])),
           "plant": torch.where(inp["has_next"], plant, torch.zeros_like(plant))}
    if ans.get("Sigmas") is not None:
        S, Sr = ans["Sigmas"].double(), ref["Sigmas"].double()
        out["Sigmas"] = (S - Sr).abs().flatten(1).amax(1) / Sr.abs().flatten(1).amax(1)
    return out


def either_branch(c: dict, ref: dict, g: dict) -> torch.Tensor:
    """The lanes whose acceptance float32 may decide either way."""
    tol = c["accept_pri_tol"]
    band = RESIDUAL_FLOOR * tol + RESIDUAL_PER_DUAL * g["duals"]
    return ((ref["pri_res"] - tol).abs() <= band) | (ref["ok"] != ref["witness_ok"])


def gaps(c: dict, inp: dict, ans: dict, ref: dict):
    """Every sampled answer's gaps by number, the parts' largest values and
    the lanes that may take either branch."""
    g = lane_gaps(c, inp, ans, ref)
    either = either_branch(c, ref, g)
    solve = torch.where(either, torch.minimum(g["taken"], g["other"]), g["taken"])
    per = {ANSWER: torch.stack([solve, g["duals"], g["plant"]]).amax(0)}
    parts = {"u0": _rel(ans["u0"], ref["u0"]), "plan": g["taken"], "duals": g["duals"],
             "plant": g["plant"]}
    if "Sigmas" in g:
        per[SIGMA] = parts["Sigmas"] = g["Sigmas"]
    return per, {k: float(v.max()) for k, v in parts.items()}, either


def _verdict(per: dict, parts: dict) -> dict:
    return {"numbers": {k: float(v.max()) for k, v in per.items()}, "per_answer": per,
            "parts": parts}


def with_witness(c: dict, outcome, inp: dict, ref: dict) -> dict:
    """``ref`` with the acceptance and residual of the reference computed in
    the configured precision (float32), the witness of how float32 decides."""
    w = reference(F32, c, reference_gp(F32, c, outcome), inp)
    return dict(ref, witness_ok=w["ok"], witness_pri_res=w["pri_res"])


def judge(c: dict, outcome, P: Prec) -> dict:
    """The numbers compared, over the program's sampled answers."""
    inp = inputs(outcome)
    gp = reference_gp(P, c, outcome)
    ref = with_witness(c, outcome, inp, reference(P, c, gp, inp))
    ans = program(outcome)
    per, parts, either = gaps(c, inp, ans, ref)
    worst = per[ANSWER].argsort(descending=True)[:3]
    parts.update(gp_jitter_retried=list(gp.retried), either_branch_lanes=int(either.sum()),
                 rejected_lanes=int((~ref["ok"]).sum()),
                 worst=[{"gap": float(per[ANSWER][j]), "cycle": int(inp["cycle"][j]),
                         "ok": bool(ref["ok"][j]), "ok32": bool(ref["witness_ok"][j]),
                         "pri_res": float(ref["pri_res"][j]), "x": inp["x"][j].tolist(),
                         "u0": ans["u0"][j].tolist(), "u0_ref": ref["u0"][j].tolist(),
                         "u0_alt": ref["alt_u0"][j].tolist()} for j in worst.tolist()])
    return _verdict(per, parts)


def control(c: dict, outcome, P: Prec, control_prec: Prec) -> dict:
    """The control: the reference in ``control_prec`` in the program's place,
    judged as the program is."""
    inp = inputs(outcome)
    out = reference(control_prec, c, reference_gp(control_prec, c, outcome), inp)
    ans = {"u0": out["u0"], "X_shift": out["X_shift"], "U_shift": out["U_shift"],
           "y": out["y"], "rho": out["rho"],
           "Sigmas": out["Sigmas"] if any("Sigmas" in r for r in outcome.records) else None,
           "x_next": plant_answer(c, inp, out["u0"], control_prec.dtype)}
    ref = with_witness(c, outcome, inp, reference(P, c, reference_gp(P, c, outcome), inp))
    per, parts, _ = gaps(c, inp, ans, ref)
    return _verdict(per, parts)
