"""The check of the SCVX cells: every plan the window delivered (the first
build's, or every query's) and, for a library, every query's answer, judged
against the plain reference; the reference's own sweep runs for sampled
states.

SCVX plans are not reproducible under a one-ulp change of the initial state,
so a plan is judged by what it says, not by its distance to the reference's
plan: it must be the exact rollout of its own controls (the states, the
fuel and the terminal defect it reports), keep its controls in their box,
land (terminal defect below 1) where it says it converged, and be one of
the candidate durations. For a sampled state the reference sweeps every
candidate: where it lands firmly on some (converged with room to spare: the
last step accepted by a residual under half the tolerance, the defect under
0.9), the plan must be a converged landing and burn no more fuel than the
reference's lowest-fuel firm landing. A candidate that converges only just
may go either way under rounding, so it does not set the fuel to beat. A
library must hold each plan with its times, and each query's answer must be
the nearest (or the lowest-fuel within the radius) of the library's initial
states.

The number compared, ``scvx_gap``, is the largest over the answers of: the
fuel excess over the reference's fuel; 1 for a plan that is not a converged
landing where it should be, or whose duration is no candidate; and, weighted
by CONSISTENCY_WEIGHT, |ΔX| over 1 + |X| against the rollout, |Δfuel| over
the fuel, |Δdefect|, the box violation over 5 and, for a library, the gap
of each stored row and of each query's distance to the best one over 1 +
that distance.
"""

from __future__ import annotations

import torch

from ..reference import scvx3dof
from ..reference.prec import Prec

NUMBER = "scvx_gap"
# a plan's consistency with itself is exact but for f32 rounding (readings
# under 2e-5; the box, by the ADMM tolerance, under 7e-4), its fuel against
# the reference's is not (up to 0.077): the first parts count 100 times
CONSISTENCY_WEIGHT = 100.0
_KEYS = ("X", "U", "fuel", "converged", "defect", "dt")


def _plans(outcome) -> tuple:
    """(x0s, answers, picked) of every delivered plan the records hold, with
    a mask of the ones sampled for the reference's own sweep."""
    x0, picked, ans = [], [], {k: [] for k in _KEYS}
    for r in outcome.records:
        sol = r["solution"]
        x0.append(r["x0"])
        mask = torch.zeros(r["x0"].shape[0], dtype=torch.bool, device=r["x0"].device)
        mask[r["picked"]] = True
        picked.append(mask)
        for k, name in zip(_KEYS, ("X", "U", "fuel_used", "converged", "defect", "dt")):
            ans[k].append(getattr(sol, name))
    return torch.cat(x0), {k: torch.cat(v) for k, v in ans.items()}, torch.cat(picked)


def _plan_gaps(c: dict, x0, dts, ans: dict, ref: dict):
    """Every plan's gap; ``ref`` holds the reference's sweep of every plan's
    state, or NaN where it was not run (no optimality is judged there)."""
    f64 = torch.float64
    X, U, dt = ans["X"].to(f64), ans["U"].to(f64), ans["dt"].to(f64)
    Xr = scvx3dof.rollout(x0.to(f64), U, dt)
    xT = torch.tensor(c["x_target"], dtype=f64, device=X.device)
    defect_r = (Xr[:, -1, 1:] - xT[1:]).abs().amax(1)
    fuel_r = x0[:, 0].to(f64) - Xr[:, -1, 0]
    judged = ~torch.isnan(ref["fuel"])  # a picked state with a firm landing
    scale = torch.where(judged, ref["fuel"].to(f64).abs(), fuel_r.abs()).clamp_min(1e-3)
    u_min = torch.tensor(c["u_min"], dtype=f64, device=X.device)
    u_max = torch.tensor(c["u_max"], dtype=f64, device=X.device)
    box = torch.maximum(U - u_max, u_min - U).clamp_min(0.0).flatten(1).amax(1) / 5.0
    traj = ((X - Xr).abs() / (1.0 + Xr.abs())).flatten(1).amax(1)
    fuel = (ans["fuel"].to(f64) - fuel_r).abs() / scale
    defect = (ans["defect"].to(f64) - defect_r).abs()
    ref_conv = judged & ref["converged"]
    landing = ref_conv & ~(ans["converged"] & (defect_r < 1.0))
    excess = torch.where(ref_conv, (ans["fuel"].to(f64) - ref["fuel"].to(f64)).clamp_min(0.0)
                         / scale, torch.zeros_like(scale))
    on_grid = (dt[:, None] - dts.to(f64)[None]).abs().amin(1) <= 1e-6
    claim = ans["converged"] & ~(defect_r < 1.0)  # a converged plan lands
    flags = (landing | claim | ~on_grid).to(f64)
    w = CONSISTENCY_WEIGHT
    parts = {"traj": w * traj, "fuel": w * fuel, "defect": w * defect, "box": w * box,
             "excess": excess, "flags": flags}
    if "dt" in ref:
        parts_dt = (~torch.isnan(ref["dt"])) & ((ref["dt"] - dt).abs() > 1e-6)
        diag = {"dt_differs": float(parts_dt.sum())}
    else:
        diag = {}
    return (torch.stack(list(parts.values())).amax(0),
            {**{k: float(v.max()) for k, v in parts.items()}, **diag})


def _library_gaps(outcome) -> torch.Tensor:
    """Each stored row against its plan, and each query's answer."""
    out = []
    f64 = torch.float64
    for r in outcome.records:
        if "library" not in r:
            continue
        lib, sol = r["library"], r["solution"]
        n = sol.X.shape[0]
        times = torch.arange(sol.X.shape[1], device=sol.X.device)[None] * sol.dt[:, None]
        rows = torch.stack([
            ((lib.X[:n] - sol.X).abs() / (1.0 + sol.X.abs())).flatten(1).amax(1),
            ((lib.U[:n] - sol.U).abs() / (1.0 + sol.U.abs())).flatten(1).amax(1),
            (lib.fuel[:n] - sol.fuel_used).abs(),
            (lib.times[:n] - times).abs().amax(1),
            (~lib.active[:n]).float()]).amax(0).to(f64)
        out.append(rows)
        d2 = ((lib.X[:n, 0].to(f64)[None] - r["queries"].to(f64)[:, None]) ** 2).sum(-1)
        best = d2.amin(1)
        out.append((d2.gather(1, r["nearest"][:, None].long())[:, 0] - best) / (1.0 + best))
        # best within the radius by fuel: a state within 1e-5 of the radius's
        # edge may count as inside or not
        pick = r["best"][:, None].long()
        got = lib.fuel[:n].to(f64)[None].expand_as(d2).gather(1, pick)[:, 0]
        d_pick = d2.gather(1, pick)[:, 0]
        wide, tight = d2 <= (r["radius"] * (1 + 1e-5)) ** 2, d2 <= (r["radius"] * (1 - 1e-5)) ** 2
        fuel = lib.fuel[:n].to(f64)[None]
        lo = torch.where(wide, fuel, torch.inf).amin(1)
        hi = torch.where(tight, fuel, torch.inf).amin(1)
        inner = torch.maximum((got - hi).clamp_min(0.0), (lo - got).clamp_min(0.0))
        inner = torch.where(d_pick <= (r["radius"] * (1 + 1e-5)) ** 2, inner, torch.ones_like(inner))
        outer = (d_pick - best) / (1.0 + best)  # none inside: the nearest
        miss = torch.where(wide.any(1), torch.where(tight.any(1), inner, torch.minimum(inner, outer)),
                           outer)
        out.append(torch.nan_to_num(miss, nan=1.0, posinf=1.0))
    return torch.cat(out) if out else torch.zeros(0, dtype=f64)


def _reference(P: Prec, c: dict, x0, picked, dts) -> dict:
    """The reference's sweep of the picked states: the lowest fuel among its
    firmly converged candidates (NaN where none is, and for the states not
    picked), whether it has a firm one, and its chosen duration."""
    got = scvx3dof.free_time(P, c, x0[picked].to(P.dtype), dts.to(P.dtype))
    lanes = got["lanes"]
    firm = lanes["firm"] & lanes["converged"]
    best = torch.where(firm, lanes["fuel"].double(), torch.inf).amin(1)
    n = x0.shape[0]
    fuel = torch.full((n,), float("nan"), dtype=torch.float64, device=x0.device)
    fuel[picked] = torch.where(firm.any(1), best, torch.nan)
    conv = torch.zeros(n, dtype=torch.bool, device=x0.device)
    conv[picked] = firm.any(1)
    dt = torch.full((n,), float("nan"), dtype=torch.float64, device=x0.device)
    dt[picked] = got["dt"].double()
    return {"fuel": fuel, "converged": conv, "dt": dt, "answers": got}


def judge(c: dict, outcome, P: Prec) -> dict:
    x0, ans, picked = _plans(outcome)
    dts = outcome.records[0]["dts"]
    ref = _reference(P, c, x0, picked, dts)
    plans, parts = _plan_gaps(c, x0, dts, ans, ref)
    lib = CONSISTENCY_WEIGHT * _library_gaps(outcome).to(x0.device)
    parts["library"] = float(lib.max()) if lib.numel() else 0.0
    parts["ref_firm"] = float(ref["answers"]["lanes"]["firm"].double().mean())
    per = torch.cat([plans, lib])
    return {"numbers": {NUMBER: float(per.max())}, "per_answer": {NUMBER: per}, "parts": parts}


def control(c: dict, outcome, P: Prec, control_prec: Prec) -> dict:
    """The control: the reference in ``control_prec`` in the program's place,
    its plans for the picked states judged as the program's are."""
    x0, _, picked = _plans(outcome)
    x0 = x0[picked]
    dts = outcome.records[0]["dts"]
    got = scvx3dof.free_time(control_prec, c, x0.to(control_prec.dtype),
                             dts.to(control_prec.dtype))
    ans = {k: got[k] for k in _KEYS}
    ref = _reference(P, c, x0, torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device),
                     dts)
    per, parts = _plan_gaps(c, x0, dts, ans, ref)
    parts["control_converged"] = float(got["converged"].double().mean())
    return {"numbers": {NUMBER: float(per.max())}, "per_answer": {NUMBER: per}, "parts": parts}
