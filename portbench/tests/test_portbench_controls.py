"""The comparison that decides ``correct`` has to fail: the control (the
plain reference in TF32, in the program's place) and a run whose timed path
is broken underneath, once for each fault the cell can have. The harness's
look for a chip is skipped; the rest of a run is driven on the CPU at the
traffic's rehearsal sizes. The exchange between chips is not among the
faults: every cell runs on one chip."""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
GPMPC = [w for w in CELLS if w.startswith("gpmpc3dof")]
SCVX = [w for w in CELLS if w.startswith("scvx3dof")]

torch.set_num_threads(1)


def _drive(workload, seed=2147484001):
    """A run's driver and check at the rehearsal size: (correct, numbers,
    limits, cell, outcome)."""
    from portbench.core.cell import load_cell
    from portbench.reference.prec import F64

    _, _, cell = load_cell(workload, seed, 0.5, False, True, torch.device("cpu"),
                           time.perf_counter())
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    check = importlib.import_module(f"portbench.checks.{cell.config['check']}")
    outcome = driver.run(cell)
    numbers = check.judge(cell.config, outcome, F64)["numbers"]
    limits = cell.limits["limits"]
    return all(v <= limits[k] for k, v in numbers.items()), numbers, limits, cell, outcome


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    from portbench.reference.prec import F64, TF32

    correct, numbers, limits, cell, outcome = _drive(workload)
    assert correct, numbers
    check = importlib.import_module(f"portbench.checks.{cell.config['check']}")
    ctl = check.control(cell.config, outcome, F64, TF32)["numbers"]
    assert any(v > limits[k] for k, v in ctl.items()), (ctl, limits)


# -- the GP-MPC cells' faults, planted in gp_mpc_solve ------------------------

def _gpmpc_fault(kind):
    from gpmpc_tpu_torch.mpc import gp_mpc as G

    inner = G.gp_mpc_solve

    def broken(step_fn, mean_fn, var_fn, config, state, x0):
        sol, new = inner(step_fn, mean_fn, var_fn, config, state, x0)
        if kind == "state_unchanged":
            return sol, state
        u0 = sol.u0.clone()
        if kind == "half_batch":
            half = u0.shape[0] // 2
            u0[half:] = u0[:half].mean(0)
        elif kind == "answer_altered":
            u0[-1, 0] += 1.0
        return sol._replace(u0=u0), new

    return broken


@pytest.mark.parametrize("workload", GPMPC)
@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_gpmpc_fault_is_caught(monkeypatch, workload, kind):
    from gpmpc_tpu_torch import mpc
    from gpmpc_tpu_torch.mpc import gp_mpc as G

    broken = _gpmpc_fault(kind)
    monkeypatch.setattr(G, "gp_mpc_solve", broken)
    monkeypatch.setattr(mpc, "gp_mpc_solve", broken)
    correct, numbers, limits, _, _ = _drive(workload)
    assert not correct, (kind, numbers, limits)


# -- the SCVX cells' faults, planted in the SCP loop and the sweep --------------

@pytest.mark.parametrize("workload", SCVX)
@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_scvx_fault_is_caught(monkeypatch, workload, kind):
    from gpmpc_tpu_torch import reference as R
    from gpmpc_tpu_torch.reference import scvx as S

    if kind == "state_unchanged":
        inner = S.solve

        def broken_solve(data, x0, y0, config, rho0=None):
            sol = inner(data, x0, y0, config, rho0=rho0)
            # every SCP step hands back its linearization point
            return dataclasses.replace(sol, x=x0)

        monkeypatch.setattr(S, "solve", broken_solve)
    else:
        inner = S.scvx_free_time

        def broken_free_time(step_dt, config, x0, x_target, dts):
            sol = inner(step_dt, config, x0, x_target, dts)
            if kind == "half_batch":
                B = sol.U.shape[0]
                if B == 1:  # one state a query: the half left out is its controls' tail
                    U = sol.U.clone()
                    U[:, U.shape[1] // 2:] = U[:, : U.shape[1] // 2].mean(1, keepdim=True)
                    return sol._replace(U=U)
                keep = torch.arange(B) < (B + 1) // 2
                mean = lambda t: torch.where(keep.reshape(-1, *[1] * (t.dim() - 1)), t,
                                             t[keep].float().mean(0).to(t.dtype))
                return sol._replace(X=mean(sol.X), U=mean(sol.U), fuel_used=mean(sol.fuel_used))
            return sol._replace(fuel_used=sol.fuel_used + 0.01)

        monkeypatch.setattr(S, "scvx_free_time", broken_free_time)
        monkeypatch.setattr(R, "scvx_free_time", broken_free_time)
    correct, numbers, limits, _, _ = _drive(workload)
    assert not correct, (kind, numbers, limits)
