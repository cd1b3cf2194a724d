"""The 6-DoF GP-MPC cell's comparison has to fail on each fault the GP-MPC
cells can have, planted in ``gp_mpc_solve`` as ``test_portbench_controls.py``
plants them for the 3-DoF cells: the carry left unchanged, half the batch's
answers replaced by the other half's mean, one lane's answer altered. The
cell is driven on the CPU at its traffic's rehearsal size."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_portbench_controls import _drive, _gpmpc_fault  # noqa: E402

WORKLOAD = "gpmpc6dof-rt512"


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_gpmpc6dof_fault_is_caught(monkeypatch, kind):
    from gpmpc_tpu_torch import mpc
    from gpmpc_tpu_torch.mpc import gp_mpc as G

    broken = _gpmpc_fault(kind)
    monkeypatch.setattr(G, "gp_mpc_solve", broken)
    monkeypatch.setattr(mpc, "gp_mpc_solve", broken)
    correct, numbers, limits, _, _ = _drive(WORKLOAD)
    assert not correct, (kind, numbers, limits)


def test_gpmpc6dof_controls_read_their_precision():
    """The control in the program's place reads nothing where it computes as
    the reference does (float64 throughout), and the rounding of its GP
    alone where only the GP is float32 (the GP-only control)."""
    from portbench.checks import gpmpc6dof_cycle as chk
    from portbench.reference.prec import F32, F64

    _, _, _, cell, outcome = _drive(WORKLOAD)
    same = chk.control(cell.config, outcome, F64, F64)["numbers"]
    gp32 = chk.control(cell.config, outcome, F64, F64, gp_prec=F32)["numbers"]
    assert max(same.values()) <= 1e-12, same
    assert 0.0 < gp32["sigma_gap"] and max(gp32.values()) < 1.0, gp32
