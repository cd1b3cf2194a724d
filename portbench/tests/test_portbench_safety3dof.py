"""The rescue cell's comparison has to fail on each fault its filter can
have, planted in the program's ``filter_control`` under the controller that
flies it: the second SCP iteration skipped, the filter's model without the
downdraft pad, one lane's filtered control altered. The cell is driven on
the CPU at its traffic's rehearsal size, whose lanes start inside the
downdraft. (``test_portbench_controls.py::test_control_fails`` holds the
TF32 control to the same comparison.)"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_portbench_controls import _drive  # noqa: E402

WORKLOAD = "safety3dof-rescue1024"


def _filter_fault(kind):
    import torch

    from gpmpc_tpu_torch.dynamics import Rocket3DoFParams
    from gpmpc_tpu_torch.dynamics import rocket3dof as r3
    from gpmpc_tpu_torch.safety import safety_filter as SF

    inner = SF.filter_control

    def broken(step_fn, backup, invariant, config, x, u_nominal, admm=None):
        if kind == "second_scp_skipped":
            config = config.replace(scp_iterations=1)
        elif kind == "filter_model_unpadded":
            p = Rocket3DoFParams(device=x.device)
            step_fn = lambda xx, uu: r3.step(p, xx, uu, config.dt)  # noqa: E731
        res = inner(step_fn, backup, invariant, config, x, u_nominal, admm)
        if kind == "answer_altered":
            u = res.u.clone()
            u[-1, 1] += 0.5
            res = res._replace(u=u)
        return res

    return broken, torch


@pytest.mark.parametrize("kind", ["second_scp_skipped", "filter_model_unpadded",
                                  "answer_altered"])
def test_safety3dof_fault_is_caught(monkeypatch, kind):
    from gpmpc_tpu_torch.safety import safety_filter as SF

    broken, _ = _filter_fault(kind)
    monkeypatch.setattr(SF, "filter_control", broken)
    correct, numbers, limits, _, _ = _drive(WORKLOAD)
    assert not correct, (kind, numbers, limits)


def test_safety3dof_control_reads_its_precision():
    """The control in the program's place reads nothing where it computes as
    the reference does (float64 throughout)."""
    from portbench.checks import safety_cycle as chk
    from portbench.reference.prec import F64

    _, _, _, cell, outcome = _drive(WORKLOAD)
    same = chk.control(cell.config, outcome, F64, F64)["numbers"]
    assert max(same.values()) <= 1e-12, same
