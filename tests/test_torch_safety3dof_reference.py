"""The rescue campaign's program (``main_path.safety_rescue_path`` behind
``filtered_controller``) against the benchmark's plain float64 reference
(``portbench/reference/safety3dof.py``) on eight lanes in the downdraft,
at least half of them outside the funnel: the padded step, the funnel and
the braking backup, V(x_N) and ∂V/∂u, and one whole filtered cycle (RTI
step, filter, plant) judged by the cell's own check.

Each tolerance is set above float32's rounding of the computation it
judges and is shown to reject a reference that is wrong in the way it
guards against: the reference without the gust pad in the filter's model,
with one SCP iteration, or with its matrix products rounded to TF32. The
step, the funnel, the backup and V with its gradient have no matrix
product, so TF32 rounds nothing there; they are guarded against the pad.
"""

import sys
import time
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.checks import safety_cycle as chk  # noqa: E402
from portbench.core.cell import Outcome, read_json  # noqa: E402
from portbench.reference import safety3dof as ref3  # noqa: E402
from portbench.reference.prec import F64, TF32  # noqa: E402

CONFIG = read_json(ROOT / "portbench" / "configs" / "safety3dof.json")
# the reference without the gust on its filter's model, and with one SCP
# iteration: each a departure the comparisons must catch
UNPADDED = dict(CONFIG, gust=dict(CONFIG["gust"], on=["plant"]))
ONE_SCP = dict(CONFIG, filter=dict(CONFIG["filter"], scp_iterations=1))
LIMITS = read_json(ROOT / "portbench" / "limits" / "safety3dof-rescue1024.json")["limits"]

# one RK4 step in float32 of states of size ~10: rounding ~1e-7 of each term
STEP_TOL = 2e-6
# V(x_N) after five float32 steps and |v|² of speeds ~3: ~1e-6 of 1 + |V|;
# its gradient by float32 autograd through the same steps
V_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def rescue():
    from gpmpc_tpu_torch.main_path import safety_rescue_path

    return safety_rescue_path("cpu")


def _lanes():
    """Eight lanes at 3-9 m falling at 1.5-3.6 m/s, one at rest in the air."""
    g = torch.Generator().manual_seed(21)
    x = torch.zeros(8, 7)
    x[:, 0] = 1.9 + 0.1 * torch.rand(8, generator=g)
    x[:, 1] = torch.linspace(3.0, 9.0, 8)
    x[:, 2:4] = 0.5 * torch.randn(8, 2, generator=g)
    x[:, 4] = -torch.linspace(3.6, 1.5, 8)
    x[:, 5:7] = 0.2 * torch.randn(8, 2, generator=g)
    x[7, 4:7] = 0.0
    u = torch.tensor([2.0, 0.0, 0.0]) + 0.3 * torch.randn(8, 3, generator=g)
    return x, u


def _rel(a, b):
    return float(((a.double() - b).abs() / (1.0 + b.abs())).max())


def test_lanes_are_mostly_unsafe(rescue):
    x, u = _lanes()
    V, _ = ref3.value_and_grad(CONFIG, x.double(), u.double())
    assert int((V > ref3.alpha(CONFIG)).sum()) >= 4


def test_padded_step_matches(rescue):
    x, u = _lanes()
    x64, u64 = x.double(), u.double()
    assert _rel(rescue.plant(x, u), ref3.plant_step(CONFIG, x64, u64)) <= STEP_TOL
    assert _rel(rescue.F_filter(x, u), ref3.filter_step(CONFIG, x64, u64)) <= STEP_TOL
    # the downdraft at these altitudes moves the step well beyond the tolerance
    assert _rel(rescue.F_filter(x, u), ref3.filter_step(UNPADDED, x64, u64)) > 10 * STEP_TOL


def test_funnel_and_braking_match(rescue):
    x, _ = _lanes()
    x64 = x.double()
    assert _rel(rescue.invariant.value(x)[:, None], ref3.funnel(CONFIG, x64)[:, None]) <= STEP_TOL
    assert rescue.invariant.alpha == ref3.alpha(CONFIG)
    ub = rescue.backup.control(x)
    assert _rel(ub, ref3.braking(CONFIG, x64)) <= STEP_TOL
    assert torch.equal(ub[7, 1:], torch.zeros(2))  # at rest: straight up


def test_value_and_gradient_match(rescue):
    from gpmpc_tpu_torch.safety.safety_filter import _value_and_grad

    x, u = _lanes()
    V, g = _value_and_grad(rescue.F_filter, rescue.backup, rescue.invariant,
                           CONFIG["filter"]["N"], x, u)
    Vr, gr = ref3.value_and_grad(CONFIG, x.double(), u.double())
    assert _rel(V[:, None], Vr[:, None]) <= V_TOL
    assert _rel(g, gr) <= GRAD_TOL
    V0, g0 = ref3.value_and_grad(UNPADDED, x.double(), u.double())
    assert _rel(V[:, None], V0[:, None]) > 100 * V_TOL and _rel(g, g0) > 10 * GRAD_TOL


@pytest.fixture(scope="module")
def cycle(rescue):
    """One filtered cycle of the eight lanes from the campaign's start, its
    solves recorded as the cell's driver records them."""
    from gpmpc_tpu_torch.main_path import filtered_controller
    from gpmpc_tpu_torch.utils.profiler import solve_record

    x, _ = _lanes()
    finit, fstep = filtered_controller(rescue)
    state = finit(x)
    with solve_record() as solves:
        u, new_state = fstep(state, x, 0)
    rec = {"cycle": 0, "lanes": torch.arange(8), "state": state, "x": x, "u": u,
           "new_state": new_state, "rti": solves["rti"], "filter": solves["filter"],
           "x_next": rescue.plant(x, u)}
    return Outcome(e2e={}, units=1, records=[rec], inputs={"x_start": x})


def test_filtered_cycle_matches(cycle):
    """The whole cycle within the cell's limits, its float32 rounding well
    inside them; at least half the lanes unsafe, and some of them solved."""
    t0 = time.perf_counter()
    v = chk.judge(CONFIG, cycle, F64)
    assert time.perf_counter() - t0 < 30
    for name, value in v["numbers"].items():
        assert value <= LIMITS[name] / 4, (name, value)
    parts = v["parts"]
    assert parts["unsafe"] >= 4 and parts["hits"] == parts["unsafe"]
    assert parts["qp_not_solved"][-1] < parts["unsafe"], parts


@pytest.mark.parametrize("wrong", ["tf32", "one_scp_iteration", "unpadded_filter_model"])
def test_wrong_reference_fails_the_cycle(cycle, wrong):
    """The wrong reference's answers in the program's place, judged by the
    cell's check against the configuration's reference."""
    prec = TF32 if wrong == "tf32" else F64
    config = {"tf32": CONFIG, "one_scp_iteration": ONE_SCP,
              "unpadded_filter_model": UNPADDED}[wrong]
    answers = [chk.reference_answers(config, r, cycle.inputs["x_start"], prec)
               for r in cycle.records]
    per, _, _ = chk.gaps(CONFIG, cycle, answers, F64)
    numbers = {name: float(v.max()) for name, v in per.items()}
    assert any(value > LIMITS[name] for name, value in numbers.items()), numbers


def test_a_diverged_lane_fails_the_cycle(cycle):
    """A lane the program flew to a non-finite state is judged, not skipped:
    every number it enters reads infinite."""
    rec = dict(cycle.records[0])
    x = rec["x"].clone()
    x[3] = float("nan")
    rec["x"] = x
    bad = Outcome(e2e={}, units=1, records=[rec], inputs=cycle.inputs)
    numbers = chk.judge(CONFIG, bad, F64)["numbers"]
    assert numbers["answer_gap"] == numbers["filter_gap"] == float("inf"), numbers
    assert numbers["duals_gap"] == float("inf")  # lane 3 is a sampled RTI lane
