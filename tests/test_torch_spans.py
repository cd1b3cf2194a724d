"""The port's spans and window records on the CPU: the span helper and its
cost-free path, the span names against the benchmark's prefixes, the ADMM
window records against a hand count, the campaign's and the SCVX layer's
spans in a CPU trace, and the benchmark's new readers on the cells'
rehearsal traces."""

import ast
import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpmpc_tpu_torch.utils import profiler as prof_mod
from gpmpc_tpu_torch.utils.profiler import SPAN_PREFIXES, span

torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "gpmpc_tpu_torch"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the per-layer metrics that read the spans and records checked here
NEW_METRICS = ("span_ms.scvx_build", "span_ms.scvx_build.plan", "admm_live_share.scvx",
               "admm_live_share.plan", "host_syncs.cycle", "host_syncs.scvx", "host_syncs.plan",
               "device_ops.rollout_linearize", "span_ms.campaign_self")


def _host_events(p):
    return [(e.name, e.time_range.start, e.time_range.end) for e in p.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def test_span_is_a_named_range_under_the_profiler_and_free_without(monkeypatch):
    made = []

    def counted(name):
        made.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(prof_mod, "record_function", counted)
    assert not prof_mod.profiling()
    with span("scvx.off") as s:
        torch.ones(2) + 1
    assert made == [] and s is None and span("admm.off") is span("campaign.off")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        assert prof_mod.profiling()
        with span("scvx.on"):
            with span("admm.inner"):
                torch.ones(2) + 1
    assert made == ["scvx.on", "admm.inner"]
    ev = {n: (s, e) for n, s, e in _host_events(p) if n in ("scvx.on", "admm.inner")}
    assert ev["scvx.on"][0] <= ev["admm.inner"][0] <= ev["admm.inner"][1] <= ev["scvx.on"][1]
    with span("admm.chunk"):  # off again: no range
        pass
    assert made == ["scvx.on", "admm.inner"]


def _span_literals():
    """(file, call name, first argument) of every ``span``/``record_function``
    call in the package whose first argument is a string."""
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
            arg = node.args[0]
            if name in ("span", "record_function") and isinstance(arg, ast.Constant) \
                    and isinstance(arg.value, str):
                yield path.relative_to(ROOT), name, arg.value


def test_span_names_carry_the_benchmark_prefixes():
    from portbench.core.trace import SPAN_PREFIXES as BENCH_PREFIXES

    assert SPAN_PREFIXES == BENCH_PREFIXES
    found = list(_span_literals())
    names = {n for _, _, n in found}
    assert {"scvx.rollout", "scvx.linearize", "scvx.qp_build", "scvx.solve", "scvx.accept",
            "scvx.select", "scvx.library_query", "campaign.step", "campaign.plant",
            "campaign.outcome", "campaign.exit_check", "admm.exit_check",
            "admm.rho_update", "gpmpc.rollout", "admm.chunk"} <= names
    for where, call, name in found:
        assert call == "span", (where, name)  # one mechanism: the helper
        assert name.startswith(SPAN_PREFIXES), (where, name)
    # a module that calls the helper binds no other ``span``: a local of that
    # name would shadow it in its function
    for path in {ROOT / where for where, _, _ in found}:
        tree = ast.parse(path.read_text())
        bound = [n for n in ast.walk(tree)
                 if isinstance(n, ast.Name) and n.id == "span" and isinstance(n.ctx, ast.Store)
                 or isinstance(n, ast.arg) and n.arg == "span"]
        assert not bound, path


def _qp_batch():
    """Six small strictly convex QPs of different conditioning: their lanes
    converge at different chunk boundaries."""
    from gpmpc_tpu_torch.ops.qp import QPData

    g = torch.Generator().manual_seed(0)
    B, n, m = 6, 5, 8
    M = torch.randn(B, n, n, generator=g)
    w = torch.linspace(1, 50, n)
    P = (M @ M.transpose(1, 2) + 0.1 * torch.eye(n)) * w[:, None] * w[None, :]
    P = P / torch.tensor([1, 3, 10, 30, 100, 300.0])[:, None, None]
    return QPData(P=P, q=torch.randn(B, n, generator=g), A=torch.randn(B, m, n, generator=g),
                  l=-torch.rand(B, m, generator=g) - 0.1, u=torch.rand(B, m, generator=g) + 0.1)


@pytest.mark.parametrize("case", ["chunks", "f32_tail"])
def test_trace_records_count_live_and_launched_lane_iterations(monkeypatch, case):
    from gpmpc_tpu_torch.ops.qp import ADMMConfig, admm, solve

    monkeypatch.setattr(admm, "TRACE_RECORDS", [])
    data = _qp_batch()
    if case == "chunks":
        cfg = ADMMConfig(max_iter=500, check_interval=10, eps_abs=1e-5, eps_rel=1e-5)
    else:  # a budget too short for some lanes: the f32 tail runs on them
        cfg = ADMMConfig(max_iter=80, check_interval=10, eps_abs=1e-2, eps_rel=1e-2,
                         matvec_dtype="bf16", use_pallas="off", tail_f32_iters=20)
    sol = solve(data, config=cfg)
    assert admm.TRACE_RECORDS == []  # nothing without a profiler
    with profile(activities=[ProfilerActivity.CPU]):
        sol = solve(data, config=cfg)
    it = sol.iterations
    assert len(set(it.tolist())) > 1  # lanes stopped at different boundaries
    (rec,) = admm.TRACE_RECORDS
    if case == "chunks":
        # every lane is done at the last boundary, past the ρ-adaptation chunks
        chunks, tail = max(int(it.max()) // 10, cfg.rho_adapt_chunks), 0
        assert int(it.max()) < cfg.max_iter
    else:
        chunks, tail = 8, 20
        assert int(it.min()) < 80 < int(it.max())
    assert (rec["lanes"], rec["chunks"], rec["interval"], rec["tail"]) == (6, chunks, 10, tail)
    live, launched = int(rec["iterations"].sum()), 6 * (chunks * 10 + tail)
    assert live == int(it.sum()) < launched


def test_campaign_step_spans_once_a_step():
    from gpmpc_tpu_torch.experiments import LandingCriteria, SimulationConfig, run_episode

    B, steps = 3, 5
    x0 = torch.tensor([[2.0, 30.0, 0.0, 0.0, -1.0, 0.0, 0.0]]).repeat(B, 1)

    def cstep(cs, x, k):
        with span("gpmpc.rollout"):
            return torch.zeros(B, 3), cs

    plant = lambda x, u: x + torch.tensor([0.0, -0.1, 0, 0, 0, 0, 0])  # noqa: E731
    with profile(activities=[ProfilerActivity.CPU]) as p:
        res = run_episode(lambda x: torch.zeros(B), cstep, plant, x0,
                          SimulationConfig(max_steps=steps), LandingCriteria(),
                          store_trajectories=False)
    assert res["steps"].tolist() == [steps] * B
    ev = _host_events(p)
    count = {n: sum(1 for e in ev if e[0] == n) for n in (
        "campaign.step", "campaign.exit_check", "campaign.plant", "campaign.outcome")}
    assert count == dict.fromkeys(count, steps)
    steps_iv = [e for e in ev if e[0] == "campaign.step"]
    for name in ("campaign.exit_check", "campaign.plant", "campaign.outcome", "gpmpc.rollout"):
        for _, s, e in (x for x in ev if x[0] == name):
            assert any(a <= s and e <= b for _, a, b in steps_iv), name


def test_scvx_spans_nest_the_solver_inside_the_solve():
    from gpmpc_tpu_torch.main_path import scvx_library_path
    from gpmpc_tpu_torch.reference import scvx_free_time

    lp = scvx_library_path("cpu")
    cfg = lp.config.replace(N=6, iterations=2, admm=lp.config.admm.replace(max_iter=50))
    x0 = torch.tensor([[2.0, 12.0, 0.5, -0.5, -2.0, 0.1, 0.0]])
    with profile(activities=[ProfilerActivity.CPU]) as p:
        sol = scvx_free_time(lp.step_dt, cfg, x0, lp.x_target, torch.tensor([0.3, 0.35]))
    assert torch.isfinite(sol.U).all()
    ev = _host_events(p)
    by = {}
    for name, s, e in ev:
        by.setdefault(name, []).append((s, e))
    for name in ("scvx.rollout", "scvx.linearize", "scvx.qp_build", "scvx.accept"):
        assert len(by[name]) >= 2, name
    assert len(by["scvx.solve"]) == 2 and len(by["scvx.select"]) == 1
    admm_spans = [(n, s, e) for n, s, e in ev if n.startswith("admm.")]
    assert {"admm.factor", "admm.chunk", "admm.residuals", "admm.rho_update"} <= {
        n for n, _, _ in admm_spans}
    for name, s, e in admm_spans:
        assert any(a <= s and e <= b for a, b in by["scvx.solve"]), name


@pytest.mark.parametrize("workload", ["scvx3dof-plan11", "gpmpc3dof-mc4096"])
def test_new_readers_on_rehearsal_traces(monkeypatch, workload):
    """The cell at its rehearsal size, traced on the CPU as ``run.py --trace
    1`` traces it: each new span metric of the cell reads a finite value,
    each new device metric nothing (a CPU run has no device trace)."""
    from gpmpc_tpu_torch.ops.qp import admm
    from portbench import run as bench

    monkeypatch.setattr(admm, "TRACE_RECORDS", [])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cell, _, _, _ = bench.drive(workload, 2147483999, 0.1, True, True, torch.device("cpu"),
                                   time.perf_counter())
    data = cell.tracer.data
    mine = [m for m in bench.cell_metrics(spec, "per_layer", workload)
            if m["name"] in NEW_METRICS]
    assert {m["source"] for m in mine} == {"program_span", "device_trace"}
    for m in mine:
        value = bench.reader(m["name"])(data)
        if m["source"] == "device_trace":
            assert value is None, m["name"]
        else:
            assert value is not None and math.isfinite(value) and value > 0, m["name"]


def _structured_gp_cycle(lanes=2):
    """One 6-DoF GP-MPC cycle (Path D's configuration) with a small fitted
    StructuredRocketGP, under the profiler: its host events."""
    from gpmpc_tpu_torch.gp import StructuredGPConfig, StructuredRocketGP
    from gpmpc_tpu_torch.learning import gp_fns
    from gpmpc_tpu_torch.main_path import sixdof_path
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve

    g = torch.Generator().manual_seed(3)
    sp = sixdof_path("cpu")
    x = sp.x_target.repeat(32, 1)
    x[:, 1] = 5.0 + 15.0 * torch.rand(32, generator=g)
    x[:, 4:7] = torch.tensor([-3.0, 0.1, -0.1]) + 0.3 * torch.randn(32, 3, generator=g)
    u = torch.tensor([2.0, 0.0, 0.0]) + 0.1 * torch.randn(32, 3, generator=g)
    gp = StructuredRocketGP.create(StructuredGPConfig(max_data_points=32, n_inducing=8),
                                   device="cpu")
    gp = gp.add_data_batch(x, u, 0.1 * torch.randn(32, 6, generator=g)).fit(g)
    mean_fn, var_fn = gp_fns(gp)
    state = gp_mpc_init(sp.config, x[:lanes], sp.x_target, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        sol, _ = gp_mpc_solve(sp.F, mean_fn, var_fn, sp.config, state, x[:lanes])
    assert torch.isfinite(sol.u0).all()
    return _host_events(p)


def test_structured_gp_spans_once_per_posterior_evaluation():
    """A 6-DoF cycle evaluates the structured GP three times: the residual
    tape (inside gpmpc.rollout), then its mean and its variances (inside
    gpmpc.gp_posterior); each evaluation opens gpmpc.gp_trans and then
    gpmpc.gp_rot once, one after the other."""
    ev = _structured_gp_cycle()
    by = {}
    for name, s, e in ev:
        by.setdefault(name, []).append((s, e))
    trans, rot = sorted(by["gpmpc.gp_trans"]), sorted(by["gpmpc.gp_rot"])
    assert len(trans) == len(rot) == 3
    for (ts, te), (rs, re_) in zip(trans, rot):
        assert te <= rs  # the translational sub-GP, then the rotational one
    inside = lambda iv, name: any(a <= iv[0] and iv[1] <= b for a, b in by[name])
    for iv in trans + rot:
        assert inside(iv, "gpmpc.gp_posterior") or inside(iv, "gpmpc.rollout")
    assert sum(inside(iv, "gpmpc.gp_posterior") for iv in trans) == 2
    assert sum(inside(iv, "gpmpc.gp_posterior") for iv in rot) == 2


def test_3dof_cycle_enters_no_structured_gp_span():
    from gpmpc_tpu_torch.learning import explore_gp_3dof
    from gpmpc_tpu_torch.main_path import main_path
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve

    mp = main_path("cpu")
    g = torch.Generator().manual_seed(0)
    _, mean_fn, var_fn = explore_gp_3dof(g, g, mp.params, mp.F_true, n_points=32,
                                         n_inducing=8, device="cpu")
    x = torch.tensor([[2.0, 20.0, 0.5, -0.5, -3.0, 0.1, 0.0]] * 2)
    state = gp_mpc_init(mp.config, x, mp.x_target, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, x)
    names = {n for n, _, _ in _host_events(p)}
    assert "gpmpc.gp_posterior" in names
    assert not names & {"gpmpc.gp_trans", "gpmpc.gp_rot"}


def test_6dof_cell_readers_on_its_rehearsal_trace(monkeypatch):
    """The 6-DoF cell at its rehearsal size, traced on the CPU as ``run.py
    --trace 1`` traces it: the two readers it adds (``span_ms.gp_rot``,
    ``span_ms.propagate_tighten``) and its other span and host-clock metrics
    read finite values, ``cycle_replay_share`` 0 (its cycles run eagerly),
    its device metrics nothing (a CPU run has no device trace)."""
    from gpmpc_tpu_torch.ops.qp import admm
    from portbench import run as bench

    monkeypatch.setattr(admm, "TRACE_RECORDS", [])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = "gpmpc6dof-rt512"
    # a cycle takes ~0.15 s here alone and several times that beside the
    # suite's other workers: the traced cycles 1-2 need three in the window
    _, cell, outcome, _, _ = bench.drive(workload, 2147483999, 4.0, True, True,
                                         torch.device("cpu"), time.perf_counter())
    assert cell.tracer.traced_units == 2
    data = cell.tracer.data
    data.host_clock = dict(outcome.e2e)  # as run.py hands the host-clock readers
    mine = bench.cell_metrics(spec, "per_layer", workload)
    names = {m["name"] for m in mine}
    assert {"span_ms.gp_rot.sixdof", "span_ms.propagate_tighten.sixdof"} <= names
    for m in mine:
        value = bench.reader(m["name"])(data)
        if m["source"] == "device_trace":
            assert value is None, m["name"]
        elif m["name"] == "cycle_replay_share":
            assert value == 0.0  # eager: CPU tensors here, two chunks and an exit read on the card
        else:
            assert value is not None and math.isfinite(value) and value > 0, m["name"]


# -- the rescue cell: the filter's and the RTI step's enclosing spans ---------------

RESCUE = "safety3dof-rescue1024"
RESCUE_READERS = ("span_ms.safety_filter.rescue", "span_ms.rti_step.rescue",
                  "device_ops.safety_filter.rescue", "admm_live_share.rescue",
                  "span_ms.campaign_self.rescue")


def _rescue_step(lanes=3, device="cpu"):
    """The rescue path's filtered controller and a state in the downdraft:
    (fstep, its carry, x)."""
    from gpmpc_tpu_torch.main_path import filtered_controller, safety_rescue_path

    sp = safety_rescue_path(device)
    finit, fstep = filtered_controller(sp)
    x = torch.tensor([[2.0, 5.0, 0.3, -0.2, -3.0, 0.1, 0.0]], device=device).repeat(lanes, 1)
    x[:, 1] += torch.arange(lanes, dtype=torch.float32, device=device)
    return fstep, finit(x), x


def test_filter_and_rti_step_spans_enclose_their_stages_once_a_cycle():
    fstep, state, x = _rescue_step()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for k in range(2):
            _, state = fstep(state, x, k)
    by = {}
    for name, s, e in _host_events(p):
        by.setdefault(name, []).append((s, e))
    assert len(by["safety.filter"]) == len(by["rti.step"]) == 2
    inside = lambda iv, name: any(a <= iv[0] and iv[1] <= b for a, b in by[name])
    for (rs, re_), (fs, fe) in zip(sorted(by["rti.step"]), sorted(by["safety.filter"])):
        assert re_ <= fs  # the RTI step hands u_nom to the filter
    for name in ("rti.rollout", "rti.linearize", "rti.qp_build", "rti.admm_solve"):
        assert len(by[name]) == 2 and all(inside(iv, "rti.step") for iv in by[name]), name
    for name in ("safety.check", "safety.grad", "safety.qp", "safety.select"):
        assert by[name] and all(inside(iv, "safety.filter") for iv in by[name]), name
    assert not any(inside(iv, "rti.step") for iv in by["safety.filter"])


def test_solve_record_fills_only_inside_its_block():
    """Inside ``solve_record`` one filtered step records one RTI feedback
    and one entry a filter SCP iteration, each holding the step's own
    tensors; outside it, and under a profiler alone, nothing is kept. On a
    card the record is read under ``set_sync_debug_mode`` ("error") after
    the step: its entries are tensors already made, and reading the record
    waits for nothing."""
    from gpmpc_tpu_torch.utils.profiler import open_solve_record, solve_record

    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        fstep, state, x = _rescue_step(device=dev)
        assert open_solve_record() is None
        with profile(activities=[ProfilerActivity.CPU]):
            u_plain, _ = fstep(state, x, 0)
        assert open_solve_record() is None
        with solve_record() as rec:
            assert open_solve_record() is rec
            u, new_state = fstep(state, x, 0)
        assert open_solve_record() is None
        assert torch.equal(u, u_plain)
        (rti,), its = rec["rti"], rec["filter"]
        assert len(its) == 2 and rti["admm"].max_iter == 50 and its[0]["admm"].polish
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for e in its:
                assert e["V"].shape == (3,) and e["dVdu"].shape == (3, 3)
                assert e["x"].shape == (3, 4) and e["ok"].dtype == torch.bool
                assert e["u_lin"].shape == (3, 3)
            assert rti["iterations"].shape == (3,)
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        # the first SCP iteration linearizes at the RTI step's control
        assert torch.equal(its[0]["u_lin"], new_state[0][0].U_lin[:, 0])


def test_3dof_gpmpc_cycle_enters_no_filter_or_rti_step_span():
    from gpmpc_tpu_torch.learning import explore_gp_3dof
    from gpmpc_tpu_torch.main_path import main_path
    from gpmpc_tpu_torch.mpc import gp_mpc_init, gp_mpc_solve

    mp = main_path("cpu")
    g = torch.Generator().manual_seed(0)
    _, mean_fn, var_fn = explore_gp_3dof(g, g, mp.params, mp.F_true, n_points=32,
                                         n_inducing=8, device="cpu")
    x = torch.tensor([[2.0, 20.0, 0.5, -0.5, -3.0, 0.1, 0.0]] * 2)
    state = gp_mpc_init(mp.config, x, mp.x_target, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        gp_mpc_solve(mp.F, mean_fn, var_fn, mp.config, state, x)
    names = {n for n, _, _ in _host_events(p)}
    assert "gpmpc.admm_solve" in names
    assert not names & {"safety.filter", "rti.step"}


def test_rescue_cell_readers_on_its_rehearsal_trace(monkeypatch):
    """The rescue cell at its rehearsal size, traced on the CPU as ``run.py
    --trace 1`` traces it: its span and counter readers read finite values,
    its device readers nothing (a CPU run has no device trace)."""
    from gpmpc_tpu_torch.ops.qp import admm
    from portbench import run as bench

    monkeypatch.setattr(admm, "TRACE_RECORDS", [])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cell, outcome, _, _ = bench.drive(RESCUE, 2147483999, 0.1, True, True,
                                         torch.device("cpu"), time.perf_counter())
    # two traced steps: each an RTI solve and two filter QP solves
    assert cell.tracer.traced_units == 2 and len(admm.TRACE_RECORDS) == 6
    data = cell.tracer.data
    mine = {m["name"]: m for m in bench.cell_metrics(spec, "per_layer", RESCUE)}
    assert set(RESCUE_READERS) <= set(mine)
    for name, m in mine.items():
        value = bench.reader(name)(data)
        if m["source"] == "device_trace":
            assert value is None, name
        else:
            assert value is not None and math.isfinite(value), name
    assert 0.0 < bench.reader("admm_live_share.rescue")(data) <= 100.0


def test_filter_launch_reader_counts_the_launches_inside_its_span():
    """``device_ops.safety_filter`` on a made-up window of two units: the
    launch, copy and memset calls that start inside safety.filter, by unit."""
    from portbench import run as bench
    from portbench.core.trace import TraceData

    host = [("safety.filter", 10.0, 20.0), ("cudaLaunchKernel", 11.0, 12.0),
            ("cudaMemcpyAsync", 13.0, 14.0), ("safety.qp", 14.0, 19.0),
            ("cudaLaunchKernel", 15.0, 16.0), ("cudaLaunchKernel", 21.0, 22.0),
            ("rti.step", 30.0, 40.0), ("cudaLaunchKernel", 31.0, 32.0),
            ("safety.filter", 50.0, 60.0), ("cudaMemsetAsync", 55.0, 56.0),
            ("aten::add", 57.0, 58.0)]
    data = TraceData(window_s=1e-4, units=2, trajectories=0, device_name="cpu",
                     device=[("k", 0.0, 1.0)], host=host, launches=[])
    assert bench.reader("device_ops.safety_filter.rescue")(data) == 4 / 2
