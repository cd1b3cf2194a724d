"""The benchmark's harness on the CPU: each cell's command at its rehearsal
size, the imports it may not make, and the roofline's count."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)

# runs a cell's command in this process and reports the modules it loaded
_PROBE = """
import json, runpy, sys
sys.argv = ["portbench/run.py"] + sys.argv[1:]
try:
    runpy.run_path("portbench/run.py", run_name="__main__")
except SystemExit as e:
    code = e.code
else:
    code = 0
print("MODULES " + json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
print("EXIT " + str(code))
"""


def _run_cell(tmp, workload, *extra):
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, "--workload", workload, "--seed", "2147483999",
         "--seconds", "0.5", "--rehearse", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp), "TMPDIR": str(tmp),
             "OMP_NUM_THREADS": "1"})
    lines = proc.stdout.strip().splitlines()
    assert lines and lines[-1] == "EXIT 0", proc.stdout[-2000:] + proc.stderr[-4000:]
    modules = set(json.loads(lines[-2][len("MODULES "):]))
    return json.loads(lines[-3]), modules, proc.stderr


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_command_runs_correct_without_jax(tmp_path, workload, trace):
    result, modules, stderr = _run_cell(tmp_path, workload, "--trace", trace)
    assert result["correct"] is True, stderr[-3000:]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert not modules & {"jax", "jaxlib", "flax", "gpmpc_tpu"}
    assert "gpmpc_tpu_torch" in modules
    names = list(result["compared"])
    assert stderr.strip().splitlines()[-len(names):] == [
        f"{n} {result['compared'][n]['value']!r} limit {result['compared'][n]['limit']!r}"
        for n in names]
    assert list(result)[-1] == "compared"
    if trace == "0":
        want = {m["name"] for m in BENCH["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(result["metrics"]) == want
        assert all(v["value"] > 0 for v in result["metrics"].values())
    else:
        # a CPU run has no device trace: no device metric may appear
        device = {m["name"] for m in BENCH["per_layer"] if m["source"] == "device_trace"}
        assert not set(result["metrics"]) & device


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "portbench" / "reference").glob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"gpmpc_tpu_torch", "gpmpc_tpu", "jax", "jaxlib", "flax"}, path


def test_no_benchmark_file_imports_jax():
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"gpmpc_tpu", "jax", "jaxlib", "flax"}, path


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    metrics = ROOT / "portbench" / "metrics"
    for m in BENCH["per_layer"]:
        name = m["name"]
        assert ((metrics / f"{name}.py").is_file()
                or (metrics / f"{name.rsplit('.', 1)[0]}.py").is_file()), name


def test_roofline_counts_the_same_qp_alike_declared_or_dense(monkeypatch):
    """One SCVX QP solved with its rows declared ("blt" + "diag") and with
    every row dense: the chunk launches record the same work."""
    from gpmpc_tpu_torch.main_path import scvx_library_path
    from gpmpc_tpu_torch.mpc.rti import _sparse_admm_cfg
    from gpmpc_tpu_torch.ops.kernels import admm_chunk as K
    from gpmpc_tpu_torch.ops.qp import join_z, solve
    from gpmpc_tpu_torch.reference.scvx import scvx_qp

    from portbench.core.roofline import least_seconds, work
    from portbench.core.trace import Tracer

    monkeypatch.setattr(K, "admm_chunk", K.admm_chunk)
    lp = scvx_library_path("cpu")
    cfg = lp.config.replace(N=6, admm=lp.config.admm.replace(max_iter=50))
    x0 = torch.tensor([[2.0, 12.0, 0.5, -0.5, -2.0, 0.1, 0.0]] * 2)
    U = torch.zeros(2, 6, 3)
    U[:, :, 0] = 2.0
    data, X_lin = scvx_qp(lp.step_dt, cfg, x0, lp.x_target, torch.tensor([0.3, 0.35]), U)
    tracer = Tracer(enabled=False, device=torch.device("cpu"))
    tracer.hook_chunk()
    tracer.active = True
    records = {}
    for name, acfg in (("declared", _sparse_admm_cfg(cfg)),
                       ("dense", cfg.admm.replace(row_structure=(("dense", data.m),)))):
        solve(data, join_z(X_lin, U), None, acfg.replace(use_pallas="on"))
        records[name] = tracer.launch_records()
    assert records["declared"] and records["declared"] == records["dense"]
    nnz = int(torch.count_nonzero(data.A))
    assert records["declared"][0]["nnz"] == nnz < data.A.numel()
    b, ops = work(2, data.n, data.m, nnz, 25)
    assert b == 4 * (2 * data.n ** 2 + nnz + 2 * (2 * data.n + 5 * data.m)
                     + 2 * (data.n + 2 * data.m))
    assert ops == 25 * (4 * data.n ** 2 + 4 * nnz + 2 * (11 * data.m + 5 * data.n))
    t, bound = least_seconds("NVIDIA H100 80GB HBM3", 2, data.n, data.m, nnz, 25)
    assert t > 0 and bound in ("bytes", "operations")
    assert least_seconds("cpu", 2, data.n, data.m, nnz, 25) is None
