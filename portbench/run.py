"""Run one cell of the port's benchmark once, and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration, traffic and
limits, each read from its own file under portbench/. The run makes its
inputs from the seed, warms up every shape it uses (set-up), then runs the
traffic's driver for ``--seconds``; ``--trace 1`` profiles a fixed stretch of
the window and reports the per-layer metrics instead of the end-to-end ones.
Once the window has closed it checks that no JAX module is loaded, then
judges the sampled answers against the plain reference. The last line of
standard output is the result; the last lines of standard error give each
number compared beside its limit. ``--rehearse`` runs the cell on the CPU at
the traffic's rehearsal sizes, without looking for a card.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gpmpc_tpu")  # top-level module names, compared whole


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> None:
    print(msg, file=sys.stderr)
    sys.exit(code)


def reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, else the
    reader its name extends (``metrics/device_idle_share.py`` for
    ``device_idle_share.scvx``)."""
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = path.with_name(f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, kind: str, workload: str) -> list:
    """The metrics of ``kind`` this cell reports: those that list it, and
    those without a list whose moved metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m["workloads"] or ("workloads" not in m and m["moves"] in names)]


def use_checkout_caches() -> None:
    """Every cache of the program stays inside the checkout, at fixed paths."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def drive(workload: str, seed: int, seconds: float, trace: bool, rehearse: bool, device,
          started: float):
    """A cell's set-up and window: (BENCHMARK.json, the cell, what the
    window gave, the set-up seconds, the memory peak of the program's work)."""
    import torch

    from portbench.core.cell import load_cell

    bench, _, cell = load_cell(workload, seed, seconds, trace, rehearse, device, started)
    if cell.trace:
        cell.tracer.hook_chunk()
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    outcome = driver.run(cell)
    peak = cell.tracer.peak_bytes() if device.type == "cuda" else 0
    return bench, cell, outcome, cell.setup_end - started, peak


def judge(cell, outcome):
    """The numbers compared against the float64 reference, each beside its
    limit: (correct, attempted, failed, compared, the parts' readings)."""
    import torch

    from portbench.reference.prec import F64

    check = importlib.import_module(f"portbench.checks.{cell.config['check']}")
    verdict = check.judge(cell.config, outcome, F64)
    compared, correct, attempted, failed = {}, True, 0, 0
    for name, value in verdict["numbers"].items():
        limit = cell.limits["limits"][name]
        per = verdict["per_answer"][name]
        attempted += int(per.numel())
        failed += int(((per > limit) | ~torch.isfinite(per)).sum())
        correct = correct and math.isfinite(value) and value <= limit
        compared[name] = {"value": value, "limit": limit}
    return correct, attempted, failed, compared, verdict.get("parts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    use_checkout_caches()

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        fail(f"unknown workload {args.workload!r}")
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            fail(f"the cell needs {entry['chips']} CUDA device(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    torch.set_num_threads(min(torch.get_num_threads(), 4))

    bench, cell, outcome, setup_s, peak = drive(args.workload, args.seed, args.seconds,
                                                bool(args.trace), args.rehearse, device,
                                                STARTED)
    found = loaded_forbidden()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {', '.join(found)}", 3)

    metrics = {}
    if not cell.trace:
        for m in cell_metrics(bench, "end_to_end", args.workload):
            value = setup_s if m["name"] == "setup_s" else outcome.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        data = cell.tracer.data
        if data is not None:
            data.host_clock = dict(outcome.e2e)
        for m in cell_metrics(bench, "per_layer", args.workload):
            value = reader(m["name"])(data) if data is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1 if device.type == "cuda" else 0, "memory_peak_bytes": int(peak)}
    result = {"metrics": metrics, "device": dev_info}
    if cell.trace and cell.tracer.data is not None:
        from portbench.core.trace import idle_gaps, top_device_ops

        data = cell.tracer.data
        dev_info.update(busy_s=data.busy_seconds(), window_s=data.window_s)
        result["breakdown"] = {"device_ops": top_device_ops(data), "idle_gaps": idle_gaps(data)}

    correct, attempted, failed, compared, parts = judge(cell, outcome)
    out = {"correct": correct, "attempted": attempted, "failed": failed, **result,
           "units": outcome.units, "setup_s": setup_s, "compared": compared}
    if parts:
        print("parts " + json.dumps(parts), file=sys.stderr)
    for name, v in compared.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
