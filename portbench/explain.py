"""Where a cell's traced window goes, beyond what its result line reports.

    python3 portbench/explain.py --workload <cell> --seed <n> [--seconds 30]
        [--out chiprun_out/explain_<cell>.json] [--rehearse]

Runs the cell as ``run.py --trace 1`` does (same set-up, driver and window)
and writes, for the traced window: the host-to-device waits and the device
ops issued, each by the innermost program span it started in (the waits
also by the innermost ``aten::`` op); the device
ops the trace shows against the launch calls it shows; the spans' self
time; the chunk wrapper's host microseconds a launch (``admm.chunk`` host
time over the window's chunk launches); the ADMM lane-iterations' live
share; the idle gaps by label with the share of those outside every span;
and the window's rate beside the whole run's. The judgment of the answers
is left to ``run.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _per_unit(counts: dict, units: int) -> dict:
    return {str(k): v / units for k, v in sorted(counts.items(), key=lambda kv: -kv[1])}


def explain(data, cell, outcome) -> dict:
    from portbench.core.spans import by_innermost, is_launch, self_seconds, sync_calls
    from portbench.core.trace import idle_gaps

    units = data.units
    launches = [iv for iv in data.host if is_launch(iv[0])]
    syncs = sync_calls(data)
    aten = sorted((iv for iv in data.host if iv[0].startswith("aten::")),
                  key=lambda iv: (iv[1], -iv[2]))
    names: dict = {}
    for name, _, _ in launches + syncs:
        names[name] = names.get(name, 0) + 1
    gaps = idle_gaps(data, k=10 ** 6)
    gap_s = sum(v for _, v in gaps)
    no_span = sum(v for n, v in gaps if n.startswith("no span"))
    top = gaps[:10]
    lanes = cell.traffic.get("lanes", 1)
    per_s = (data.trajectories if data.trajectories else lanes * units) / data.window_s
    out = {
        "units": units, "window_s": data.window_s, "busy_s": data.busy_seconds(),
        "window_rate_per_s": per_s, "run_rate": outcome.e2e,
        "device_ops_per_unit": len(data.device) / units,
        "launch_calls_per_unit": len(launches) / units,
        "runtime_calls": names,
        "launches_by_span_per_unit": _per_unit(by_innermost(data, launches), units),
        "syncs_per_unit": len(syncs) / units,
        "syncs_by_span_per_unit": _per_unit(by_innermost(data, syncs), units),
        "syncs_by_op_per_unit": _per_unit(by_innermost(data, syncs, aten), units),
        "self_ms_per_unit": {k: 1e3 * v / units for k, v in sorted(
            self_seconds(data, lambda n: True).items(), key=lambda kv: -kv[1])},
        "idle_gap_s": gap_s,
        "idle_gap_no_span_share": no_span / gap_s if gap_s else None,
        "idle_gap_top10_no_span_share": (sum(v for n, v in top if n.startswith("no span"))
                                         / sum(v for _, v in top)) if top else None,
        "idle_gaps": gaps[:25],
    }
    if data.launches:
        out["chunk_launches_per_unit"] = len(data.launches) / units
        out["chunk_wrapper_host_us_per_launch"] = (
            1e6 * data.span_seconds("admm.chunk") / len(data.launches))
    from gpmpc_tpu_torch.ops.qp import admm

    recs = getattr(admm, "TRACE_RECORDS", [])
    if recs:
        launched = sum(r["lanes"] * (r["chunks"] * r["interval"] + r["tail"]) for r in recs)
        out["admm_solves"] = len(recs)
        out["admm_chunks_per_solve"] = sorted({r["chunks"] for r in recs})
        out["admm_live_share"] = 100.0 * sum(int(r["iterations"].sum()) for r in recs) / launched
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)

    from portbench import run as bench

    bench.use_checkout_caches()
    import torch

    device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    _, cell, outcome, setup_s, _ = bench.drive(args.workload, args.seed, args.seconds, True,
                                               args.rehearse, device, STARTED)
    res = {"workload": args.workload, "seed": args.seed, "card": _card(device),
           "setup_s": setup_s, **explain(cell.tracer.data, cell, outcome)}
    out = Path(args.out or ROOT / "chiprun_out" / f"explain_{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    short = {k: v for k, v in res.items() if k not in ("idle_gaps", "self_ms_per_unit")}
    print(json.dumps(short))
    return 0


if __name__ == "__main__":
    sys.exit(main())
