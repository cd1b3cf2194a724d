"""Controls for the trace readers, and the cost of a span.

    python3 portbench/sync_control.py [--reads 7] [--copies 5] [--launches 10]

On a card: a traced window (the harness's ``Tracer``) of one unit that makes
a known number of host reads (``.item()``), copies to the host (``.cpu()``)
and one ``torch.cuda.synchronize()``, besides launches that wait for
nothing, must read exactly that many waits through ``host_syncs``; and
``--launches`` in-place kernels inside a ``gpmpc.rollout`` span must read
exactly that many through ``device_ops.rollout_linearize``. Everywhere: the
host microseconds of one ``span`` and one ``record_function`` with no
profiler running. Prints one JSON line; exits 1 if a control reads wrong.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def span_cost_us(n: int = 200_000) -> dict:
    """Host µs a ``with`` block costs, profiler off: the program's span and a
    bare ``record_function``."""
    from torch.profiler import record_function

    from gpmpc_tpu_torch.utils.profiler import span

    def timed(make):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n // 5):
                with make("admm.chunk"):
                    pass
            best = min(best, (time.perf_counter() - t0) / (n // 5))
        return 1e6 * best

    return {"span": timed(span), "record_function": timed(record_function)}


def control(reads: int, copies: int, launches: int) -> dict:
    import torch

    from gpmpc_tpu_torch.utils.profiler import span
    from portbench.core.trace import Tracer
    from portbench.run import reader

    dev = torch.device("cuda", 0)
    x = torch.randn(4096, device=dev)
    pinned = torch.empty(4096, pin_memory=True)
    for _ in range(2):  # warm every op the window makes
        (x * 2).sum().item()
        (x + 1).cpu()
        x.add_(0.0)
        pinned.copy_(x, non_blocking=True)
    torch.cuda.synchronize()

    tracer = Tracer(enabled=True, units=1, device=dev)
    tracer.before_unit()
    for i in range(reads):
        (x * i).sum().item()
    for i in range(copies):
        (x + i).cpu()
    torch.cuda.synchronize()
    for _ in range(20):  # launches and an asynchronous copy: no wait
        y = x * 3
    pinned.copy_(y, non_blocking=True)
    with span("gpmpc.rollout"):
        for _ in range(launches):
            x.add_(1e-3)
    tracer.after_unit()
    data = tracer.data
    syncs = reader("host_syncs.cycle")(data)
    ops = reader("device_ops.rollout_linearize")(data)
    names: dict = {}
    for name, _, _ in data.host:
        if name.startswith("cu"):  # the runtime's and the driver's calls
            names[name] = names.get(name, 0) + 1
    want_syncs = reads + copies + 1
    return {"host_syncs": syncs, "host_syncs_expected": want_syncs,
            "device_ops_in_span": ops, "device_ops_in_span_expected": launches,
            "ok": syncs == want_syncs and ops == launches, "runtime_calls": names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=7)
    ap.add_argument("--copies", type=int, default=5)
    ap.add_argument("--launches", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    out = {"span_cost_us": span_cost_us()}
    if torch.cuda.is_available():
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        out["control"] = control(args.reads, args.copies, args.launches)
    print(json.dumps(out))
    return 0 if out.get("control", {"ok": True})["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
