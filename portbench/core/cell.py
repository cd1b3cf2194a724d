"""A cell's run: the workload's entry of BENCHMARK.json, its configuration,
traffic and limits, each read from its own file by name, and what a driver
hands back."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from .trace import Tracer

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def dotted(cfg: dict, overrides: dict) -> dict:
    """``cfg`` with ``{"a.b": v}`` overrides applied."""
    out = json.loads(json.dumps(cfg))
    for key, v in overrides.items():
        d = out
        *head, last = key.split(".")
        for h in head:
            d = d[h]
        d[last] = v
    return out


@dataclass
class Cell:
    workload: str
    seed: int
    seconds: float
    trace: bool
    rehearse: bool
    device: torch.device
    config: dict
    traffic: dict
    limits: dict
    tracer: Tracer
    started: float  # perf_counter at process start
    setup_end: Optional[float] = None

    def mark_setup_end(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_end = time.perf_counter()


@dataclass
class Outcome:
    """What a driver's window gave: end-to-end values by metric name, the
    units of work done, and the sampled answers the check compares."""

    e2e: Dict[str, float]
    units: int
    records: List[Dict[str, Any]] = field(default_factory=list)
    inputs: Dict[str, Any] = field(default_factory=dict)


def load_cell(workload: str, seed: int, seconds: float, trace: bool, rehearse: bool,
              device: torch.device, started: float):
    bench = read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    config = read_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    traffic = read_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(BENCH_DIR / "limits" / f"{workload}.json")
    if rehearse:
        reh = traffic.get("rehearse", {})
        config = dotted(config, reh.get("config", {}))
        traffic = _merge(traffic, {k: v for k, v in reh.items() if k != "config"})
    tr = traffic.get("trace", {})
    tracer = Tracer(enabled=trace, skip=tr.get("skip", 0), units=tr.get("units", 1),
                    device=device)
    cell = Cell(workload=workload, seed=seed, seconds=seconds, trace=trace, rehearse=rehearse,
                device=device, config=config, traffic=traffic, limits=limits, tracer=tracer,
                started=started)
    return bench, entry, cell
