"""Multi-process machinery on ``torch.distributed`` (counterpart of
``gpmpc_tpu/parallel/distributed.py``): one process per device.

- :func:`initialize_distributed` — the process group from arguments or the
  torchrun environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``); NCCL for a CUDA device, gloo for the CPU; a no-op without a
  rendezvous, so every entry point may call it unconditionally.
- :func:`hosts_chips_mesh` — the 2-D ``("hosts", "chips")`` ``DeviceMesh``:
  hosts = world / ``LOCAL_WORLD_SIZE``, each host's ranks contiguous.
- :func:`sharded_campaign_statistics` — campaign statistics as explicit
  collectives: every rank sums its lanes, ONE ``all_reduce`` of the packed
  sums, the derived statistics computed from the global sums on every rank.
- :func:`gather_safe_sets_global` — every rank's fixed-capacity safe set
  all-gathered, then the deterministic merge (``merge_safe_sets``).
- :func:`broadcast_from_host0` — rank 0's tree to every rank.

A collective fails loudly where its backend cannot run it; nothing here
turns a group that was asked for into a single-process run. A gloo group
takes CUDA tensors in every collective used here (all_reduce, broadcast,
all_gather: checked on an H100 with torch 2.11 and CUDA 12.8), so nothing
is staged through host memory; several ranks share one card that way.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from .._device import DeviceLike, resolve_device
from ..experiments.monte_carlo import OUTCOME_NAMES, SUCCESS, wilson_interval
from ..terminal.safe_set import _LEAVES, SafeSet, merge_safe_sets
from ..utils.checkpoint import _flatten

_device: Optional[torch.device] = None  # this process's device, set at initialization


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Start the default process group. The arguments default to the
    torchrun environment: ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``. Returns False, and starts nothing, when no rendezvous is
    configured (a single-process run); else True when the world holds more
    than one process. ``backend`` defaults to NCCL for a CUDA ``device``
    (the rank's card: ``LOCAL_RANK``, else the rank modulo the cards) and
    gloo for the CPU; a gloo group may serve CUDA tensors (several ranks on
    one card, which NCCL refuses). A group that fails to start raises."""
    global _device
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if coordinator_address is None:
        return False
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError(f"a rendezvous at {coordinator_address} needs num_processes and "
                         f"process_id (or WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id,
                            device_id=dev if backend == "nccl" else None)
    _device = dev
    return dist.get_world_size() > 1


def _mesh_device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    return (_device or torch.device("cpu")).type


def hosts_chips_mesh(devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """2-D ``("hosts", "chips")`` mesh over the group's ranks (or the given
    ranks): hosts = ranks / ``LOCAL_WORLD_SIZE``, each host's ranks a
    contiguous row. Without ``LOCAL_WORLD_SIZE``, or where it does not
    divide the ranks, one host. Scenario tensors shard over both axes
    (:func:`scenario_spec`)."""
    ranks = list(devices) if devices is not None else list(range(_world()))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    if per_host <= 0 or len(ranks) % per_host:
        per_host = len(ranks)
    grid = torch.tensor(ranks).reshape(len(ranks) // per_host, per_host)
    return DeviceMesh(_mesh_device_type(), grid, mesh_dim_names=("hosts", "chips"))


def scenario_spec(mesh: DeviceMesh) -> tuple:
    """The placements that shard the leading scenario axis over every mesh
    axis, major axis first (``P(("hosts", "chips"))`` in the JAX package)."""
    return (Shard(0),) * mesh.ndim


def _mesh_block(mesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous block of ``n`` scenarios on ``mesh``."""
    size = mesh.size()
    if n % size:
        raise ValueError(f"batch {n} must divide the mesh size {size}")
    flat = mesh.mesh.flatten().tolist()
    pos = flat.index(dist.get_rank())
    per = n // size
    return slice(pos * per, (pos + 1) * per)


def shard_over_mesh(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` (the global tensor, on every rank) as a
    DTensor sharded by :func:`scenario_spec`: this rank keeps its block,
    nothing is communicated."""
    return _shard(mesh, tree, scenario_spec(mesh))


def _shard(mesh, tree, placements):
    leaves, rebuild = _flatten(tree)
    return rebuild([DTensor.from_local(t[_mesh_block(mesh, t.shape[0])], mesh, placements,
                                       run_check=False) for t in leaves])


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def sharded_campaign_statistics(mesh: DeviceMesh, results: Dict) -> Dict:
    """``campaign_statistics`` over every rank's lanes by explicit
    collectives: each rank sums its lanes (count, successes, fuel, fuel²,
    touchdown speed and error and steps over the successful ones, and one
    count per outcome code) in float64, ONE ``all_reduce`` over the mesh's
    ranks adds them, and the success rate, its Wilson interval and the
    success-only moments follow from the global sums on every rank.
    ``results`` holds this rank's lanes (tensors or DTensors)."""
    outcome = _local(results["outcome"])
    ok = (outcome == SUCCESS).double()
    vals = [_local(results[k]).double() for k in ("fuel_used", "landing_speed",
                                                  "landing_error", "steps")]
    fuel = vals[0]
    sums = torch.stack([ok.new_tensor(float(outcome.shape[0])), ok.sum(),
                        (fuel * ok).sum(), (fuel * fuel * ok).sum()]
                       + [(v * ok).sum() for v in vals[1:]]
                       + [(outcome == code).double().sum() for code in OUTCOME_NAMES])
    _all_reduce(sums, mesh)
    n, succ, s_fuel, s_fuel2, s_speed, s_err, s_steps = sums[:7]
    counts = sums[7:]
    denom = succ.clamp_min(1.0)
    fuel_mean = s_fuel / denom
    fuel_var = (s_fuel2 / denom - fuel_mean ** 2).clamp_min(0.0)
    lo, hi = wilson_interval(succ.float(), n.float())
    f32 = lambda v: v.to(torch.float32)
    return {
        "n_runs": int(n),
        "success_rate": f32(succ / n),
        "success_ci": (lo, hi),
        "outcome_counts": {name: counts[i].to(torch.int64)
                           for i, name in enumerate(OUTCOME_NAMES.values())},
        "fuel_used_mean": f32(fuel_mean),
        "fuel_used_std": f32(fuel_var.sqrt()),
        "landing_speed_mean": f32(s_speed / denom),
        "landing_error_mean": f32(s_err / denom),
        "steps_mean": f32(s_steps / denom),
    }


def _group(mesh: Optional[DeviceMesh]):
    """The process group of the mesh's ranks (the world for None)."""
    if mesh is None or mesh.size() == _world():
        return None
    if mesh.ndim == 1:
        return mesh.get_group()
    raise ValueError("a collective over a multi-axis mesh needs the mesh to hold every rank")


def _all_reduce(t: torch.Tensor, mesh: Optional[DeviceMesh] = None) -> None:
    if _world() > 1:
        dist.all_reduce(t, group=_group(mesh))


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor every backend carries (bool as uint8), at least 1-d."""
    t = t.reshape(1) if t.dim() == 0 else t
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


def _all_gather(t: torch.Tensor) -> list:
    """Every rank's copy of the same-shaped ``t``, in rank order, on ``t``'s
    device and dtype."""
    w = _wire(t)
    outs = [torch.empty_like(w) for _ in range(_world())]
    dist.all_gather(outs, w)
    return [o.to(t.dtype).reshape(t.shape) for o in outs]


def gather_safe_sets_global(local_set: SafeSet, capacity: Optional[int] = None) -> SafeSet:
    """Every rank's safe set (the same capacity everywhere) all-gathered and
    merged by the deterministic global top-K prune; the merge on every rank.
    One process: the identity merge."""
    capacity = capacity or local_set.capacity
    if _world() <= 1:
        return merge_safe_sets([local_set], capacity=capacity)
    per_rank = [dict() for _ in range(_world())]
    for name in _LEAVES:
        v = getattr(local_set, name)
        if isinstance(v, torch.Tensor):
            for r, g in enumerate(_all_gather(v)):
                per_rank[r][name] = g
    return merge_safe_sets([local_set.replace(**kw) for kw in per_rank], capacity=capacity)


def broadcast_from_host0(tree):
    """Rank 0's tree on every rank (every rank passes a tree of the same
    structure and shapes); the tensors keep each rank's devices. One
    process: the identity."""
    if _world() <= 1:
        return tree
    leaves, rebuild = _flatten(tree)
    out = []
    for t in leaves:
        t = torch.as_tensor(t)
        w = _wire(t).clone()
        dist.broadcast(w, src=0)
        out.append(w.to(t.dtype).reshape(t.shape))
    return rebuild(out)
