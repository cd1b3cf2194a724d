"""Device meshes and sharded Monte-Carlo campaigns on ``torch.distributed``
(counterpart of ``gpmpc_tpu/parallel/mesh.py``), one process per device.

- :func:`scenario_mesh` — a 1-D ``DeviceMesh`` named ``("scenarios",)`` over
  the process group's ranks;
- :func:`shard_scenarios`, :func:`replicate` — a tree's tensors as DTensors
  placed ``Shard(0)`` (the leading scenario axis split into contiguous
  blocks, rank order) or ``Replicate()``: the counterparts of
  ``NamedSharding(P("scenarios"))`` and ``P()``. No communication: every
  rank holds the global tensors and keeps its part;
- :func:`run_sharded_campaign` — every rank flies its contiguous block of
  the scenarios through ``experiments.monte_carlo.run_campaign`` (lanes are
  independent, so a lane's result is the one the unsharded campaign gives
  it) and the statistics come from one ``all_reduce``
  (``sharded_campaign_statistics``);
- :func:`gather_safe_sets` — the host-side merge of per-shard safe sets;
- :func:`per_host_keys` — deterministic, distinct generators per host.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .._device import DeviceLike, resolve_device
from ..experiments.monte_carlo import LandingCriteria, SimulationConfig, run_campaign
from ..terminal.safe_set import SafeSet, merge_safe_sets
from ..utils.checkpoint import _flatten
from .distributed import (_mesh_block, _mesh_device_type, _shard, _world,
                          sharded_campaign_statistics)


def scenario_mesh(devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """1-D mesh with a ``"scenarios"`` axis over every rank of the process
    group (or the given ranks), one device each; start the group with
    ``initialize_distributed`` first."""
    ranks = list(devices) if devices is not None else list(range(_world()))
    return DeviceMesh(_mesh_device_type(), torch.tensor(ranks), mesh_dim_names=("scenarios",))


def shard_scenarios(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` with a leading scenario axis as a DTensor
    placed ``Shard(0)`` on ``mesh``; this rank keeps its block."""
    return _shard(mesh, tree, (Shard(0),) * mesh.ndim)


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` as a DTensor placed ``Replicate()``."""
    leaves, rebuild = _flatten(tree)
    return rebuild([DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)
                    for t in leaves])


def run_sharded_campaign(
    mesh: DeviceMesh,
    controller_init: Callable,
    controller_step: Callable,
    plant_step: Callable,
    x0s: torch.Tensor,
    sim: SimulationConfig,
    criteria: Optional[LandingCriteria] = None,
    **campaign_kw,
) -> Dict:
    """The distributed Monte-Carlo entry: every rank is handed the global
    ``x0s`` (B, n_x) and flies its contiguous block of B / mesh-size lanes
    through ``run_campaign`` (``campaign_kw`` goes there). Returns
    ``{"results": this rank's per-lane results, "lanes": their slice of the
    batch, "stats": the statistics of every lane, the same on every rank}``.
    The batch must divide the mesh size (``ValueError``)."""
    block = _mesh_block(mesh, x0s.shape[0])
    res = run_campaign(controller_init, controller_step, plant_step, x0s[block], sim,
                       criteria or LandingCriteria(), **campaign_kw)
    return {"results": res, "lanes": block, "stats": sharded_campaign_statistics(mesh, res)}


def gather_safe_sets(shard_sets: Sequence[SafeSet], capacity: int) -> SafeSet:
    """Merge per-shard safe sets with the deterministic global top-K prune
    (across processes, ``gather_safe_sets_global`` gathers them first)."""
    return merge_safe_sets(list(shard_sets), capacity=capacity)


def per_host_keys(base_key, n_hosts: int, device: DeviceLike = "cuda") -> list:
    """``n_hosts`` generators on ``device``, deterministic in ``base_key``
    (an int seed or a generator, whose initial seed is read) and distinct
    per host: host i's seed is the i-th child of NumPy's ``SeedSequence`` of
    the base (the counterpart of ``jax.random.fold_in``; the draws are the
    port's own)."""
    seed = base_key.initial_seed() if isinstance(base_key, torch.Generator) else int(base_key)
    dev = resolve_device(device)
    children = np.random.SeedSequence(seed).spawn(n_hosts)
    return [torch.Generator(device=dev).manual_seed(int(c.generate_state(1, np.uint64)[0] >> 1))
            for c in children]
