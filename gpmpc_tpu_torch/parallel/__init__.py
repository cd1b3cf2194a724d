"""Lane-axis sharding on ``torch.distributed`` (counterpart of
``gpmpc_tpu/parallel``): process groups and device meshes, sharded
campaigns, explicit collectives, one process per device."""

from .distributed import (
    broadcast_from_host0,
    gather_safe_sets_global,
    hosts_chips_mesh,
    initialize_distributed,
    scenario_spec,
    shard_over_mesh,
    sharded_campaign_statistics,
)
from .mesh import (
    gather_safe_sets,
    per_host_keys,
    replicate,
    run_sharded_campaign,
    scenario_mesh,
    shard_scenarios,
)

__all__ = [
    "broadcast_from_host0",
    "gather_safe_sets",
    "gather_safe_sets_global",
    "hosts_chips_mesh",
    "initialize_distributed",
    "per_host_keys",
    "replicate",
    "run_sharded_campaign",
    "scenario_mesh",
    "scenario_spec",
    "shard_over_mesh",
    "shard_scenarios",
    "sharded_campaign_statistics",
]
